"""Cost model for client-side predicate evaluation (paper §V-D).

Expected cost (microseconds) of evaluating one pattern on one JSON object:

    T = sel(p) * (k1*len(p) + k2*len(t))
      + (1 - sel(p)) * (k3*len(p) + k4*len(t)) + c

where ``len(p)`` is pattern length, ``len(t)`` the average record length and
``sel(p)`` the match selectivity.  k1..k4, c are hardware-dependent and fitted
by multivariate linear regression from timed probes (paper §VII-F reports
R^2 = 0.897 / 0.666 / 0.978 across three platforms).

A :class:`CostModel` prices a *clause* as the sum of its disjuncts' pattern
costs (paper: "For a disjunction of predicates ... its cost is the summation
of the cost of evaluating each simple predicate").
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .predicates import Clause, SimplePredicate


@dataclass
class CostModel:
    """5-coefficient linear substring-search cost model (µs / record)."""

    k1: float = 0.004   # found: per pattern byte
    k2: float = 0.0015  # found: per record byte
    k3: float = 0.002   # not found: per pattern byte
    k4: float = 0.001   # not found: per record byte
    c: float = 0.05     # per-search startup
    avg_record_len: float = 256.0

    def pattern_cost(self, pattern_len: int, sel: float) -> float:
        return self.sel_len_cost(sel, pattern_len, self.avg_record_len)

    def sel_len_cost(self, sel: float, pattern_len: int, record_len: float) -> float:
        lp = float(pattern_len)
        return (
            sel * (self.k1 * lp + self.k2 * record_len)
            + (1.0 - sel) * (self.k3 * lp + self.k4 * record_len)
            + self.c
        )

    def simple_cost(self, pred: SimplePredicate, sel: float) -> float:
        return sum(self.pattern_cost(len(p), sel) for p in pred.patterns())

    def clause_cost(self, cl: Clause, sel: float) -> float:
        # Disjunction cost = sum of disjunct costs (worst case: all evaluated).
        return sum(self.simple_cost(t, sel) for t in cl.terms)

    def coefficients(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.k3, self.k4, self.c])

    def scaled(self, factor: float) -> "CostModel":
        """Multiplicatively recalibrated copy (online feedback, §V-D).

        Clients report measured whole-plan eval time per record; the ratio
        observed/predicted recalibrates every coefficient at once.  This is
        the cheap online complement to the full regression refit
        (:func:`fit`): it corrects hardware-speed drift without needing
        per-pattern probe timings on the client.
        """
        if factor <= 0:
            raise ValueError(f"scale factor must be positive, got {factor}")
        return CostModel(
            k1=self.k1 * factor, k2=self.k2 * factor,
            k3=self.k3 * factor, k4=self.k4 * factor,
            c=self.c * factor, avg_record_len=self.avg_record_len,
        )


@dataclass
class CalibrationResult:
    model: CostModel
    r_squared: float
    n_probes: int
    residual_us: float


def _design_row(sel: float, len_p: float, len_t: float) -> list[float]:
    return [
        sel * len_p,
        sel * len_t,
        (1.0 - sel) * len_p,
        (1.0 - sel) * len_t,
        1.0,
    ]


def fit(
    sels: Sequence[float],
    pattern_lens: Sequence[int],
    record_lens: Sequence[float],
    times_us: Sequence[float],
    avg_record_len: float | None = None,
) -> CalibrationResult:
    """Least-squares fit of (k1..k4, c) from timed probes."""
    X = np.array(
        [_design_row(s, float(lp), float(lt)) for s, lp, lt in zip(sels, pattern_lens, record_lens)]
    )
    y = np.asarray(times_us, dtype=np.float64)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    pred = X @ coef
    ss_res = float(((pred - y) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    model = CostModel(
        k1=float(coef[0]),
        k2=float(coef[1]),
        k3=float(coef[2]),
        k4=float(coef[3]),
        c=float(coef[4]),
        avg_record_len=float(
            avg_record_len if avg_record_len is not None
            else np.mean(record_lens)),
    )
    return CalibrationResult(
        model=model,
        r_squared=r2,
        n_probes=len(y),
        residual_us=float(np.sqrt(ss_res / max(len(y), 1))),
    )


def calibrate_scaled(
    records: Sequence[bytes],
    probe_clauses: Sequence[Clause],
    engine,
    *,
    base: CostModel | None = None,
    sel: dict[Clause, float] | None = None,
    repeats: int = 3,
) -> CostModel:
    """Whole-plan timed-probe recalibration on a production engine (§V-D).

    Times ``engine.eval_fused`` over the probe clause set on the encoded
    record sample and scales ``base`` by observed/predicted — the same
    multiplicative recalibration the replanner applies online, so every
    clause cost stays positive (an unconstrained :func:`fit` does not
    guarantee that).  Size the probe like the plans the budget will buy:
    vectorized engines amortize shared chunk scans, so probing with a much
    larger plan understates live per-clause cost.
    """
    from .client import encode_chunk
    from .workload import estimate_selectivities

    base = base or CostModel()
    if sel is None:
        sel = estimate_selectivities(probe_clauses, records)
    predicted_us = sum(base.clause_cost(c, sel[c]) for c in probe_clauses)
    chunk = encode_chunk(records)
    engine.eval_fused(chunk, probe_clauses)  # warm caches / jit
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        engine.eval_fused(chunk, probe_clauses)
        best = min(best, time.perf_counter() - t0)
    observed_us = best / max(chunk.n_records, 1) * 1e6
    return base.scaled(max(observed_us / max(predicted_us, 1e-9), 1e-3))


def calibrate(
    records: Sequence[bytes],
    probe_preds: Sequence[SimplePredicate],
    evaluator: Callable[[Sequence[bytes], SimplePredicate], np.ndarray] | None = None,
    repeats: int = 3,
) -> CalibrationResult:
    """Time real probes on this hardware and fit the model (paper §VII-F).

    ``evaluator(records, pred) -> bool[n]`` defaults to the paper-faithful
    ``bytes.find`` engine.  Returns the fitted model plus R^2.
    """
    if evaluator is None:
        def evaluator(recs, pred):  # noqa: ANN001
            return np.array([pred.matches_raw(r) for r in recs])

    lens = np.array([len(r) for r in records], dtype=np.float64)
    avg_len = float(lens.mean())
    sels, plens, rlens, times = [], [], [], []
    for pred in probe_preds:
        best = np.inf
        hits = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            hits = evaluator(records, pred)
            dt = time.perf_counter() - t0
            best = min(best, dt)
        sel = float(np.mean(hits))
        per_record_us = best / len(records) * 1e6
        sels.append(sel)
        plens.append(pred.pattern_length())
        rlens.append(avg_len)
        times.append(per_record_us)
    return fit(sels, plens, rlens, times, avg_record_len=avg_len)
