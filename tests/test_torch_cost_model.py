"""The port's cost model (``repro_torch.core.cost_model``) held against the
JAX package's (``tests/test_cost_model.py``).

The fit is least squares over the same design rows in both packages, so
its coefficients and R² on the same inputs must be equal; clause prices
are sums of the same terms.  Calibration times real probes, so only its
deterministic parts are compared exactly: each probe's hits and pattern
length, and the fit of the port's timed rows in both packages.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import cost_model as j_cm  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.data.datasets import generate_records as j_records  # noqa: E402
from repro_torch.core import predicates as t_pred  # noqa: E402
from repro_torch.core.cost_model import CostModel, calibrate, fit  # noqa: E402
from repro_torch.core.predicates import (  # noqa: E402
    clause, exact, key_value, substring,
)
from repro_torch.data.datasets import generate_records  # noqa: E402


def test_fit_recovers_exact_coefficients():
    # record lengths must vary or {sel*lt, (1-sel)*lt, 1} are collinear and
    # k2/k4/c are unidentifiable (the paper calibrates across datasets of
    # different record lengths for the same reason)
    true = CostModel(k1=0.004, k2=0.0015, k3=0.002, k4=0.001, c=0.05)
    rng = np.random.default_rng(0)
    sels = rng.uniform(0, 1, 50)
    plens = rng.integers(2, 30, 50)
    rlens = rng.uniform(80, 500, 50)
    times = [
        true.sel_len_cost(float(s), int(p), float(lt))
        for s, p, lt in zip(sels, plens, rlens)
    ]
    jtrue = j_cm.CostModel(k1=0.004, k2=0.0015, k3=0.002, k4=0.001, c=0.05)
    assert times == [jtrue.sel_len_cost(float(s), int(p), float(lt))
                     for s, p, lt in zip(sels, plens, rlens)]
    res = fit(sels, plens, rlens, times)
    want = j_cm.fit(sels, plens, rlens, times)
    assert res.r_squared > 0.999
    np.testing.assert_allclose(res.model.coefficients(), true.coefficients(),
                               rtol=1e-6, atol=1e-9)
    assert np.array_equal(res.model.coefficients(), want.model.coefficients())
    assert (res.r_squared, res.n_probes, res.residual_us) == \
        (want.r_squared, want.n_probes, want.residual_us)


def _probes(pred):
    return ([pred.exact("phone_country", c) for c in ("US", "CN", "IN")]
            + [pred.substring("url_site", s)
               for s in ("www.alpha.", "www.beta.", "x")]
            + [pred.key_value("linear_score", v) for v in (1, 7, 55, 99)]
            + [pred.substring("email", "@"), pred.substring("name", "zzz")])


def test_calibration_on_real_engine():
    """Paper §VII-F: R² of the timed fit (local target: > 0.5); every
    probe's hits and pattern length the JAX package's, and the fit of the
    port's timed rows the JAX package's fit of them."""
    records = generate_records("ycsb", 400, seed=1)
    assert records == j_records("ycsb", 400, seed=1)
    probes, j_probes = _probes(t_pred), _probes(j_pred)
    rows = {}

    def timed(recs, pred):
        hits = np.array([pred.matches_raw(r) for r in recs])
        rows[pred] = hits
        return hits

    res = calibrate(records, probes, evaluator=timed, repeats=3)
    assert res.n_probes == len(probes)
    for p, jp in zip(probes, j_probes):
        assert np.array_equal(rows[p], [jp.matches_raw(r) for r in records])
        assert p.pattern_length() == jp.pattern_length()
    # timing noise on shared CI hardware: this is a sanity floor, the paper
    # reports 0.67-0.98 across platforms
    assert res.r_squared > 0.3, res.r_squared
    assert res.model.pattern_cost(10, 0.5) > 0
    # the same rows through both packages' fit, the times held fixed
    sels = [float(np.mean(rows[p])) for p in probes]
    plens = [p.pattern_length() for p in probes]
    avg = float(np.mean([len(r) for r in records]))
    times = [res.model.sel_len_cost(s, n, avg) + 0.01 * i
             for i, (s, n) in enumerate(zip(sels, plens))]
    got = fit(sels, plens, [avg] * len(sels), times, avg_record_len=avg)
    want = j_cm.fit(sels, plens, [avg] * len(sels), times, avg_record_len=avg)
    assert np.array_equal(got.model.coefficients(), want.model.coefficients())
    assert got.r_squared == want.r_squared


def test_clause_cost_is_sum_of_disjuncts():
    m, jm = CostModel(), j_cm.CostModel()
    c1 = clause(exact("a", "x"))
    c2 = clause(exact("a", "x"), exact("a", "y"))
    assert m.clause_cost(c2, 0.3) > m.clause_cost(c1, 0.3)
    np.testing.assert_allclose(
        m.clause_cost(c2, 0.3),
        m.simple_cost(exact("a", "x"), 0.3) + m.simple_cost(exact("a", "y"), 0.3),
    )
    jc2 = j_pred.clause(j_pred.exact("a", "x"), j_pred.exact("a", "y"))
    assert m.clause_cost(c2, 0.3) == jm.clause_cost(jc2, 0.3)


def test_key_value_priced_two_patterns():
    m, jm = CostModel(), j_cm.CostModel()
    kv = key_value("age", 10)
    assert m.simple_cost(kv, 0.2) > m.simple_cost(exact("age", "x"), 0.2) * 0.9
    assert m.simple_cost(kv, 0.2) == jm.simple_cost(
        j_pred.key_value("age", 10), 0.2)
    assert m.simple_cost(substring("t", "abc"), 0.2) == jm.simple_cost(
        j_pred.substring("t", "abc"), 0.2)
