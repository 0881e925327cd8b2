"""Paper Table IV on the port: cost-model calibration R² across
'platforms' (the JAX package's ``benchmarks/bench_cost_model.py``).

We cannot span three physical machines, so the platform axis becomes the
*engine* axis — three genuinely different execution profiles: the
paper-faithful bytes.find engine and the vectorized numpy engine on the
host, and kernel A on the card (``KernelEngine("cuda")``, in place of the
reference's XLA-jitted row; ``--device cpu``: its plain version).  The
paper's claim under test is that the 5-coefficient linear model fits each
platform after per-platform calibration (paper R²: 0.897 / 0.666 /
0.978).  R² is reported, not gated.  The card's row times one launch per
probe, copy back included: launch-bound, so its fit says how well five
coefficients describe a launch, and no plan is priced from it.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_cost_model

Writes ``artifacts/bench_torch_cost_model.json`` with the card's name and
power limit.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import BACKEND, card, write_artifact
from repro_torch.core.client import NumpyEngine, encode_chunk
from repro_torch.core.cost_model import calibrate
from repro_torch.core.predicates import exact, key_value, substring
from repro_torch.data.datasets import generate_records


def _probes():
    probes = []
    probes += [exact("phone_country", c) for c in ("US", "CN", "IN")]
    probes += [substring("url_site", s) for s in
               ("www.alpha.", "www.beta.", "www.gamma.", "q", "zz")]
    probes += [key_value("linear_score", v) for v in (0, 3, 17, 55, 99)]
    probes += [key_value("weighted_score", v) for v in (1, 42)]
    probes += [substring("email", "@"), substring("email", "999@"),
               substring("name", "Warm"), substring("address", "st"),
               exact("age_group", "adult"), exact("age_group", "child")]
    return probes


def main(n_records: int = 3000, repeats: int = 5, device: str = "cuda"):
    records = generate_records("ycsb", n_records, seed=41)
    probes = _probes()
    rows = []

    # platform 1: paper-faithful bytes.find
    res = calibrate(records, probes, repeats=repeats)
    rows.append({"platform": "python-bytes-find", "r_squared": round(res.r_squared, 3),
                 "coeffs": [round(float(c), 6) for c in res.model.coefficients()]})

    # platform 2: vectorized numpy engine
    np_eng = NumpyEngine()
    chunk = encode_chunk(records)

    def np_eval(recs, pred):
        from repro_torch.core.predicates import Clause

        return np_eng.eval(chunk, [Clause((pred,))])[0]

    res = calibrate(records, probes, evaluator=np_eval, repeats=repeats)
    rows.append({"platform": "numpy-vectorized", "r_squared": round(res.r_squared, 3),
                 "coeffs": [round(float(c), 6) for c in res.model.coefficients()]})

    # platform 3: kernel A on the card (its plain version on the CPU)
    from repro_torch.kernels.engine import KernelEngine

    backend = BACKEND[device]
    k_eng = KernelEngine(backend=backend)

    def k_eval(recs, pred):
        from repro_torch.core.predicates import Clause

        return k_eng.eval(chunk, [Clause((pred,))])[0]

    # build the kernel and stage a plan so we time steady-state
    k_eval(records, probes[0])
    res = calibrate(records, probes, evaluator=k_eval, repeats=repeats)
    rows.append({"platform": "cuda-kernel" if backend == "cuda"
                 else "torch-plain", "r_squared": round(res.r_squared, 3),
                 "coeffs": [round(float(c), 6) for c in res.model.coefficients()]})

    for r in rows:
        print(f"[tableIV] {r['platform']:20s} R²={r['r_squared']} "
              f"(paper range: 0.666-0.978)")
    path = write_artifact("cost_model", {
        "device": device, "card": card(device), "n_records": n_records,
        "rows": rows})
    print(f"wrote {path}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=tuple(BACKEND), default="cuda")
    ap.add_argument("--records", type=int, default=3000)
    args = ap.parse_args()
    main(args.records, device=args.device)
