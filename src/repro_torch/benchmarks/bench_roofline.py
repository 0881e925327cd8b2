"""Roofline tables from the dry run's records (port of
``benchmarks/bench_roofline.py``).

Reads ``artifacts/dryrun_torch/*.json`` (written by
``python -m repro_torch.launch.dryrun``) and renders the per-(arch x shape
x mesh) three-term table to stdout and ``artifacts/roofline_table_torch.md``.
The terms are at the H100's constants (``analysis.roofline``); the
memory column is the dry run's bytes per rank, whose temp part is a lower
bound.  A decode cell that reaches the flash-decoding stub (a model axis
of 16 dividing its cache, in both packages) has no record and no row.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_roofline
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import SHAPES, list_archs

DRYRUN = "artifacts/dryrun_torch"
TABLE = "artifacts/roofline_table_torch.md"
COLS = ("compute_s", "memory_s", "collective_s")


def load_records(path: str | None = None) -> dict:
    recs = {}
    path = path or DRYRUN
    for f in glob.glob(os.path.join(path, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def render(recs: dict, mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL/analytic flops | roofline_frac | mem/dev GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in list_archs():
        for shape in SHAPES:
            r = recs.get((arch, shape, mesh))
            if r is None:
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | skipped | "
                             "— | — | — |")
                continue
            ro = r["roofline"]
            lines.append(
                f"| {arch} | {shape} | {ro['compute_s']:.3e} | "
                f"{ro['memory_s']:.3e} | {ro['collective_s']:.3e} | "
                f"{ro['dominant']} | {ro['useful_flops_frac']:.2f} | "
                f"{ro['roofline_frac']:.3f} | "
                f"{ro['memory_per_device_gb']:.1f} |")
    return "\n".join(lines)


def main(path: str | None = None, table: str | None = None) -> dict:
    recs = load_records(path)
    table = table or TABLE
    if not recs:
        print("[roofline] no dry-run records found; run "
              "python -m repro_torch.launch.dryrun")
        return {}
    for mesh in ("single", "multi"):
        print(f"\n=== roofline ({mesh}-pod mesh, H100 constants) ===")
        print(render(recs, mesh))
    os.makedirs(os.path.dirname(table) or ".", exist_ok=True)
    with open(table, "w") as f:
        f.write("# Roofline (single-pod, H100 constants)\n\n"
                + render(recs, "single"))
        f.write("\n\n# Roofline (multi-pod, H100 constants)\n\n"
                + render(recs, "multi") + "\n")
    worst = sorted((r for r in recs.values() if "roofline" in r),
                   key=lambda r: r["roofline"]["roofline_frac"])[:5]
    print("\nworst roofline fractions:")
    for r in worst:
        print(f"  {r['arch']} x {r['shape']} x {r['mesh']}: "
              f"{r['roofline']['roofline_frac']:.4f} "
              f"({r['roofline']['dominant']})")
    return recs


if __name__ == "__main__":
    main()
