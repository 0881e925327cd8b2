"""Where the benchmark's data lives, found by the names in BENCHMARK.json.

* ``BENCHMARK.json`` (the checkout's root): cells, metrics, run length.
* ``perfbench/configs/<config>.json``: a configuration, published keys at
  the top level, plus ``run`` (how the program runs it) and ``reference``,
  which names its architecture (:func:`architecture`):
  ``perfbench/reference/<reference>.py`` is its plain reference and
  ``perfbench/harness/ports/<reference>.py`` builds the port's
  configuration of it.
* ``perfbench/traffic/<traffic>.json``: a traffic mix's parameters.
* ``perfbench/limits/<workload>.json``: the numbers that decide
  ``correct`` in a cell and the limit of each.
* ``perfbench/metrics/<metric>.py``: a metric's reader, ``read(run)``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    """The workload ``name`` with its configuration, traffic and limits,
    and the metrics it reports (``end_to_end`` and ``per_layer`` lists of
    BENCHMARK.json entries)."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return {
        "workload": w,
        "config": load_json("configs", w["config"]),
        "traffic": load_json("traffic", w["traffic"]),
        "limits": load_json("limits", name),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def load_json(folder: str, name: str) -> dict:
    return json.loads((PERFBENCH / folder / f"{name}.json").read_text())


def metric_reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = PERFBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Architecture(NamedTuple):
    """A configuration's architecture.  ``reference`` (imports nothing of
    the program): ``arch_from_config(conf)``, whose ``Arch`` counts
    ``forward_flops(B, S, logit_positions)`` and
    ``prefill_attention_bound_s(B, S, peak)``; ``request_logits(weights,
    arch, tokens, n_prompt, prec)``; ``row_loss_sum(weights, arch, tokens,
    prec)``; ``TINY``, the published-key overrides of CPU tests.  ``port``:
    ``model_config(name, conf, run)``, the program's ``ModelConfig``."""
    reference: ModuleType
    port: ModuleType


def architectures() -> list[str]:
    """The architectures with a port adapter in ``perfbench/harness/ports``."""
    return sorted(p.stem for p in (PERFBENCH / "harness" / "ports").glob("*.py")
                  if p.stem != "__init__")


def _module(module: str) -> ModuleType | None:
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        return None


def architecture(conf: dict) -> Architecture:
    """The reference module and port adapter that the configuration's
    ``reference`` names; a ``KeyError`` that lists the architectures where
    either is missing."""
    name = conf["reference"]
    mods = [_module(f"{package}.{name}") if name.isidentifier() else None
            for package in ("perfbench.reference", "perfbench.harness.ports")]
    if None in mods:
        raise KeyError(f"no architecture {name!r}: perfbench/reference/{name}.py and "
                       f"perfbench/harness/ports/{name}.py are both needed; the "
                       f"architectures are {architectures()}")
    return Architecture(*mods)
