"""Dry run: build and run every (arch x shape x mesh) cell's step on the
``meta`` device, over a fake world of 256 or 512 ranks (port of
``repro.launch.dryrun``).

For each cell this builds the real step (``make_train_step`` for train
shapes, ``Model.prefill`` / ``Model.decode`` for inference shapes) with
production shardings: the parameters, optimizer state, cache and inputs
are DTensors on the ``meta`` device, laid out by the config's rules over
the production mesh (``launch.mesh``), so nothing is allocated.  The step
runs once under ``analysis.comms.CommsRecorder``, which records every
collective DTensor lowers it into, and under ``saved_tensors_hooks``,
which add up what autograd saves for the backward.  It writes one record
per cell to ``artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json`` (never
``artifacts/dryrun/``, the JAX package's), with the JAX package's keys:

  * ``lower_s``: seconds to build the step (meta parameters, optimizer
    state, cache and inputs, their shardings); ``compile_s``: seconds to
    run it once on meta (nothing is compiled here);
  * ``memory_analysis``: the bytes one rank holds: ``argument_bytes``
    (the local shards of parameters, optimizer state, cache and inputs),
    ``output_bytes`` (of what the step returns), ``alias_bytes`` (outputs
    that are the inputs, updated in place: parameters, optimizer state,
    cache), and ``temp_bytes``, the local bytes autograd saved for the
    backward, a LOWER BOUND of XLA's temp figure, which has no exact
    counterpart: a checkpointed layer's recompute, a kernel's workspace
    and every transient tensor are not in it (0 for inference steps);
  * ``cost_analysis``: empty (no compiler reports one);
  * ``roofline``: the compute and memory terms from the analytic model
    (``analysis.flops.estimate`` over the devices, as the JAX package
    takes them) and the collective term from the recorded bytes, at the
    H100's constants (``analysis.roofline``).

Attention and RWKV's time loop run shapes-only on meta
(``models.layers.shape_only``: neither issues a collective).  Cells that
``shape_applicable`` rules out get a ``{"skipped": why}`` record, as in
the JAX package.  The fake process group becomes the default group of
the process, so the dry run runs as its own process:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --reduced \\
        --arch qwen3-1.7b --shape train_4k --mesh-shape 4,2 --out <dir>

``--mesh-shape`` replaces the production meshes by one small mesh over a
world of its size (the record's ``mesh`` is then the shape).  More than
one arch runs as one process per arch, as many at a time as the host
has cores: DTensor's sharding propagation over the 3-D multi-pod mesh
takes minutes a train cell where the 2-D mesh takes seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis import flops as flops_mod
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.comms import CommsRecorder
from repro_torch.configs import (
    SHAPES, cache_alloc_len, get_config, input_specs, list_archs,
    shape_applicable,
)
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import build_mesh, make_production_mesh
from repro_torch.models.layers import shape_only, tree_leaves, tree_map
from repro_torch.models.model import build_model
from repro_torch.serve.engine import cache_shape
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_train_step, opt_config_for

OUT = "artifacts/dryrun_torch"
MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}


class SkipCell(Exception):
    pass


def init_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks as the default group
    (this process is rank 0; collectives return at once, moving no
    data)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is "
                               f"initialised; the dry run needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(kind: str):
    if kind in MESH_SHAPES:
        return make_production_mesh(multi_pod=kind == "multi")
    dims = tuple(int(x) for x in kind.split(","))
    names = (("data", "model")[: len(dims)] if len(dims) <= 2
             else ("pod", "data", "model"))
    return build_mesh(dims, names)


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree) if isinstance(tree, dict) else tree:
        if not isinstance(t, torch.Tensor):
            continue
        loc = t.to_local() if shd.is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total


def _meta(specs: dict) -> dict:
    return {k: torch.empty(shp, dtype=dt, device="meta")
            for k, (shp, dt) in specs.items()}


def _laid_out(tree, mesh, batch: int):
    return tree_map(lambda x: shd.distribute(x, shd.NamedSharding(
        mesh, shd.batch_spec(mesh, x.ndim, batch_size=batch)
        if x.ndim else shd.P())), tree)


class _Saved:
    """``saved_tensors_hooks`` that add up the local bytes autograd saves."""

    def __init__(self):
        self.bytes = 0

    def pack(self, t):
        loc = t.to_local() if shd.is_dtensor(t) else t
        self.bytes += loc.numel() * loc.element_size()
        return t

    @staticmethod
    def unpack(t):
        return t


def build_step(arch: str, shape_name: str, mesh, *, overrides=None,
               reduced: bool = False):
    """(run, meta, args bytes, aliased bytes): ``run()`` runs the cell's
    step once and returns what it returns."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    model = build_model(cfg)
    values, axes = model.abstract_params()
    profile = (cfg.sharding_profile if shape.kind == "train"
               else cfg.serve_profile)
    params_sh = shd.param_shardings(values, axes, mesh,
                                    rules=shd.rules_for(profile))
    params = shd.shard_params(values, params_sh)
    specs = input_specs(cfg, shape)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "params": model.param_count(),
            "active_params": model.active_param_count()}
    B = shape.global_batch

    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        opt_state = opt_mod.init(params, opt_cfg)
        batch = _laid_out(_meta(specs), mesh, B)
        grad_specs = tree_map(lambda s: s.spec, params_sh)
        step_fn = make_train_step(model, opt_cfg, n_micro=cfg.microbatches,
                                  grad_specs=grad_specs)
        args = _local_bytes(params) + _local_bytes(opt_state) \
            + _local_bytes(batch)
        alias = _local_bytes(params) + _local_bytes(opt_state)

        def run():
            with shd.use_mesh(mesh):
                return step_fn(params, opt_state, batch)

    elif shape.kind == "prefill":
        s_alloc = cache_alloc_len(shape.seq_len)
        inputs = _laid_out(_meta(specs), mesh, B)
        args, alias = _local_bytes(params) + _local_bytes(inputs), 0

        def run():
            with shd.use_mesh(mesh):
                return model.prefill(params, inputs, s_alloc=s_alloc,
                                     cache_dtype=torch.bfloat16)

    else:  # decode: one new token against a cache of seq_len
        s_alloc = cache_alloc_len(shape.seq_len)
        s_cross = 4096 if cfg.family == "encdec" else 0
        tokens = _laid_out({"t": torch.empty((B,), dtype=torch.int32,
                                             device="meta")}, mesh, B)["t"]
        cache = shd.shard_cache(cache_shape(
            model, B, s_alloc, s_cross=s_cross, cache_dtype=torch.bfloat16),
            like=tokens)
        args = _local_bytes(params) + _local_bytes(cache) \
            + _local_bytes([tokens])
        alias = _local_bytes(cache)

        def run():
            with shd.use_mesh(mesh):
                return model.decode(params, cache, tokens, shape.seq_len)

    return run, meta, args, alias, cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, overrides=None, reduced: bool = False,
             suffix: str = "") -> dict:
    mesh = _mesh(mesh_kind)
    n_dev = math.prod(mesh.shape)
    t0 = time.time()
    run, meta, arg_bytes, alias_bytes, cfg = build_step(
        arch, shape_name, mesh, overrides=overrides, reduced=reduced)
    t_build = time.time() - t0
    rec, saved = CommsRecorder(), _Saved()
    t0 = time.time()
    with shape_only(), rec, torch.autograd.graph.saved_tensors_hooks(
            saved.pack, saved.unpack):
        out = run()
    t_run = time.time() - t0
    if meta["kind"] == "train":     # parameters and optimizer state
        out_bytes = _local_bytes(out[0]) + _local_bytes(out[1])
    else:                           # logits and cache
        out_bytes = _local_bytes([out[0]]) + _local_bytes(out[1])
    coll = rec.result()

    shape = SHAPES[shape_name]
    est = flops_mod.estimate(cfg, shape, meta["params"],
                             meta["active_params"])
    mf = rl.model_flops(cfg, shape, meta["active_params"])
    roof = rl.Roofline(
        arch=arch, shape=shape_name, mesh=mesh_kind,
        device_flops=est.flops_global / n_dev,
        device_bytes=est.hbm_bytes_global / n_dev,
        collective_bytes=float(coll["total"]),
        model_flops_global=mf, n_devices=n_dev,
        collectives={"bytes": coll["bytes"], "counts": coll["counts"]},
        memory_per_device_gb=(arg_bytes + out_bytes + saved.bytes) / 1e9,
        notes=(f"flops breakdown: "
               f"{ {k: f'{v:.3e}' for k, v in est.breakdown.items()} }; "
               f"temp_bytes is a lower bound (what autograd saved); "
               f"collective term over NVLink at "
               f"{rl.LINK_BW / 1e9:.0f} GB/s each way"),
    ).finalize()
    record = {
        **meta,
        "mesh": mesh_kind,
        "n_devices": n_dev,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_run, 2),
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": saved.bytes,
            "alias_bytes": alias_bytes,
            "generated_code_bytes": None,
        },
        "cost_analysis": {},
        "roofline": roof.to_json(),
    }
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{arch}_{shape_name}_{_tag(mesh_kind)}"
                               f"{suffix}.json")
    with open(fn, "w") as f:
        json.dump(record, f, indent=1)
    return record


def _tag(mesh_kind: str) -> str:
    return mesh_kind.replace(",", "x")


def _overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                pass
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default=None,
                    help="one small mesh in place of the production ones")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--suffix", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)
    overrides = _overrides(args.set)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    if len(archs) > 1:
        return _parallel(archs, args)

    if args.mesh_shape:
        meshes = [args.mesh_shape]
    else:
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    world = max(math.prod(MESH_SHAPES[m]) if m in MESH_SHAPES else
                math.prod(int(x) for x in m.split(",")) for m in meshes)
    init_fake_world(world)

    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    failures = []
    for arch in archs:
        for shape_name in shapes:
            cfg = get_config(arch)
            ok, why = shape_applicable(cfg, SHAPES[shape_name])
            for mesh_kind in meshes:
                tag = f"{arch} x {shape_name} x {mesh_kind}"
                out_fn = os.path.join(args.out, f"{arch}_{shape_name}_"
                                      f"{_tag(mesh_kind)}{args.suffix}.json")
                if args.skip_existing and os.path.exists(out_fn):
                    print(f"[skip-existing] {tag}")
                    continue
                if not ok:
                    print(f"[skipped] {tag}: {why}")
                    os.makedirs(args.out, exist_ok=True)
                    with open(out_fn, "w") as f:
                        json.dump({"arch": arch, "shape": shape_name,
                                   "mesh": mesh_kind, "skipped": why}, f)
                    continue
                try:
                    rec = run_cell(arch, shape_name, mesh_kind, args.out,
                                   overrides=overrides or None,
                                   reduced=args.reduced, suffix=args.suffix)
                    r = rec["roofline"]
                    print(f"[ok] {tag}: build={rec['lower_s']}s "
                          f"run={rec['compile_s']}s "
                          f"flops/dev={r['device_flops']:.3e} "
                          f"coll/dev={r['collective_bytes']:.3e}B "
                          f"dominant={r['dominant']} "
                          f"roofline_frac={r['roofline_frac']:.3f}",
                          flush=True)
                except Exception as e:  # noqa: BLE001 - report every cell
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        return 1
    print("\nall requested dry-run cells ran OK")
    return 0


def _parallel(archs, args) -> int:
    """``main`` once per arch, each in its own process (its own fake
    world), as many at a time as the host has cores; 1 if any failed."""
    import subprocess
    import sys

    common = ["--mesh", args.mesh, "--out", args.out, "--suffix",
              args.suffix]
    common += ["--shape", args.shape] if args.shape else []
    common += ["--mesh-shape", args.mesh_shape] if args.mesh_shape else []
    common += ["--reduced"] if args.reduced else []
    common += ["--skip-existing"] if args.skip_existing else []
    for kv in args.set:
        common += ["--set", kv]
    pending, running, rcs = list(archs), [], []
    while pending or running:
        while pending and len(running) < (os.cpu_count() or 1):
            running.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", pending.pop(0), *common]))
        for p in list(running):
            if p.poll() is not None:
                running.remove(p)
                rcs.append(p.returncode)
        time.sleep(0.2)
    return 1 if any(rcs) else 0


if __name__ == "__main__":
    raise SystemExit(main())
