"""Fault-tolerant training entry point (end to end: CIAO ingest -> train loop).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-1.7b --reduced --dataset ycsb --budget-us 1.0 \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir <run dir>
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-1.7b --reduced --device cpu --steps 4 --batch 2 \\
        --seq 64 --n-clients 2 --chunks-per-client 2 --chunk-records 64

The port of ``repro.launch.train``.  Flow:
  1. Build the CIAO plan for the dataset's recipe workload under the client
     budget; spin up client shards (``NumpyEngine``, as the JAX package's
     trainer); ingest with the work-stealing coordinator; construct the
     recipe batcher + prefetcher.
  2. Draw the f32 parameters from ``--seed`` on ``--device`` (the card
     unless ``--device cpu``; it raises where there is none) and
     auto-resume from the latest valid checkpoint in ``--ckpt-dir``
     (crash-safe: partial writes are ignored).
  3. Train with async checkpointing every ``--ckpt-every`` steps.
     ``--fail-at-step N`` injects a crash (``SystemExit(42)``) for the
     restart test.

``--mesh-shape`` takes any shape that the initialised process group
holds (``make_mesh``: 2 dims are (data, model), 3 are (pod, data,
model)); the parameters are then sharded by the config's rules
(``dist.sharding``), the batches laid out over the batch axes, and a
checkpoint restores onto the mesh whatever mesh wrote it.  Without a
process group the default ``1,1`` runs on one device without a mesh,
and any other shape raises.  The ``[done]`` line prints the JAX
package's result keys; the returned dict adds every step's loss and
host-clock seconds (the device synchronised by reading the loss), the
device, and the trained ``params``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.client import NumpyEngine
from repro_torch.core.planner import build_plan
from repro_torch.core.predicates import Query
from repro_torch.core.server import CiaoStore
from repro_torch.core.workload import generate_workload
from repro_torch.data.datasets import generate_records, predicate_pool
from repro_torch.data.pipeline import (
    ClientShard, IngestCoordinator, Prefetcher, RecipeBatcher,
)
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import build_mesh
from repro_torch.models.layers import resolve_device, tree_map
from repro_torch.models.model import build_model, family_module
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import (
    init_opt_state, make_train_step, opt_config_for,
)


def build_data(args, vocab_size: int):
    pool = predicate_pool(args.dataset)
    rng = np.random.default_rng(args.seed)
    wl = generate_workload(
        pool, n_queries=args.n_queries, distribution="zipf", zipf_a=1.5,
        rng=rng, name="train-recipes",
    )
    sample = generate_records(args.dataset, 500, seed=args.seed + 1)
    report = build_plan(wl, sample, budget_us=args.budget_us)
    store = CiaoStore(report.plan)
    engine = NumpyEngine()
    clients = [
        ClientShard(args.dataset, i, engine, report.plan,
                    chunk_records=args.chunk_records,
                    speed=(0.25 if (args.straggler and i == 0) else 1.0))
        for i in range(args.n_clients)
    ]
    coord = IngestCoordinator(clients, store, steal=True)
    coord.run(chunks_per_client=args.chunks_per_client)
    # recipe: the highest-value pushed clause (or full data if none pushed)
    recipe = (
        Query((report.plan.clauses[0],))
        if report.plan.clauses else Query(tuple())
    )
    tok = ByteTokenizer(vocab_size=vocab_size)
    batcher = RecipeBatcher(store, tok, seq_len=args.seq, batch_size=args.batch)
    return report, store, coord, recipe, batcher


def make_mesh(shape_str: str):
    """``"4,2"`` -> a (data, model) mesh; 3 dims are (pod, data, model);
    over the initialised process group (``launch.mesh.build_mesh``)."""
    dims = tuple(int(x) for x in shape_str.split(",") if x)
    names = (("data", "model")[: len(dims)] if len(dims) <= 2
             else ("pod", "data", "model"))
    return build_mesh(dims, names)


def mesh_for(shape_str: str):
    """The mesh of ``--mesh-shape``, or None for ``1,1`` with no process
    group initialised (one device, no mesh)."""
    import torch.distributed as dist

    dims = [int(x) for x in shape_str.split(",") if x]
    if all(d == 1 for d in dims) and not dist.is_initialized():
        return None
    return make_mesh(shape_str)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dataset", default="ycsb")
    ap.add_argument("--budget-us", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh-shape", default="1,1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--n-clients", type=int, default=4)
    ap.add_argument("--n-queries", type=int, default=20)
    ap.add_argument("--chunk-records", type=int, default=256)
    ap.add_argument("--chunks-per-client", type=int, default=4)
    ap.add_argument("--straggler", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = mesh_for(args.mesh_shape)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, microbatches=1)
    model = build_model(cfg)

    report, store, coord, recipe, batcher = build_data(args, cfg.vocab_size)
    print(f"[data] plan: {report.selection.describe()}")
    print(f"[data] loaded {store.stats.n_loaded}/{store.stats.n_records} "
          f"(ratio {store.stats.loading_ratio:.3f}), stolen chunks: {coord.stolen}")

    values = model.init(args.seed, device=dev)
    state_sh = None
    if mesh is not None:
        params_sh = shd.param_shardings(
            values, family_module(cfg).param_axes(cfg), mesh)
        values = shd.shard_params(values, params_sh)
        state_sh = (params_sh, {"m": params_sh, "v": params_sh,
                                "step": shd.NamedSharding(mesh, shd.P())})
    opt_cfg = opt_config_for(cfg)
    opt_state = init_opt_state(model, values, opt_cfg)

    start_step = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            (values, opt_state), manifest = ckpt.restore(
                args.ckpt_dir, latest, (values, opt_state), device=dev,
                shardings=state_sh)
            start_step = manifest["step"]
            print(f"[ckpt] resumed from step {start_step}")

    step_fn = make_train_step(model, opt_cfg, n_micro=1)
    writer = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None

    losses: list[float] = []
    step_s: list[float] = []
    t0 = time.time()
    with Prefetcher(batcher.batches(recipe, repeat=True), depth=2) as data_it, \
            shd.use_mesh(mesh):
        for step in range(start_step, args.steps):
            tokens, mask = next(data_it)
            batch = {"tokens": torch.from_numpy(tokens).to(dev),
                     "loss_mask": torch.from_numpy(mask).to(dev)}
            if mesh is not None:
                batch = tree_map(shd.distribute, batch,
                                 shd.batch_shardings(batch, mesh))
            t_step = time.perf_counter()
            values, opt_state, metrics = step_fn(values, opt_state, batch)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - t_step)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(time.time()-t0):.1f}s)")
            if writer and (step + 1) % args.ckpt_every == 0:
                writer.save((values, opt_state), step=step + 1)
            if args.fail_at_step is not None and step + 1 == args.fail_at_step:
                print(f"[fault-injection] crashing at step {step + 1}")
                raise SystemExit(42)
    if writer:
        writer.save((values, opt_state), step=args.steps)
        writer.wait()
    result = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps_run": len(losses),
        "loading_ratio": store.stats.loading_ratio,
    }
    print(f"[done] {json.dumps(result)}")
    return {**result, "losses": losses, "step_s": step_s,
            "device": str(dev), "params": values}


if __name__ == "__main__":
    main()
