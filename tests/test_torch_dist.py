"""The port's model mesh held against the JAX package (``tests/test_dist.py``).

The sharding rules are pure logic and run in this process, over a
hypothesis sweep.  Everything that needs several ranks runs in ONE gloo
job of 8 processes (``file://`` rendezvous in the test's temporary
directory, one thread per rank, at most 300 s), started once by a
module-scoped fixture: it runs every multi-rank check and returns JSON,
and each test asserts one part of it.  Its reference values come from
the JAX package on the same numpy-seeded inputs: the int8 all-reduces,
a checkpoint saved on a (4, 2) mesh and the spmd device scan from a JAX
subprocess with 8 host devices (as ``tests/test_dist.py`` and
``tests/test_device_scan.py`` run them), ``apply_moe`` in this process.
The fixture prints rank 0's seconds by part.

The checks:

  * ``compressed_allreduce`` at (2, 4) over ``data`` and
    ``_quantized_psum`` over 8 ranks holding 1.0, 100.0, ...: bit-equal
    to the JAX package's, with its spread 0 and error bound;
  * the sharded train step on (4, 2) within 5e-3 of one device (qwen3-8b
    reduced), its grads laid out by ``grad_specs``, with AdamW and with
    adafactor (its factored state laid out as the parameters);
  * f32 gradients on a mesh against one device for the dense, MoE/MLA,
    hybrid, RWKV and encoder-decoder families (``GRAD_CASES``), and under
    the remat policy ``"save_block_io"`` (``REMAT_CASES``);
  * ``ShardedDeviceScanner(spmd=True)``: tests/test_device_scan.py's
    workload, shard r on rank r, equal on every rank to the sequential
    scan and to the JAX package's spmd scan (in its subprocess), and its
    refusal of a group with fewer ranks than shards;
  * a checkpoint saved by the JAX package on its (4, 2) mesh restored on
    the port's (2, 2, 2) exactly, laid out as ``param_shardings`` says;
  * ``apply_moe_sharded`` on (2, 4) against the JAX package's
    ``apply_moe`` within 2e-4, aux within 1e-4;
  * data-parallel serving on (2, 1) with the same tokens as one device,
    with the weights FSDP-sharded (DTensors) and replicated (each rank's
    rows alone; a (1, 1) mesh runs so);
  * decode on (2, 4) raising where the JAX package's does (its
    flash-decoding stub), after a tensor-parallel prefill.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_dist.py``.
The job itself is this file run as a script, one process per rank.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

WORLD = 8
JOB_TIMEOUT_S = 300
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
VALS = (1.0, 100.0, 3.0, 7.0, 0.5, 50.0, 2.0, 9.0)
#: a gradient on a mesh against one device, in f32: of its leaf's max |g|
GRAD_TOL = 1e-5


# ---------------------------------------------------------------------------
# the job: one process per rank
# ---------------------------------------------------------------------------

def _allreduces(rank: int) -> dict:
    import torch

    from repro_torch.dist.collectives import _quantized_psum, \
        compressed_allreduce
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2, 4), ("data", "model"))
    x = {"a": torch.ones(64, 64) * 0.5,
         "b": torch.arange(32, dtype=torch.float32)}
    out = compressed_allreduce(x, mesh, axis="data")
    pod = make_test_mesh((8,), ("pod",))
    q = _quantized_psum(torch.full((16,), VALS[rank]), pod.get_group("pod"))
    return {"a": out["a"].numpy().tolist(), "b": out["b"].numpy().tolist(),
            "psum": q.numpy().tolist(), "combine": _combine(mesh)}


def _combine(mesh) -> float:
    """Decode attention over a cache whose keys are split over ``model``
    (4 ranks, 16 each), merged by ``combine_partials`` across it, against
    the whole cache on one rank."""
    import torch

    from repro_torch.dist import sharding as shd
    from repro_torch.models import attention as attn

    rng = np.random.default_rng(0)
    B, H, Hkv, hd, S = 2, 8, 2, 16, 64
    q = torch.from_numpy(rng.normal(size=(B, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, Hkv, hd)).astype(
        np.float32)) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32)
    pos[50:] = -1                                  # empty slots
    ref = attn.combine_partials(attn.decode_attention_gqa(q, k, v, pos))
    r, n = mesh.get_local_rank("model"), 4
    sl = slice(r * S // n, (r + 1) * S // n)
    part = attn.decode_attention_gqa(q, k[:, sl], v[:, sl], pos[sl])
    with shd.use_mesh(mesh):
        got = attn.combine_partials(part, "model")
    return float((got - ref).abs().max())


def _rel_err(got, want) -> float:
    """Worst leaf's max |got - want| over its max |want|; ``got`` DTensors
    (their full values) or plain tensors."""
    from repro_torch.models.layers import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, float((a.float() - b.float()).abs().max()) / scale)
    return worst


def _f32(arch: str):
    """``arch`` reduced, computing in f32; an MoE's capacity so large that
    no token is dropped on one device or on a rank (per-device capacity
    drops others than the global one)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=32.0))
    return cfg


def _state_laid_out(p, st) -> bool:
    """An optimizer state leaf laid out as its parameter ``p``: AdamW's
    moments and adafactor's ``v`` with ``p``'s placements; adafactor's
    ``vr`` and ``vc`` with ``p``'s, the dropped dim's shard replicated and
    the later dims' shards moved down one."""
    from torch.distributed.tensor import Replicate, Shard

    def drop(dim):
        return tuple(Replicate() if not pl.is_shard() or pl.dim == dim
                     else Shard(pl.dim - (pl.dim > dim))
                     for pl in p.placements)

    want = {"vr": drop(p.ndim - 1), "vc": drop(p.ndim - 2)}
    if not isinstance(st, dict):
        st = {"m": st}
    return all(getattr(t, "device_mesh", None) == p.device_mesh
               and tuple(t.placements) == want.get(k, tuple(p.placements))
               for k, t in st.items())


def _train_step(rank: int, kind: str) -> dict:
    """One ``kind`` step (AdamW, adafactor) of qwen3-8b reduced in f32 on
    (4, 2) with ``grad_specs`` against one device, at the full learning
    rate (no warmup): the loss, every parameter, and the optimizer state
    (AdamW's first moment, 0.1 x the clipped grad; adafactor's factored
    second moments, the clipped grad's squares' row and column means), so
    the grads' layout, their reduction and the global norm's; each state
    leaf laid out as its parameter."""
    import torch

    from repro_torch.configs import ShapeConfig, make_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import param_axes
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.optimizer import OptConfig, _state_leaves
    from repro_torch.train.train_step import make_train_step

    cfg = _f32("qwen3-8b")
    model = build_model(cfg)
    values = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, ShapeConfig("s", "train", 64, 4)).items()}
    oc = OptConfig(kind=kind, learning_rate=1e-3, weight_decay=0.0,
                   warmup_steps=0)

    ref = tree_map(torch.clone, values)
    _, st_ref, m_ref = make_train_step(model, oc)(ref, opt_mod.init(ref, oc),
                                                  batch)
    moved = min(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(ref), tree_leaves(values)))

    mesh = make_test_mesh((4, 2), ("data", "model"))
    psh = shd.param_shardings(values, param_axes(cfg), mesh)
    v2 = shd.shard_params(values, psh)
    b2 = tree_map(shd.distribute, batch, shd.batch_shardings(batch, mesh))
    specs = tree_map(lambda s: s.spec, psh)
    with shd.use_mesh(mesh):
        p_m, st_m, m_m = make_train_step(model, oc, grad_specs=specs)(
            v2, opt_mod.init(v2, oc), b2)
    state = (tree_leaves(st_m["m"]) if kind == "adamw"
             else _state_leaves(st_m["f"]))
    laid_out = all(_state_laid_out(p, s)
                   for p, s in zip(tree_leaves(p_m), state))
    err = max(float((a.full_tensor().float() - b.float()).abs().max())
              for a, b in zip(tree_leaves(p_m), tree_leaves(ref)))
    sharded = sum(any(type(p).__name__ == "Shard" for p in s.placements)
                  for s in tree_leaves(psh))
    key = "m" if kind == "adamw" else "f"
    return {"loss_ref": float(m_ref["loss"]), "loss_mesh": float(m_m["loss"]),
            "max_param_err": err, "min_update": moved,
            "state_rel_err": _rel_err(st_m[key], st_ref[key]),
            "laid_out": laid_out, "n_sharded_leaves": sharded,
            "n_state_leaves": len(state)}


#: (arch, mesh) of the gradient checks: kv heads split with the query
#: heads, kv heads replicated and sliced (two ranks on one kv head; each
#: pair of ranks on one), and MLA with the expert-parallel MoE
GRAD_CASES = (("qwen3-1.7b", (4, 2)), ("qwen3-8b", (4, 2)),
              ("qwen3-1.7b", (2, 4)), ("deepseek-v3-671b", (2, 4)),
              ("recurrentgemma-9b", (4, 2)), ("rwkv6-3b", (2, 4)),
              ("seamless-m4t-medium", (4, 2)))
#: the gradient checks of the remat policy "save_block_io": (arch, mesh)
REMAT_CASES = (("qwen3-1.7b", (4, 2)),)
#: cases whose one-device f32 gradient is itself further than GRAD_TOL
#: from its float64 gradient (rwkv6's time loop: 3.2e-5 of a leaf's max);
#: each is held to that distance, measured in the job
OWN_ROUNDING_CASES = ("rwkv6-3b",)


def _grads(rank: int, cases) -> dict:
    """``value_and_grad`` in f32 on each (arch, mesh, remat) case against
    one device under remat "full": the loss and every leaf's gradient
    (its full value), with the attention's head layout and whether the
    MoE ran expert-parallel."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig, make_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import value_and_grad

    out = {}
    for arch, shape, remat in cases:
        cfg = _f32(arch)
        base = build_model(cfg)
        model = build_model(dataclasses.replace(cfg, remat=remat))
        values = model.init(0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in make_batch(
            cfg, ShapeConfig("s", "train", 32, 4)).items()}
        loss_ref, g_ref = value_and_grad(base, values, batch)
        mesh = make_test_mesh(shape, ("data", "model"))
        psh = shd.param_shardings(values, base.abstract_params()[1], mesh)
        v2 = shd.shard_params(values, psh)
        b2 = tree_map(shd.distribute, batch, shd.batch_shardings(batch, mesh))
        with shd.use_mesh(mesh):
            loss_m, g_m = value_and_grad(model, v2, b2)
            ep = cfg.moe is not None and moe_mod.moe_sharding_available(cfg)
        layout = attn._head_layout(mesh, 4, cfg.n_heads, cfg.n_kv_heads)
        err = _rel_err(g_m, g_ref)
        # the f32 rounding of one device's own gradient: its distance from
        # the float64 gradient (rank 0; no collective)
        own = None
        if rank == 0 and arch in OWN_ROUNDING_CASES:
            b64 = build_model(dataclasses.replace(
                cfg, compute_dtype="float64", param_dtype="float64"))
            own = _rel_err(g_ref, value_and_grad(
                b64, tree_map(torch.Tensor.double, values), batch)[1])
        out[f"{arch}@{shape[0]}x{shape[1]}@{remat}"] = {
            "loss_diff": abs(float(loss_ref) - float(
                loss_m.full_tensor() if shd.is_dtensor(loss_m) else loss_m)),
            "grad_rel_err": err, "f32_vs_f64": own,
            "q_heads": str(layout[0]), "kv": str(layout[1]),
            "kv_grad": str(layout[2]), "kv_slice": layout[3] is not None,
            "expert_parallel": ep}
    return out


def _restore(rank: int, ckpt_dir: str, ref_npz: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import param_axes
    from repro_torch.train import checkpoint as ckpt

    cfg = get_config("qwen3-1.7b").reduced()
    values, _ = build_model(cfg).abstract_params()
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    sh = shd.param_shardings(values, param_axes(cfg), mesh)
    like = {k: v for k, v in values.items()}
    v2, manifest = ckpt.restore(ckpt_dir, 1, like, shardings=sh)
    want = np.load(ref_npz)
    err = max(float(np.abs(a.full_tensor().numpy() - want[p]).max())
              for p, a in zip(manifest["paths"], tree_leaves(v2)))
    ok_shard = all(tuple(a.placements) == s.placements
                   and a.device_mesh == mesh
                   for a, s in zip(tree_leaves(v2), tree_leaves(sh)))
    return {"err": err, "ok_shard": bool(ok_shard),
            "n_leaves": len(manifest["paths"])}


def _moe(rank: int, moe_npz: str) -> dict:
    """``apply_moe_sharded`` on (2, 4) against the JAX package's
    ``apply_moe``: its output and aux, and the gradient of
    ``sum(out * R) + aux`` (R fixed, seeded) with respect to x and every
    weight against ``jax.grad`` of the same."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as moe_mod

    cfg = _f32("deepseek-v3-671b")
    z = np.load(moe_npz)
    mesh = make_test_mesh((2, 4), ("data", "model"))

    def rep(a):
        return distribute_tensor(torch.from_numpy(a), mesh,
                                 [Replicate()] * 2).requires_grad_()

    p = {k[2:]: rep(z[k]) for k in z.files if k.startswith("p_")}
    x, r = rep(z["x"]), rep(z["r"]).detach()
    with shd.use_mesh(mesh):
        avail = moe_mod.moe_sharding_available(cfg)
        out, aux = moe_mod.apply_moe_sharded(p, x, cfg)
        ((out * r).sum() + aux).backward()
    grads = {"x": x.grad, **{k: v.grad for k, v in p.items()}}
    g_err = max(float(np.abs(g.full_tensor().numpy() - z[f"g_{k}"]).max())
                / float(np.abs(z[f"g_{k}"]).max()) for k, g in grads.items())
    out, aux = out.full_tensor().detach(), aux.full_tensor().detach()
    return {"available": avail,
            "err": float(np.abs(out.numpy() - z["out"]).max()),
            "aux": float(aux), "aux_ref": float(z["aux"]),
            "grad_rel_err": g_err, "n_grads": len(grads)}


def _serve(rank: int) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import _use_sharded_decode, \
        param_axes
    from repro_torch.serve.engine import greedy_generate, make_serve_fns

    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    values = model.init(0, device="cpu")
    B, S, n = 4, 13, 3      # a cache of 144 slots: the model axis divides it
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32))
    out = {}
    # every rank takes part in building each mesh; only members serve
    dp = make_test_mesh((2, 1), ("data", "model"))
    tp = make_test_mesh((2, 4), ("data", "model"))
    if dp.get_coordinate() is not None:
        ref = greedy_generate(model, make_serve_fns(
            model, batch=B, seq_len=S + n), model.compute_params(values),
            toks, n_steps=n)
        from repro_torch.serve.engine import _laid_out
        out["dp_placements"] = str(_laid_out(toks, dp, B).placements)
        # tp_fsdp shards the embed dims over data, serve_tp replicates
        # every weight on (2, 1); the latter's plain weights are placed by
        # make_serve_fns from param_shardings
        for rules in ("tp_fsdp", "serve_tp"):
            psh = shd.param_shardings(values, param_axes(cfg), dp,
                                      rules=shd.rules_for(rules))
            params = model.compute_params(
                shd.shard_params(values, psh) if rules == "tp_fsdp"
                else values)
            fns = make_serve_fns(model, dp, batch=B, seq_len=S + n,
                                 param_shardings=psh)
            got = greedy_generate(model, fns, params, toks, n_steps=n)
            out[f"dp_equal_{rules}"] = bool(torch.equal(got.full_tensor(),
                                                        ref))
    psh = shd.param_shardings(values, param_axes(cfg), tp,
                              rules=shd.rules_for("serve_tp"))
    params = shd.shard_params(values, psh)
    fns = make_serve_fns(model, tp, batch=B, seq_len=S + n,
                         param_shardings=psh)
    logits, cache = fns["prefill"](params, {"tokens": toks})
    with shd.use_mesh(tp):
        out["guard"] = _use_sharded_decode(fns["s_alloc"])
    try:
        fns["decode"](params, cache, toks[:, -1], S)
        out["decode"] = "returned"
    except NotImplementedError as e:
        out["decode"] = f"NotImplementedError: {e}"
    out["prefill_logits_shape"] = list(logits.shape)
    return out


#: the sharded device scan over ranks: tests/test_device_scan.py's
#: spmd workload (ycsb records, seed, hash shards on linear_score,
#: segment capacity, first queries), shard r on rank r; ranks 4-7 own none
SCAN_RECORDS, SCAN_SEED, SCAN_SHARDS, SCAN_QUERIES = 2048, 7, 4, 8
SCAN_CHUNK = 256


def _scan_store(jit: bool):
    """A port replica of the reference test's sharded store (its
    ``_build``: two epochs, a replan at the halfway point, tiers in turn),
    promoted up front when ``jit``; and its queries."""
    from repro_torch.core.client import NumpyEngine, encode_chunk
    from repro_torch.core.predicates import Query, clause, key_value
    from repro_torch.core.server import PlanFamily, PushdownPlan, \
        evolve_family
    from repro_torch.core.shard import ShardedCiaoStore, ShardRouter
    from repro_torch.core.workload import estimate_selectivities
    from repro_torch.data.datasets import generate_records, predicate_pool

    recs = generate_records("ycsb", SCAN_RECORDS, seed=SCAN_SEED)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:8]),
                      tier_sizes=(2, 4, 8))
    fam1 = evolve_family(fam0, ranked[:4] + ranked[8:12], (2, 4, 8))
    store = ShardedCiaoStore(fam0, router=ShardRouter(
        n_shards=SCAN_SHARDS, key="linear_score", mode="hash"),
        segment_capacity=512)
    eng = NumpyEngine()
    half = (len(recs) // 2) // SCAN_CHUNK * SCAN_CHUNK
    for lo, hi, epoch in ((0, half, 0), (half, len(recs), 1)):
        if epoch:
            store.advance_epoch(fam1)
        fam = store.family
        for i, start in enumerate(range(lo, hi, SCAN_CHUNK)):
            tier = i % fam.n_tiers
            chunk = encode_chunk(recs[start: start + SCAN_CHUNK])
            store.ingest_chunk(chunk, eng.eval_fused_prefix(
                chunk, fam.plan.clauses, fam.tier_sizes[tier]),
                epoch=epoch, tier=tier)
    if jit:
        store.jit_load_raw()
    qs = [Query((c,)) for c in fam0.plan.clauses[:3] + fam1.plan.clauses[:3]]
    qs += [Query((fam0.plan.clauses[0], ranked[13]))]
    qs += [Query((c,)) for c in ranked[14:17]]
    for v in (3, 55, 97, 250):
        qs.append(Query((clause(key_value("linear_score", v)),)))
    qs.append(Query((clause(key_value("phone_country", "ZZ")),)))
    return store, qs[:SCAN_QUERIES]


def _full_accounting(r) -> list:
    """Every ScanResult field, groups in their order, as JSON."""
    return json.loads(json.dumps([
        r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
        r.segments_pruned, r.segments_scanned, r.shards_scanned,
        r.shards_pruned, r.used_skipping,
        [[list(k), [g.count, g.rows_scanned, g.rows_skipped, g.raw_parsed,
                    g.segments_pruned]] for k, g in r.groups.items()]]))


def _spmd_scan(rank: int) -> dict:
    """``ShardedDeviceScanner(spmd=True, backend="torch")`` over the 8
    gloo ranks against the port's sequential scan of a twin replica: the
    reference test's promoted store and batch, then an unpromoted store
    scanned twice (its raw rows promoted inside the first batch, on every
    rank's replica); which shard's plane each rank admitted; and the
    refusal of a store with more shards than ranks."""
    from repro_torch.core.device_scan import ShardedDeviceScanner
    from repro_torch.core.server import PushdownPlan
    from repro_torch.core.shard import ShardedCiaoStore, ShardRouter
    from repro_torch.data.datasets import predicate_pool

    out = {}
    for name, jit, reps in (("promoted", True, 1), ("unpromoted", False, 2)):
        store, qs = _scan_store(jit)
        twin, _ = _scan_store(jit)
        spmd = ShardedDeviceScanner(store, backend="torch",
                                    log_queries=False, spmd=True)
        seq = ShardedDeviceScanner(twin, backend="torch", device="cpu",
                                   log_queries=False)
        got = [[_full_accounting(r) for r in spmd.scan_batch(qs)]
               for _ in range(reps)]
        want = [[_full_accounting(r) for r in seq.scan_batch(qs)]
                for _ in range(reps)]
        out[name] = {"spmd": got, "seq": want,
                     "uploads": [c.uploads for c in spmd.caches],
                     "device": str(spmd._scanners[0].device),
                     "mesh": None if spmd.mesh is None else
                     list(spmd.mesh.mesh.shape),
                     "raw_left": [sum(r.n for r in s.raw)
                                  for s in store.shards]}
    wide = ShardedCiaoStore(PushdownPlan(clauses=predicate_pool("ycsb")[:2]),
                            router=ShardRouter(
        n_shards=2 * WORLD, key="linear_score", mode="hash"))
    try:
        ShardedDeviceScanner(wide, backend="torch", spmd=True)
        out["too_few_ranks"] = "returned"
    except RuntimeError as e:
        out["too_few_ranks"] = f"RuntimeError: {e}"
    return out


def job(rank: int, init: str, out_dir: str, ckpt_dir: str, ref_npz: str,
        moe_npz: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    res, times = {}, {}
    for name, fn in (("allreduce", lambda: _allreduces(rank)),
                     ("train", lambda: _train_step(rank, "adamw")),
                     ("adafactor", lambda: _train_step(rank, "adafactor")),
                     ("grads", lambda: _grads(rank, [
                         (a, m, "full") for a, m in GRAD_CASES] + [
                         (a, m, "save_block_io") for a, m in REMAT_CASES])),
                     ("spmd_scan", lambda: _spmd_scan(rank)),
                     ("restore", lambda: _restore(rank, ckpt_dir, ref_npz)),
                     ("moe", lambda: _moe(rank, moe_npz)),
                     ("serve", lambda: _serve(rank))):
        t0 = time.perf_counter()
        res[name] = fn()
        times[name] = time.perf_counter() - t0
    res["seconds"] = times
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------

_JAX_SUB = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.dist import sharding as shd
    from repro.dist.collectives import _quantized_psum, compressed_allreduce
    from repro.launch.mesh import make_test_mesh
    from repro.models.layers import split
    from repro.models.model import build_model
    from repro.train import checkpoint as ckpt

    out_dir = sys.argv[1]
    mesh = make_test_mesh((2, 4), ("data", "model"))
    x = {"a": jnp.ones((64, 64)) * 0.5, "b": jnp.arange(32, dtype=jnp.float32)}
    o = compressed_allreduce(x, mesh, axis="data")
    vals = %r
    pod = make_test_mesh((8,), ("pod",))
    xs = jnp.stack([jnp.full((16,), v, jnp.float32) for v in vals])
    f = shard_map(lambda s: _quantized_psum(s[0], "pod")[None], mesh=pod,
                  in_specs=(P("pod"),), out_specs=P("pod"), check_rep=False)
    q = np.asarray(f(xs))
    cfg = get_config("qwen3-1.7b").reduced()
    values, axes = split(build_model(cfg).init(jax.random.PRNGKey(0)))
    v1 = jax.tree.map(jax.device_put, values,
                      shd.param_shardings(values, axes,
                                          make_test_mesh((4, 2))))
    ckpt.save(out_dir + "/ckpt", v1, step=1)
    flat = jax.tree_util.tree_flatten_with_path(values)[0]
    np.savez(out_dir + "/values.npz", **{
        "/".join(str(k) for k in path): np.asarray(v) for path, v in flat})
    np.savez(out_dir + "/allreduce.npz", a=np.asarray(o["a"]),
             b=np.asarray(o["b"]), psum=q)
    # tests/test_device_scan.py's spmd scan: shard i on host device i
    from repro.core.device_scan import ShardedDeviceScanner
    from repro.core.shard import ShardedCiaoStore, ShardRouter
    from repro.core.workload import estimate_selectivities
    from repro.data.datasets import generate_records, predicate_pool
    from tests.test_device_scan import _build, _families, _workload
    recs = generate_records("ycsb", %d, seed=%d)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    fam0, fam1 = _families(ranked)
    store = _build(ShardedCiaoStore(fam0, router=ShardRouter(
        n_shards=%d, key="linear_score", mode="hash"), segment_capacity=512),
        recs, fam0, fam1)
    scanner = ShardedDeviceScanner(store, log_queries=False, spmd=True)
    res = scanner.scan_batch(_workload(fam0, fam1, ranked)[:%d])
    full = [[r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
             r.segments_pruned, r.segments_scanned, r.shards_scanned,
             r.shards_pruned, r.used_skipping,
             [[list(k), [g.count, g.rows_scanned, g.rows_skipped,
                         g.raw_parsed, g.segments_pruned]]
              for k, g in r.groups.items()]] for r in res]
    with open(out_dir + "/spmd_scan.json", "w") as f:
        json.dump(full, f)
    print(json.dumps({"ok": True}))
""" % (VALS, SCAN_RECORDS, SCAN_SEED, SCAN_SHARDS, SCAN_QUERIES))


def _jax_reference(tmp) -> None:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        (SRC, os.path.join(SRC, ".."))), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _JAX_SUB, str(tmp)],
                         capture_output=True, text=True, env=env,
                         timeout=JOB_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]


def _moe_reference(path) -> None:
    """The JAX package's ``apply_moe`` on seeded inputs: its output, aux,
    and the gradient of ``sum(out * R) + aux`` in every input."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import moe as j_moe

    cfg = get_config("deepseek-v3-671b").reduced()
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=32.0))
    rng = np.random.default_rng(7)
    shapes = {"router": (cfg.d_model, cfg.moe.n_experts)}
    p = {k: (rng.normal(size=s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    E, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    for k, s in (("wi", (E, d, ff)), ("wg", (E, d, ff)), ("wo", (E, ff, d))):
        p[k] = (rng.normal(size=s) * d ** -0.5).astype(np.float32)
    sff = cfg.moe.d_ff_shared or ff * cfg.moe.n_shared_experts
    for k, s in (("shared_wi", (d, sff)), ("shared_wg", (d, sff)),
                 ("shared_wo", (sff, d))):
        p[k] = (rng.normal(size=s) * d ** -0.5).astype(np.float32)
    x = rng.normal(size=(4, 8, d)).astype(np.float32)
    r = rng.normal(size=(4, 8, d)).astype(np.float32)

    def loss(pp, xx):
        out, aux = j_moe.apply_moe(pp, xx, cfg)
        return jnp.sum(out * r) + aux, (out, aux)

    pj = {k: jnp.asarray(v) for k, v in p.items()}
    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(pj, jnp.asarray(x))
    np.savez(path, x=x, r=r, out=np.asarray(out), aux=np.asarray(aux),
             g_x=np.asarray(gx),
             **{f"p_{k}": v for k, v in p.items()},
             **{f"g_{k}": np.asarray(v) for k, v in gp.items()})


@pytest.fixture(scope="module")
def job_result(tmp_path_factory):
    """Run the 8-rank gloo job once; rank 0's JSON, with every rank's
    all-reduce outputs and the JAX package's."""
    pytest.importorskip("torch")
    tmp = tmp_path_factory.mktemp("dist")
    _jax_reference(tmp)
    _moe_reference(tmp / "moe.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), init, str(tmp),
         str(tmp / "ckpt"), str(tmp / "values.npz"), str(tmp / "moe.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.monotonic() + JOB_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    ranks = [json.load(open(tmp / f"rank{r}.json")) for r in range(WORLD)]
    ref = np.load(tmp / "allreduce.npz")
    print("gloo job, rank 0's seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items())
        + f"; the job {sum(ranks[0]['seconds'].values()):.1f} s")
    return {"ranks": ranks, "ref": {k: ref[k] for k in ref.files},
            "ref_spmd_scan": json.load(open(tmp / "spmd_scan.json")),
            **ranks[0]}


# ---------------------------------------------------------------------------
# the rules (this process)
# ---------------------------------------------------------------------------

class _FakeMesh:
    """What both packages' ``spec_for_leaf`` read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = shape


def _jax_spec_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def test_spec_for_leaf_rules():
    """tests/test_dist.py's case: axes of size 1 are dropped entirely."""
    from repro_torch.dist.sharding import P, spec_for_leaf

    mesh = _FakeMesh({"data": 1, "model": 1})
    assert spec_for_leaf((8, 4), ("embed", "ffn"), mesh) == P()


def test_spec_for_leaf_equals_reference_sweep():
    """``spec_for_leaf`` equals the JAX package's ``PartitionSpec`` for
    every profile over shapes, logical axes and mesh sizes."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from repro.dist import sharding as j_shd
    from repro_torch.dist import sharding as t_shd

    names = [None, "embed", "ffn", "heads", "kv_heads", "expert", "vocab",
             "q_lora", "kv_lora", "head_dim", "layers"]
    sizes = st.sampled_from([1, 2, 3, 4, 8, 16])

    @settings(max_examples=300, deadline=None)
    @given(st.lists(st.tuples(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16,
                                                32, 48]),
                              st.sampled_from(names)), min_size=1,
                    max_size=4),
           st.sampled_from(["tp_fsdp", "fsdp", "serve_tp"]),
           st.booleans(), sizes, sizes, sizes)
    def check(dims, profile, pod, n_pod, n_data, n_model):
        shape = tuple(d for d, _ in dims)
        axes = tuple(a for _, a in dims)
        mesh = {"data": n_data, "model": n_model}
        if pod:
            mesh = {"pod": n_pod, **mesh}
        m = _FakeMesh(mesh)
        got = t_shd.spec_for_leaf(shape, axes, m, t_shd.rules_for(profile))
        want = j_shd.spec_for_leaf(shape, axes, m, j_shd.rules_for(profile))
        assert tuple(got) == _jax_spec_tuple(want)
        assert tuple(t_shd.batch_spec(m, 3, batch_size=shape[0])) == \
            _jax_spec_tuple(j_shd.batch_spec(m, 3, batch_size=shape[0]))

    check()


def test_param_axes_equal_reference_for_every_arch():
    """Every parameter's logical axes (``Model.abstract_params``) equal
    the JAX package's ``split`` axes, "layers" first in stacked groups,
    and the meta values its shapes in ``param_dtype``."""
    import jax

    from repro.configs import get_config as j_get, list_archs
    from repro.models.model import build_model as j_build
    from repro_torch.configs import get_config as t_get
    from repro_torch.models.layers import torch_dtype, tree_leaves
    from repro_torch.models.model import build_model as t_build

    for arch in list_archs():
        jv, jax_axes = j_build(j_get(arch)).abstract_params()
        tv, t_axes = t_build(t_get(arch)).abstract_params()
        want = jax.tree.leaves(jax_axes, is_leaf=lambda x: isinstance(
            x, tuple))
        assert tree_leaves(t_axes) == want, arch
        assert [tuple(v.shape) for v in tree_leaves(tv)] == \
            [tuple(v.shape) for v in jax.tree.leaves(jv)], arch
        dt = torch_dtype(t_get(arch).param_dtype)
        assert all(v.device.type == "meta" and v.dtype == dt
                   for v in tree_leaves(tv)), arch


def test_placements_of_specs():
    """A spec becomes one placement per mesh dim; a dim over (pod, data)
    is sharded on both."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import P, placements

    class Mesh:
        shape = (2, 2, 4)
        mesh_dim_names = ("pod", "data", "model")

    assert placements(P(("pod", "data"), None, "model"), Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), Mesh()) == (
        Replicate(), Shard(1), Replicate())
    assert placements(P(), Mesh()) == (Replicate(),) * 3


def test_mesh_needs_a_process_group():
    """Without enough ranks the mesh refuses, naming what it needs, as
    the JAX package's does without enough devices."""
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_test_mesh((2, 2))


def test_constraints_are_no_ops_off_a_mesh():
    import torch

    from repro_torch.dist import sharding as shd

    x = torch.ones(4, 3, 2)
    assert shd.current_mesh() is None
    assert shd.constrain_act(x) is x and shd.constrain_seq(x) is x
    with shd.use_mesh(_FakeMesh({"data": 2, "model": 2})):
        assert shd.current_mesh() is not None
        assert shd.constrain_act(x, vocab_dim=True) is x   # a plain tensor
    assert shd.current_mesh() is None
    assert shd.scan_mesh(1) is None and shd.scan_mesh(4) is None


def test_decode_stub_raises_as_reference():
    """The flash-decoding path is the JAX package's stub in both
    packages, with the same flags."""
    import torch

    from repro.dist import collectives as j_coll
    from repro_torch.dist import collectives as t_coll

    for name in ("REDUCE_IS_STUB", "ATTENTION_IS_STUB", "IS_STUB"):
        assert getattr(t_coll, name) == getattr(j_coll, name), name
    q = torch.zeros(1, 2, 4)
    with pytest.raises(NotImplementedError):
        j_coll.sharded_decode_attention_gqa(q, q, q, q)
    with pytest.raises(NotImplementedError, match="sharded_decode"):
        t_coll.sharded_decode_attention_gqa(q, q, q, q)


# ---------------------------------------------------------------------------
# the gloo job's parts
# ---------------------------------------------------------------------------

def test_compressed_allreduce_bit_equal_to_reference(job_result):
    """Replicated input over ``data`` (2 ranks) -> 2x, bit for bit the
    JAX package's, within its test's bounds."""
    ref = job_result["ref"]
    for r in job_result["ranks"]:
        a = np.asarray(r["allreduce"]["a"], np.float32)
        b = np.asarray(r["allreduce"]["b"], np.float32)
        assert np.array_equal(a, ref["a"]) and np.array_equal(b, ref["b"])
    x_b = np.arange(32, dtype=np.float32)
    assert float(np.abs(a - 1.0).max()) < 0.01
    assert float(np.abs(b - 2 * x_b).max()
                 / max(np.abs(2 * x_b).max(), 1)) < 0.01


def test_combine_partials_across_a_mesh_axis(job_result):
    """Partial softmax stats of 4 key ranges, merged over ``model`` (MAX,
    rescale, SUM), equal the whole cache's attention on every rank."""
    for r in job_result["ranks"]:
        assert r["allreduce"]["combine"] < 1e-5, r["allreduce"]["combine"]


def test_quantized_psum_agreed_scale_bit_equal_to_reference(job_result):
    """8 ranks holding 1.0, 100.0, ...: every rank the same sum (spread
    0), within n * scale / 2, bit-equal to the JAX package's."""
    outs = np.asarray([r["allreduce"]["psum"] for r in job_result["ranks"]],
                      np.float32)
    assert float(np.abs(outs - outs[0, 0]).max()) == 0.0
    bound = len(VALS) * (max(VALS) / 127) / 2
    assert float(np.abs(outs - sum(VALS)).max()) <= bound + 1e-6
    assert np.array_equal(outs, job_result["ref"]["psum"])


def test_sharded_train_step_matches_single_device(job_result):
    """The loss and the parameters within the JAX package's 5e-3, every
    leaf moved by the step, and the first moment (the clipped grads)
    within GRAD_TOL of each leaf's max."""
    out = job_result["train"]
    assert abs(out["loss_ref"] - out["loss_mesh"]) < 5e-3, out
    assert out["max_param_err"] < 5e-3, out
    assert out["min_update"] > 5e-4, out
    assert out["state_rel_err"] < GRAD_TOL, out
    assert out["laid_out"] and out["n_sharded_leaves"] > 0, out


def test_sharded_adafactor_step_matches_single_device(job_result):
    """Adafactor on (4, 2): the loss and the parameters within the same
    5e-3 of one device, every leaf moved, the factored second moments
    within 2 x GRAD_TOL of each leaf's max (squares of grads held within
    GRAD_TOL: twice the relative error), and every state leaf a DTensor
    laid out as its parameter (``vr``/``vc`` without the dim they drop).
    The port's state was plain tensors of the global shape, and the step
    failed in DTensor's dispatch."""
    out = job_result["adafactor"]
    assert abs(out["loss_ref"] - out["loss_mesh"]) < 5e-3, out
    assert out["max_param_err"] < 5e-3, out
    assert out["min_update"] > 5e-4, out
    assert out["state_rel_err"] < 2 * GRAD_TOL, out
    assert out["laid_out"] and out["n_sharded_leaves"] > 0, out
    assert out["n_state_leaves"] == job_result["train"]["n_state_leaves"]


def _grad_tol(arch, out) -> float:
    """GRAD_TOL; for OWN_ROUNDING_CASES the larger of it and one device's
    own f32 rounding (its f32 gradient against its float64 gradient, of
    each leaf's max |g|)."""
    if arch not in OWN_ROUNDING_CASES:
        return GRAD_TOL
    return max(GRAD_TOL, out["f32_vs_f64"])


@pytest.mark.parametrize("arch,shape", GRAD_CASES)
def test_sharded_grads_match_single_device(job_result, arch, shape):
    """Every leaf's gradient on the mesh (its full value) within GRAD_TOL
    of its max |g| on one device, in f32 (or within the case's own f32
    rounding, :func:`_grad_tol`), in the layout the case names."""
    out = job_result["grads"][f"{arch}@{shape[0]}x{shape[1]}@full"]
    assert out["loss_diff"] < 1e-5, out
    assert out["grad_rel_err"] < _grad_tol(arch, out), out
    assert "Shard(dim=2)" in out["q_heads"], out
    sliced = arch in ("qwen3-8b", "recurrentgemma-9b") or \
        (arch, shape) == ("qwen3-1.7b", (2, 4))
    if sliced:
        assert out["kv_slice"] and "Partial" in out["kv_grad"], out
    else:
        assert "Shard(dim=2)" in out["kv"] and not out["kv_slice"], out
    assert out["expert_parallel"] == (arch == "deepseek-v3-671b"), out


@pytest.mark.parametrize("arch,shape", REMAT_CASES)
def test_save_block_io_grads_on_a_mesh_match_single_device(job_result, arch,
                                                           shape):
    """remat "save_block_io" on the mesh (its tag op on each rank's shard,
    placements kept) against one device under "full": every leaf within
    GRAD_TOL of its max |g|.  The tag op had no DTensor rule, and the
    policy raised on any mesh."""
    out = job_result["grads"][f"{arch}@{shape[0]}x{shape[1]}@save_block_io"]
    assert out["loss_diff"] < 1e-5, out
    assert out["grad_rel_err"] < GRAD_TOL, out


def test_resharding_restore_of_a_jax_checkpoint(job_result):
    """Saved by the JAX package on (4, 2), restored on the port's
    (2, 2, 2): exact, every leaf laid out as ``param_shardings`` says."""
    out = job_result["restore"]
    assert out["err"] == 0.0 and out["ok_shard"] and out["n_leaves"] > 0


def test_sharded_moe_matches_reference_apply_moe(job_result):
    out = job_result["moe"]
    assert out["available"]
    assert out["err"] < 2e-4, out
    assert abs(out["aux"] - out["aux_ref"]) < 1e-4, out
    assert out["n_grads"] == 8 and out["grad_rel_err"] < GRAD_TOL, out


def test_data_parallel_serving_same_tokens(job_result):
    out = job_result["serve"]
    assert out["dp_equal_tp_fsdp"] and out["dp_equal_serve_tp"], out
    assert "Shard(dim=0)" in out["dp_placements"], out


def test_sharded_decode_reaches_the_stub(job_result):
    """A tensor-parallel prefill on (2, 4) runs; its decode meets the
    guard and the JAX package's stub, and raises as the JAX package's
    does."""
    out = job_result["serve"]
    assert out["guard"] is True
    assert out["decode"].startswith("NotImplementedError"), out
    assert out["prefill_logits_shape"][0] == 4



def test_spmd_device_scan_matches_sequential_and_reference(job_result):
    """tests/test_device_scan.py's spmd case over the gloo ranks: 4 hash
    shards, shard r scanned by rank r alone (kernel B's plain version),
    the results gathered: on every rank equal in full accounting to the
    port's sequential scan of a twin replica and to the JAX package's
    ``ShardedDeviceScanner(spmd=True)`` (one ``shard_map`` program over 4
    of 8 host devices).  Only rank r's cache admitted shard r's plane;
    ranks 4-7 admitted nothing."""
    ref = job_result["ref_spmd_scan"]
    assert len(ref) == SCAN_QUERIES
    for rank, r in enumerate(job_result["ranks"]):
        out = r["spmd_scan"]["promoted"]
        assert out["spmd"] == [ref] and out["seq"] == [ref], rank
        assert out["mesh"] == [SCAN_SHARDS] and out["device"] == "cpu"
        owned = [i for i, n in enumerate(out["uploads"]) if n]
        assert owned == ([rank] if rank < SCAN_SHARDS else []), out
    assert sum(r[0] for r in ref) > 0 and any(r[7] for r in ref)


def test_spmd_device_scan_keeps_every_replica_promoted(job_result):
    """Unpromoted replicas, scanned twice: each rank promotes the raw rows
    of every shard in global query order (the host part runs for all
    shards), so both batches equal the sequential scan's on every rank,
    and every rank's replica holds the same raw rows afterwards."""
    outs = [r["spmd_scan"]["unpromoted"] for r in job_result["ranks"]]
    for rank, out in enumerate(outs):
        assert out["spmd"] == out["seq"] == outs[0]["seq"], rank
        assert out["raw_left"] == outs[0]["raw_left"], rank
    assert len(outs[0]["seq"]) == 2 and len(outs[0]["seq"][0]) == SCAN_QUERIES


def test_spmd_device_scan_refuses_too_few_ranks(job_result):
    """16 shards over 8 ranks: ``spmd=True`` raises, naming the group,
    on every rank (it never falls back to scanning in turn); with no
    process group at all it raises too."""
    from repro_torch.core.device_scan import ShardedDeviceScanner
    from repro_torch.core.server import PushdownPlan
    from repro_torch.core.shard import ShardedCiaoStore, ShardRouter
    from repro_torch.data.datasets import predicate_pool

    for r in job_result["ranks"]:
        msg = r["spmd_scan"]["too_few_ranks"]
        assert msg.startswith("RuntimeError") and "8 ranks over gloo" in msg
    store = ShardedCiaoStore(PushdownPlan(clauses=predicate_pool("ycsb")[:2]),
                             router=ShardRouter(n_shards=4, key="x"))
    with pytest.raises(RuntimeError, match="no process group"):
        ShardedDeviceScanner(store, backend="torch", spmd=True)
    ShardedDeviceScanner(store, backend="torch", spmd=False)   # in turn


if __name__ == "__main__":
    job(int(sys.argv[1]), *sys.argv[2:])
