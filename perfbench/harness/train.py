"""The training driver: a trainer fed by a CIAO store through its data path.

Set-up loads the store: ``clients`` record streams drawn from the seed,
chunk by chunk in turn, each chunk's pushed clauses evaluated by the host
engine and ingested under the plan the planner built for a zipf workload
within the budget; the recipe is the plan's top pushed clause.  The
trainer (``make_train_step``: loss, gradients, global-norm clip, AdamW in
place) is built once on weights drawn from the seed and fed by
``RecipeBatcher`` -> ``Prefetcher``; set-up drives it through its first
``check_steps`` steps, which compile and warm every shape and give the
readings the reference follows.  The same trainer and feed then run the
window until ``seconds`` have passed; it closes when the last step started
has its loss on the host.

``correct``: the rows the data path selects and the tokens it fed, against
a plain filter of the same records and a plain tokenizer; and the first
steps' losses, the first gradient as the optimizer got it (from its first
moment after one step), and each leaf's change after those steps, against
the plain reference's steps in f32 on the same batches.
"""
from __future__ import annotations

import collections
import statistics

import numpy as np
import torch

from repro_torch.core.client import NumpyEngine, encode_chunk
from repro_torch.core.planner import build_plan
from repro_torch.core.predicates import Query
from repro_torch.core.server import CiaoStore
from repro_torch.core.workload import generate_workload
from repro_torch.data.datasets import predicate_pool
from repro_torch.data.pipeline import Prefetcher, RecipeBatcher
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import build_model
from repro_torch.train.train_step import init_opt_state, make_train_step

from perfbench.reference import data as ref_data, train as ref_train
from perfbench.reference.train import named_leaves

from . import bench, port, traffic as traffic_mod, weights as weights_mod
from .record import Tracer, sync
from .runs import Run, free, log, memory_peak, now_ns


def load_store(tr: dict, seed: int):
    """(store, recipe Query, every record) for the mix ``tr``."""
    if tr["dataset"] != "ycsb":
        raise ValueError(f"dataset {tr['dataset']!r}: the generator makes ycsb")
    n, cr = tr["chunks_per_client"], tr["chunk_records"]
    streams = [traffic_mod.ycsb_records(n * cr, seed, c) for c in range(tr["clients"])]
    wl = generate_workload(predicate_pool(tr["dataset"]), n_queries=tr["recipe_queries"],
                           distribution="zipf", zipf_a=tr["zipf_a"],
                           rng=np.random.default_rng([seed, 4]), name="train-recipes")
    report = build_plan(wl, streams[0][:500], budget_us=tr["budget_us"])
    plan = report.plan
    store = CiaoStore(plan)
    engine = NumpyEngine()
    for j in range(n):
        for recs in streams:
            chunk = encode_chunk(recs[j * cr:(j + 1) * cr])
            store.ingest_chunk(chunk, engine.eval_fused(chunk, plan.clauses),
                               epoch=plan.epoch)
    recipe = Query((plan.clauses[0],)) if plan.clauses else Query(())
    return store, recipe, [r for s in streams for r in s]


def run(cell: dict, seed: int, seconds: float, trace: bool, dev: torch.device,
        t0_ns: int, *, device_name: str = "", control: bool = False,
        make_step=make_train_step) -> Run:
    conf, tr = cell["config"], cell["traffic"]
    reference, adapter = bench.architecture(conf)
    arch = reference.arch_from_config(conf)
    cfg = adapter.model_config(cell["workload"]["config"], conf)
    model = build_model(cfg)
    opt_cfg = port.opt_config(conf)
    B, S = tr["batch"], tr["seq_len"]
    run_ = Run(arch, tr, device_name)

    log("store")
    store, recipe, records = load_store(tr, seed)
    batcher = RecipeBatcher(store, ByteTokenizer(vocab_size=arch.vocab), seq_len=S,
                            batch_size=B)
    log("weights")
    dt = torch_dtype(conf["run"]["param_dtype"])
    values = weights_mod.make_weights(cfg, seed, dev, dt)
    opt_state = init_opt_state(model, values, opt_cfg)
    step_fn = make_step(model, opt_cfg, n_micro=1)
    fed, losses = [], []
    readings = {}
    tracer = Tracer(trace, dev)

    def step(t_ns):
        nonlocal values, opt_state
        with run_.spans.span("batch_wait"):
            tokens, mask = next(pf)
        wait = (now_ns() - t_ns) / 1e9
        fed.append((tokens, mask))
        with run_.spans.span("train_step"):
            batch = {"tokens": torch.from_numpy(tokens).to(dev),
                     "loss_mask": torch.from_numpy(mask).to(dev)}
            values, opt_state, metrics = step_fn(values, opt_state, batch)
            losses.append(float(metrics["loss"]))
        return wait

    with Prefetcher(batcher.batches(recipe, repeat=True), depth=tr["prefetch_depth"]) as pf:
        for i in range(tr["check_steps"]):
            log(f"set-up step {i + 1}")
            step(now_ns())
            if i == 0:
                readings["first_grad"] = {
                    p: float(m.float().norm()) / (1 - opt_cfg.b1)
                    for p, m in named_leaves(opt_state["m"])}
        current = dict(named_leaves(values))
        readings["change"] = {
            p: float((current[p].float() - p0.float()).norm())
            for p, p0 in weights_mod.iter_weights(cfg, seed, dev, dt)}
        del current
        readings["losses"] = list(losses)
        sync(dev)
        run_.spans.items.clear()
        log(f"window, {seconds} s")
        with tracer.window():
            w0 = now_ns()
            run_.setup_s = (w0 - t0_ns) / 1e9
            while now_ns() - w0 < seconds * 1e9:
                t = now_ns()
                wait = step(t)
                run_.steps.append(dict(tokens=B * S, wait_s=wait,
                                       step_s=(now_ns() - t) / 1e9))
            sync(dev)
            w1 = now_ns()
    run_.window_s = (w1 - w0) / 1e9
    run_.memory_peak_bytes = memory_peak(dev)
    if trace:
        run_.trace = tracer.reduce((w0, w1), run_.spans)
    log(f"window closed: {len(run_.steps)} steps in {run_.window_s:.3f} s")
    del values, opt_state, step_fn, tracer
    free(dev)
    run_.check = check(cell, reference, arch, cfg, seed, dev, batcher, recipe, records, fed,
                       readings, control)
    return run_


def _gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's gap of norms, against the larger of the leaf's
    reference norm and the median leaf's."""
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def check(cell, reference, arch, cfg, seed, dev, batcher, recipe, records, fed, readings,
          control: bool) -> dict:
    """``data_mismatch``: records the data path selects and no plain filter
    does or the reverse, plus tokens fed that differ from the plain
    tokenizer's packing of its rows (exact).  ``loss_gap``: the worst of the
    first steps' relative loss gaps; ``grad_gap`` and ``change_gap``: the worst
    leaf's gap of gradient and change norms (:func:`_gap`; leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out of the change).  With ``control``, the f32 reference against the
    same reference rounded to fp8 (``*.control``).  ``reference``:
    the architecture's reference module, ``arch`` its shape."""
    conf, tr = cell["config"], cell["traffic"]
    B, S = tr["batch"], tr["seq_len"]
    clause = [{"kind": t.kind.value, "key": t.key, "value": t.value}
              for c in recipe.clauses for t in c.terms]
    log("reference: data path")
    rows = list(batcher.matching_records(recipe))
    plain = [r for r in records if ref_data.matches(r, clause)] if clause else records
    diff = collections.Counter(rows)
    diff.subtract(collections.Counter(plain))
    mismatch = sum(abs(v) for v in diff.values())
    expected = ref_data.stream(rows, ref_data.ByteTokens(arch.vocab), B, S)
    ref_batches = []
    for tokens, mask in fed:
        want, want_mask = next(expected)
        ref_batches.append(want)
        mismatch += int((tokens != want).sum()) + int((mask != want_mask).sum())
    out = {"data_mismatch": float(mismatch)}

    n = len(readings["losses"])
    batches = [torch.from_numpy(b).to(dev).long() for b in ref_batches[:n]]
    opt = conf["run"]["optimizer"]
    initial = lambda: weights_mod.iter_weights(cfg, seed, dev, torch.float32)  # noqa: E731
    refs = {}
    for prec in ("f32", "fp8") if control else ("f32",):
        log(f"reference: {n} steps, {prec}")
        w = weights_mod.make_weights(cfg, seed, dev, torch.float32)
        refs[prec] = ref_train.train(reference.row_loss_sum, w, arch, batches, opt,
                                     initial, prec)
        del w
        free(dev)
    ref = refs["f32"]
    keys = sorted(ref["first_grad"])
    med = statistics.median(ref["first_grad"].values())
    moved = [k for k in keys if ref["first_grad"][k] >= 1e-3 * med]
    sides = {"": readings}
    if control:                 # the control takes the step's place, not the data path's
        sides[".control"] = refs["fp8"]
        out["data_mismatch.control"] = out["data_mismatch"]
    for suffix, side in sides.items():
        out["loss_gap" + suffix] = max(abs(a - b) / abs(b) for a, b in
                                       zip(side["losses"], ref["losses"]))
        out["grad_gap" + suffix] = _gap(side["first_grad"], ref["first_grad"], keys)
        out["change_gap" + suffix] = _gap(side["change"], ref["change"], moved)
    return out
