"""The port's span recorder (``repro_torch.tracing``), its span sites in
the serve engine, the transformer, F's backward, the train step and the
recipe batcher, and the batcher's row counts in the store's telemetry
plane (``TelemetryPlane.record_rows``) against the store's own scan."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs, tracing  # noqa: E402
from repro_torch.core.client import NumpyEngine, encode_chunk  # noqa: E402
from repro_torch.core.predicates import Query  # noqa: E402
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, PlanFamily, PushdownPlan, evolve_family,
)
from repro_torch.core.workload import estimate_selectivities  # noqa: E402
from repro_torch.data.datasets import generate_records, predicate_pool  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    RECIPE_TENANT, Prefetcher, RecipeBatcher,
)
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.drain()
    yield
    tracing.drain()


def _paths(spans) -> list[str]:
    out = []
    for s in spans:
        out.append(s.name if s.parent < 0 else f"{out[s.parent]}/{s.name}")
    return out


def test_off_records_nothing_and_returns_one_shared_object():
    a, b = tracing.span("serve.decode"), tracing.span("layer")
    assert a is b
    with a:
        with b:
            pass
    tracing.enable()
    assert tracing.drain() == []


def test_spans_nest_and_drain_turns_the_recorder_off():
    tracing.enable()
    with tracing.span("serve.decode"):
        with tracing.span("layer"):
            with tracing.span("layer.attention"):
                pass
        with tracing.span("layer"):
            pass
    spans = tracing.drain()
    assert _paths(spans) == ["serve.decode", "serve.decode/layer",
                             "serve.decode/layer/layer.attention",
                             "serve.decode/layer"]
    assert all(s.t0_ns <= s.t1_ns for s in spans)
    assert spans[0].t0_ns <= spans[1].t0_ns and spans[2].t1_ns <= spans[1].t1_ns
    assert tracing.span("x") is tracing.span("y")
    with tracing.span("x"):
        pass
    assert tracing.drain() == []


def test_two_threads_keep_separate_parents():
    tracing.enable()
    inside = threading.Event()
    done = threading.Event()

    def worker():
        inside.wait(10)
        with tracing.span("data.batch"):
            with tracing.span("inner"):
                pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with tracing.span("train.backward"):
        inside.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    spans = tracing.drain()
    by_name = {s.name: (i, s) for i, s in enumerate(spans)}
    _, main = by_name["train.backward"]
    i_batch, batch = by_name["data.batch"]
    _, inner = by_name["inner"]
    assert main.parent == -1 and batch.parent == -1
    assert inner.parent == i_batch
    assert batch.thread == inner.thread != main.thread


def test_a_span_open_across_enable_is_no_parent():
    tracing.enable()
    outer = tracing.span("stale")
    with outer:
        tracing.enable()
        with tracing.span("fresh"):
            pass
    spans = tracing.drain()
    assert [(s.name, s.parent) for s in spans] == [("fresh", -1)]


def _tiny():
    cfg = configs.get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    return cfg, model, model.init(0, device="cpu")


def test_serve_engine_spans_each_layer_with_its_attention_and_ffn():
    from repro_torch.serve.engine import make_serve_fns
    cfg, model, params = _tiny()
    fns = make_serve_fns(model, batch=2, seq_len=12)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8))
    tracing.enable()
    logits, cache = fns["prefill"](model.compute_params(params), {"tokens": prompt})
    tok = torch.argmax(logits, -1).to(torch.int32)
    fns["decode"](model.compute_params(params), cache, tok, 8)
    paths = _paths(tracing.drain())
    n = cfg.n_layers
    for step in ("serve.prefill", "serve.decode"):
        assert paths.count(step) == 1
        assert paths.count(f"{step}/layer") == n
        assert paths.count(f"{step}/layer/layer.attention") == n
        assert paths.count(f"{step}/layer/layer.ffn") == n
    assert len(paths) == 2 * (1 + 3 * n)


def test_train_step_spans_forward_backward_optimizer_and_recompute():
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_opt_state, make_train_step
    cfg, model, params = _tiny()
    assert cfg.remat == "full"
    opt_cfg = OptConfig()
    state = init_opt_state(model, params, opt_cfg)
    step = make_train_step(model, opt_cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": tokens, "loss_mask": torch.ones(2, 16)}
    tracing.enable()
    step(params, state, batch)
    spans = tracing.drain()
    paths = _paths(spans)
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert paths.count(name) == 1
    assert paths.count("train.forward/layer") == cfg.n_layers
    # remat recomputes each layer inside the backward (on the CPU autograd
    # runs it on the calling thread, so the span nests there)
    back = [p for p, s in zip(paths, spans)
            if s.name == "layer" and not p.startswith("train.forward")]
    assert len(back) == cfg.n_layers
    main = {s.thread for s in spans if s.name == "train.backward"}
    assert all(p.startswith("train.backward") for p, s in zip(paths, spans)
               if s.name == "layer" and s.thread in main
               and not p.startswith("train.forward"))


def test_flash_attention_backward_records_its_span():
    from repro_torch.models.attention import FlashAttention
    q, k, v = (torch.randn(1, 16, 2, 16, requires_grad=True) for _ in range(3))
    tracing.enable()
    out = FlashAttention.apply(q, k, v, True, 8, 8)
    out.sum().backward()
    spans = tracing.drain()
    assert [s.name for s in spans] == ["attention.backward"]
    assert q.grad is not None


def _store(capacity: int = 256):
    """A two-epoch, three-tier store, a raw remainder among its chunks
    (tier 0 pushes no clause), and clauses ranked by selectivity."""
    recs = generate_records("ycsb", 1200, seed=4)
    pool = predicate_pool("ycsb")
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.25))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:6]), tier_sizes=(0, 2, 6))
    store = CiaoStore(fam0, segment_capacity=capacity)
    eng = NumpyEngine()
    for i, lo in enumerate(range(0, 600, 200)):
        chunk = encode_chunk(recs[lo:lo + 200])
        store.ingest_chunk(chunk, eng.eval_fused_prefix(
            chunk, fam0.plan.clauses, fam0.tier_sizes[i % 3]), tier=i % 3)
    fam1 = evolve_family(fam0, ranked[2:8], (1, 3, 6))
    store.advance_epoch(fam1)
    for i, lo in enumerate(range(600, 1200, 200)):
        chunk = encode_chunk(recs[lo:lo + 200])
        tier = (i + 1) % 3
        store.ingest_chunk(chunk, eng.eval_fused_prefix(
            chunk, fam1.plan.clauses, fam1.tier_sizes[tier]), epoch=1, tier=tier)
    return store, ranked


@pytest.mark.parametrize("which", [0, 3, 9])
def test_batcher_row_counts_equal_the_stores_scan(which):
    """One pass of ``matching_records`` folds, under the recipe tenant,
    the rows and segments the store's own scan of the recipe counts in
    its ``ScanResult`` (a clause pushed everywhere, in one epoch only,
    and in none)."""
    store, ranked = _store()
    recipe = Query((ranked[which],))
    b = RecipeBatcher(store, ByteTokenizer(vocab_size=512), seq_len=16, batch_size=2)
    rows = list(b.matching_records(recipe))
    got = store.telemetry.tenant(RECIPE_TENANT)
    want = DataSkippingScanner(store, log_queries=False, telemetry=False).scan(recipe)
    assert want.count == len(rows)
    for key in ("rows_scanned", "rows_skipped", "segments_scanned", "segments_pruned"):
        assert got[key] == getattr(want, key), key
    assert got["scans"] == 0 and got["latency"]["n"] == 0
    assert got["rows_skipped"] > 0 or which == 9
    list(b.matching_records(recipe))          # a second pass: memoized counts
    again = store.telemetry.tenant(RECIPE_TENANT)
    for key in ("rows_scanned", "rows_skipped", "segments_scanned", "segments_pruned"):
        assert again[key] == 2 * got[key], key


def test_each_batch_is_one_span_on_the_prefetch_thread():
    store, ranked = _store()
    b = RecipeBatcher(store, ByteTokenizer(vocab_size=512), seq_len=32, batch_size=2)
    want = [t for t, _ in zip(b.batches(Query((ranked[0],))), range(5))]
    tracing.enable()
    with Prefetcher(b.batches(Query((ranked[0],))), depth=2) as pf:
        got = [next(pf)[0] for _ in range(5)]
    spans = tracing.drain()
    assert all(np.array_equal(a, w) for a, (w, _) in zip(got, want))
    batches = [s for s in spans if s.name == "data.batch"]
    assert 5 <= len(batches) <= 5 + 3
    assert {s.thread for s in batches} != {threading.get_ident()}
    assert all(s.parent == -1 for s in batches)
