"""The hybrid (RG-LRU and local attention) and RWKV families on the port,
against the JAX package, on the CPU.

For recurrentgemma-9b (``rec, rec, attn`` layers, local attention with
window 32 at ``.reduced()`` size, MQA) and rwkv6-3b, the JAX package's
parameters (``jax.random``) go through ``params_from_reference``, so both
packages compute with the same numbers, and the inputs are numpy-seeded.
Bounds: the pieces (block-diagonal gates, the causal conv, the RG-LRU
scan, the time-mix and channel-mix with their states, groupnorm) within
1e-5 in f32 (sums in another order); the scan also against a float64
sequential loop, within 1e-5 of max(1, |h|); logits within 1e-4 in f32
(``compute_dtype="float32"``, f32 cache), greedy tokens equal in f32;
the loss and its gradients in f32 as ``tests/test_torch_train.py``'s
(1e-5, and 1e-4 of each leaf's max |g|).  In bf16 the bounds grow with
the logits, which reach 4-5 at these families' reduced size where
qwen3's stay under 1 (a bf16 step at 4 is 2^-5): logits within 0.06 of
max(1, max |logits|), ``tests/test_torch_serve.py``'s 0.06 at unit size;
the loss within 2e-3 and each gradient within 0.1 of its leaf's max |g|,
twice ``tests/test_torch_train.py``'s 1e-3 and 0.05.  For scale, on
these draws the JAX package's own bf16 logits lie 0.05-0.07
(recurrentgemma) and 0.2-1.5 (rwkv6) from its f32 ones, its bf16 loss
up to 1e-3 from its f32 loss and its bf16 gradients up to 0.04 and 0.4
of a leaf's max |g| from its f32 gradients.  The reference's
``tests/test_models_smoke.py`` cases for these archs run on the port.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import rwkv6 as j_rwkv  # noqa: E402
from repro.models import transformer as j_transformer  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402
from repro_torch.models import rwkv6 as t_rwkv  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    greedy_generate, make_serve_fns,
)
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_train_step, value_and_grad,
)

HYBRID, RWKV = "recurrentgemma-9b", "rwkv6-3b"
ARCHS = (HYBRID, RWKV)
F32_TOL = 1e-4
BF16_TOL = 0.06
PART_TOL = 1e-5
LOSS_TOL = {"float32": {"loss": 1e-5, "grad": 1e-4},
            "bfloat16": {"loss": 2e-3, "grad": 0.1}}
SMOKE_SHAPE = ShapeConfig("smoke", "train", 64, 2)
_cache: dict = {}


def _pair(arch: str, dtype: str):
    """(JAX cfg, JAX values, port cfg, port params) at reduced size with
    ``compute_dtype=dtype``, from ``jax.random.PRNGKey(0)``."""
    key = (arch, dtype)
    if key not in _cache:
        jcfg = dataclasses.replace(j_configs.get_config(arch).reduced(),
                                   compute_dtype=dtype)
        tcfg = dataclasses.replace(t_configs.get_config(arch).reduced(),
                                   compute_dtype=dtype)
        if ("values", arch) not in _cache:
            values, _ = split(j_build_model(jcfg).init(jax.random.PRNGKey(0)))
            _cache[("values", arch)] = values
        values = _cache[("values", arch)]
        params = params_from_reference(jax.tree.map(np.asarray, values),
                                       tcfg, "cpu")
        _cache[key] = (jcfg, values, tcfg, params)
    return _cache[key]


def _tokens(cfg, B: int, S: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _np(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))


def _err(a, b) -> float:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


def _layer(arch: str, sub: str, dtype: str = "float32"):
    """(JAX cfg, JAX block, port cfg, port block) of group 0's first
    layer, block ``sub``."""
    jcfg, values, tcfg, params = _pair(arch, dtype)
    jp = jax.tree.map(lambda v: v[0], values["group0"][sub])
    tp = t_transformer._unstack(params["group0"][sub], 1)[0]
    return jcfg, jp, tcfg, tp


def _x(B: int, S: int, d: int, seed: int):
    x = np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# RG-LRU pieces
# ---------------------------------------------------------------------------

def test_block_diag_and_conv_match_jax():
    jcfg, jp, tcfg, tp = _layer(HYBRID, "sub0")
    rec_j, rec_t = jp["rec"], tp["rec"]
    D = tcfg.lru_width
    x, jx, tx = _x(2, 13, D, 31)
    assert _err(t_rglru._block_diag(tx, rec_t["gate_a"], rec_t["gate_a_b"],
                                    tcfg.n_heads),
                j_rglru._block_diag(jx, rec_j["gate_a"], rec_j["gate_a_b"],
                                    jcfg.n_heads)) <= PART_TOL
    tail = np.random.default_rng(32).normal(
        size=(2, tcfg.conv_width - 1, D)).astype(np.float32)
    for t_tail, j_tail in ((None, None),
                           (torch.from_numpy(tail), jnp.asarray(tail))):
        got, got_tail = t_rglru._conv1d_causal(tx, rec_t["conv_w"],
                                               rec_t["conv_b"], t_tail)
        want, want_tail = j_rglru._conv1d_causal(jx, rec_j["conv_w"],
                                                 rec_j["conv_b"], j_tail)
        assert _err(got, want) <= PART_TOL
        assert _err(got_tail, want_tail) == 0.0


def test_rglru_scan_matches_jax():
    jcfg, jp, tcfg, tp = _layer(HYBRID, "sub1")
    x, jx, tx = _x(2, 37, tcfg.lru_width, 33)
    h0 = np.random.default_rng(34).normal(
        size=(2, tcfg.lru_width)).astype(np.float32)
    gy, gh = t_rglru._rglru_scan(tx, tp["rec"], tcfg, torch.from_numpy(h0))
    wy, wh = j_rglru._rglru_scan(jx, jp["rec"], jcfg, jnp.asarray(h0))
    assert gh.dtype == torch.float32 and gy.dtype == torch.float32
    assert _err(gy, wy) <= PART_TOL and _err(gh, wh) <= PART_TOL


def _scan_f64(a, b, h0):
    """h_t = a_t h_{t-1} + b_t, in float64, one step at a time."""
    h, out = h0.astype(np.float64), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, axis=1)


@settings(max_examples=40, deadline=None)
@given(S=st.integers(1, 300), seed=st.integers(0, 10_000),
       h0_scale=st.sampled_from([0.0, 1.0, 100.0]))
def test_prefix_scan_matches_sequential_float64_loop(S, seed, h0_scale):
    """The log-depth scan over the pseudo-step carrying h0, as
    ``_rglru_scan`` runs it, against the sequential recurrence in
    float64: within 1e-5 of max(1, |h|)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, size=(2, S, 3)).astype(np.float32)
    b = rng.normal(size=(2, S, 3)).astype(np.float32)
    h0 = (rng.normal(size=(2, 3)) * h0_scale).astype(np.float32)
    a_ext = torch.cat([torch.ones(2, 1, 3), torch.from_numpy(a)], dim=1)
    b_ext = torch.cat([torch.from_numpy(h0)[:, None], torch.from_numpy(b)],
                      dim=1)
    _, h = t_rglru._prefix_scan(a_ext, b_ext)
    want = _scan_f64(a.astype(np.float64), b.astype(np.float64), h0)
    got = h[:, 1:].double().numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    assert torch.equal(h[:, 0], torch.from_numpy(h0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_chains_its_state_as_jax(dtype):
    """A prompt, then three one-token steps from the returned state: each
    output and state as the JAX package's (f32: 1e-5; bf16: one bf16 step
    of the largest output)."""
    jcfg, jp, tcfg, tp = _layer(HYBRID, "sub0", dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(35).normal(size=(2, 12, tcfg.d_model)).astype(
        np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jstate = j_rglru.init_rglru_state(jcfg, 2, jdt)
    tstate = t_rglru.init_rglru_state(tcfg, 2, tdt)
    for t0, t1 in ((0, 9), (9, 10), (10, 11), (11, 12)):
        want, jstate = j_rglru.rglru_block(jp["rec"], jx[:, t0:t1], jcfg,
                                           state=jstate)
        got, tstate = t_rglru.rglru_block(tp["rec"], tx[:, t0:t1], tcfg,
                                          state=tstate)
        w = _np(want)
        tol = PART_TOL if dtype == "float32" else \
            2.0 ** -7 * np.abs(w).max()
        assert got.dtype == tdt and _err(got, want) <= tol, (t0, t1)
        assert tstate["h"].dtype == torch.float32
        assert _err(tstate["h"], jstate["h"]) <= max(tol, PART_TOL)
        # the tail holds the last inputs of the conv (u = x @ w_rec)
        assert _err(tstate["conv"], jstate["conv"]) <= max(tol, PART_TOL)


def test_lru_lambda_init_draws_griffin_decays():
    """``lam``'s init: a = exp(-8 softplus(lam)) lies in [0.9, 0.999] and
    spreads over it; ``ones`` is ones."""
    spec = {"lam": t_layers.Spec((4096,), "lru_lambda"),
            "one": t_layers.Spec((3, 4), "ones")}
    gen = torch.Generator().manual_seed(0)
    p = t_layers.materialize(spec, gen, "cpu", torch.float32)
    a = torch.exp(-t_layers.LRU_C * torch.nn.functional.softplus(p["lam"]))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert float(a.max() - a.min()) > 0.09
    assert torch.equal(p["one"], torch.ones(3, 4))


# ---------------------------------------------------------------------------
# RWKV pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_heads_matches_jax(dtype):
    rng = np.random.default_rng(36)
    x = (rng.normal(size=(2, 5, 4, 16)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(4, 16)).astype(np.float32)
    bias = rng.normal(size=(4, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_layers.groupnorm_heads(jnp.asarray(x, jdt), jnp.asarray(scale),
                                    jnp.asarray(bias))
    got = t_layers.groupnorm_heads(torch.from_numpy(x).to(tdt),
                                   torch.from_numpy(scale),
                                   torch.from_numpy(bias))
    tol = PART_TOL if dtype == "float32" else 2.0 ** -7 * np.abs(
        _np(want)).max()
    assert got.dtype == tdt and _err(got, want) <= tol


def _rwkv_params():
    """The first rwkv layer of the f32 pair with its zero-init mixing
    parameters replaced by seeded draws (both packages alike), so that
    the token shift and the ddlerp are exercised."""
    jcfg, jp, tcfg, tp = _layer(RWKV, "sub0")
    rng = np.random.default_rng(37)
    jp = jax.tree.map(lambda v: v, jp)
    tp = {k: dict(v) for k, v in tp.items() if isinstance(v, dict)}
    for blk, name in (("tm", "maa_x"), ("tm", "maa_wkvrg"), ("tm", "decay"),
                      ("cm", "maa_k"), ("cm", "maa_r")):
        shape = tuple(tp[blk][name].shape)
        draw = (rng.normal(size=shape) * 0.5).astype(np.float32)
        jp[blk][name] = jnp.asarray(draw)
        tp[blk][name] = torch.from_numpy(draw)
    return jcfg, jp, tcfg, tp


def test_time_mix_and_channel_mix_chain_their_state_as_jax():
    """Both mixes over a prompt, then three one-token steps from the
    returned states: outputs and states within 1e-5 (f32)."""
    jcfg, jp, tcfg, tp = _rwkv_params()
    x, jx, tx = _x(2, 10, tcfg.d_model, 38)
    jst = j_rwkv.init_rwkv_state(jcfg, 2)
    tst = t_rwkv.init_rwkv_state(tcfg, 2)
    for t0, t1 in ((0, 7), (7, 8), (8, 9), (9, 10)):
        jo, js = j_rwkv.time_mix(jp["tm"], jx[:, t0:t1], jcfg, jst)
        to, ts = t_rwkv.time_mix(tp["tm"], tx[:, t0:t1], tcfg, tst)
        assert _err(to, jo) <= PART_TOL * max(1.0, np.abs(_np(jo)).max())
        jc, jcs = j_rwkv.channel_mix(jp["cm"], jx[:, t0:t1], jst)
        tc, tcs = t_rwkv.channel_mix(tp["cm"], tx[:, t0:t1], tst)
        assert _err(tc, jc) <= PART_TOL * max(1.0, np.abs(_np(jc)).max())
        jst, tst = {**js, **jcs}, {**ts, **tcs}
        for name in ("S", "x_tm", "x_cm"):
            assert tst[name].dtype == torch.float32
            assert _err(tst[name], jst[name]) <= PART_TOL * max(
                1.0, np.abs(_np(jst[name])).max()), name


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _bf16_tol(want) -> float:
    return BF16_TOL * max(1.0, float(np.abs(_np(want)).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax_f32(arch):
    jcfg, values, tcfg, params = _pair(arch, "float32")
    toks = _tokens(tcfg, 2, 40, 1)        # 40 > window 32 and the chunk
    want, _ = jax.jit(lambda v, t: j_transformer.forward(v, jcfg, t))(
        values, toks)
    got, aux = t_transformer.forward(params, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert _err(got, want) < F32_TOL


_STATE_NAMES = {"rec": ("h", "conv"), "rwkv": ("S", "x_tm", "x_cm"),
                "attn": ("k", "v", "pos")}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s_alloc", [64, 16])  # linear; the local ring
def test_prefill_and_decode_match_jax_f32(arch, s_alloc):
    """Prefill of 20 tokens, then 6 decode steps (the local layers' ring
    of 16 slots wraps), logits and every cache entry as the JAX
    package's."""
    jcfg, values, tcfg, params = _pair(arch, "float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    S, n_dec = 20, 6
    toks = _tokens(tcfg, 2, S + n_dec, 2)
    jl, jc = jm.prefill(values, {"tokens": toks[:, :S]}, s_alloc=s_alloc,
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                        s_alloc=s_alloc, cache_dtype=torch.float32)
    assert _err(tl, jl) < F32_TOL

    def same_caches():
        for gi, (gt, _) in enumerate(tcfg.layer_groups()):
            for i, bt in enumerate(t_transformer._group_block_types(gt)):
                for name in _STATE_NAMES[bt]:
                    got = tc[f"group{gi}"][f"sub{i}"][name]
                    want = jc[f"group{gi}"][f"sub{i}"][name]
                    assert _err(got.float(), want) < PART_TOL * max(
                        1.0, np.abs(_np(want)).max()), (gi, i, name)

    same_caches()
    if arch == HYBRID:
        ring = tc["group0"]["sub2"]["k"].shape[2]
        assert ring == min(s_alloc, tcfg.window + 128)
    jd = jax.jit(lambda v, c, t, i: jm.decode(v, c, t, i))
    for i in range(n_dec):
        jl, jc = jd(values, jc, toks[:, S + i], jnp.int32(S + i))
        tl, tc2 = tm.decode(params, tc, torch.from_numpy(toks[:, S + i]),
                            S + i)
        assert tc2 is tc                  # updated in place
        assert _err(tl, jl) < F32_TOL, i
    same_caches()


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_f32(arch):
    jcfg, values, tcfg, params = _pair(arch, "float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    B, S, n = 3, 12, 8
    prompts = _tokens(tcfg, B, S, 3)
    fns = make_serve_fns(tm, batch=B, seq_len=S + n,
                         cache_dtype=torch.float32)
    assert fns["s_cross"] == 0
    got = greedy_generate(tm, fns, params, torch.from_numpy(prompts),
                          n_steps=n)
    logits, cache = jm.prefill(values, {"tokens": prompts},
                               s_alloc=fns["s_alloc"], cache_dtype=jnp.float32)
    jd = jax.jit(lambda v, c, t, i: jm.decode(v, c, t, i))
    tok, want = jnp.argmax(logits, axis=-1).astype(jnp.int32), []
    for i in range(n):
        want.append(np.asarray(tok))
        logits, cache = jd(values, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    assert np.array_equal(got.numpy(), np.stack(want, axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(arch):
    jcfg, values, tcfg, params = _pair(arch, "bfloat16")
    toks = _tokens(tcfg, 2, 40, 4)
    want, _ = jax.jit(lambda v, t: j_transformer.forward(v, jcfg, t))(
        values, toks)
    got, _ = t_transformer.forward(params, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < _bf16_tol(want)
    # matrices cast once give the very same logits as a cast at each use;
    # what the JAX package reads in f32 stays as stored
    cast = build_model(tcfg).compute_params(params)
    again, _ = t_transformer.forward(cast, tcfg, torch.from_numpy(toks))
    assert torch.equal(again, got)
    first = cast["group0"]["sub0"]
    kept = (("rec", "lam"),) if arch == HYBRID else (
        ("tm", "decay"), ("tm", "bonus"), ("tm", "ln_x_scale"),
        ("tm", "ln_x_bias"))
    for block, leaf in kept:
        assert first[block][leaf].dtype == torch.float32, leaf
    assert first["mlp" if arch == HYBRID else "cm"]["wk" if arch == RWKV
                                                    else "wi"].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_of_published_configs_match_jax(arch):
    """From shapes alone: the published configs are never built."""
    tm = build_model(t_configs.get_config(arch))
    jm = j_build_model(j_configs.get_config(arch))
    assert tm.param_count() == jm.param_count()
    assert tm.active_param_count() == jm.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_checks_names_and_shapes(arch):
    _, values, tcfg, _ = _pair(arch, "float32")
    host = jax.tree.map(np.asarray, values)
    shapes = t_transformer.param_shapes(tcfg)
    assert jax.tree.map(np.shape, host) == jax.tree.map(
        tuple, shapes, is_leaf=lambda s: isinstance(s, tuple))
    block, name = ("rec", "gate_a") if arch == HYBRID else ("tm", "bonus")
    sub = host["group0"]["sub0"][block]
    sub[name] = sub[name][:, :1]
    with pytest.raises(ValueError, match=name):
        params_from_reference(host, tcfg, "cpu")
    host = jax.tree.map(np.asarray, values)
    del host["group0"]["sub0"][block]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(host, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_the_cpu(arch):
    out = t_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "40", "--gen", "3"])
    assert out["generated"] == 3 and out["device"] == "cpu"
    assert out["tokens_per_s"] > 0


def test_hybrid_layout_is_the_patterns():
    """recurrentgemma's groups: 12 x (rec, rec, attn) + 1 x (rec, rec) in
    the published config, one (rec, rec, attn) layer at reduced size; the
    attention blocks are local, with a ring cache."""
    full = t_configs.get_config(HYBRID)
    assert full.layer_groups() == (("pattern:rec,rec,attn", 12),
                                   ("pattern:rec,rec", 1))
    spec = t_transformer.param_specs(full)
    assert set(spec["group0"][0]) == {"sub0", "sub1", "sub2"}
    assert set(spec["group1"][0]) == {"sub0", "sub1"}
    assert "rec" in spec["group0"][0]["sub1"] and \
        "attn" in spec["group0"][0]["sub2"]
    assert t_transformer.is_local(full, "attn")
    cache = t_transformer.init_cache(
        dataclasses.replace(full.reduced(), n_layers=5), 1, 512,
        torch.float32)
    assert cache["group0"]["sub2"]["k"].shape[2] == 32 + 128
    assert cache["group0"]["sub0"]["h"].dtype == torch.float32
    assert set(cache["group1"]) == {"sub0", "sub1"}


# ---------------------------------------------------------------------------
# the loss and the reference's smoke tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(arch, dtype):
    """``Model.loss`` and every gradient, against the JAX package's."""
    jcfg, values, tcfg, params = _pair(arch, dtype)
    tol = LOSS_TOL[dtype]
    shape = ShapeConfig("smoke", "train", 40, 2)
    jbatch = j_configs.make_batch(jcfg, shape)
    loss, grads = jax.jit(jax.value_and_grad(j_build_model(jcfg).loss))(
        values, jbatch)
    tbatch = {k: torch.from_numpy(v)
              for k, v in t_configs.make_batch(tcfg, shape).items()}
    t_loss, t_grads = value_and_grad(build_model(tcfg), params, tbatch)
    assert abs(float(t_loss) - float(loss)) <= tol["loss"]
    n = 0
    for path, a in jax.tree_util.tree_flatten_with_path(grads)[0]:
        b = t_grads
        for k in path:
            b = b[k.key]
        a = np.asarray(a, np.float32)
        err = np.abs(a - b.float().numpy()).max() / max(np.abs(a).max(),
                                                        1e-30)
        assert err <= tol["grad"], (jax.tree_util.keystr(path), err)
        n += 1
    assert n == len(tree_leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_smoke_forward_loss_finite(arch):
    """``tests/test_models_smoke.py::test_forward_loss_finite`` on the
    port: the random-init CE is near ln(V)."""
    cfg = t_configs.get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in t_configs.make_batch(cfg, SMOKE_SHAPE).items()}
    with torch.no_grad():
        loss = float(model.loss(params, batch))
    assert math.isfinite(loss)
    assert abs(loss - math.log(cfg.vocab_size)) < 2.0


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_smoke_train_step_reduces_loss(arch):
    """``test_train_step_reduces_loss`` on the port: 8 AdamW steps on one
    batch."""
    cfg = t_configs.get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    oc = OptConfig(learning_rate=5e-3, warmup_steps=1, weight_decay=0.0)
    state = opt_mod.init(params, oc)
    step = make_train_step(model, oc, n_micro=1)
    batch = {k: torch.from_numpy(v)
             for k, v in t_configs.make_batch(cfg, SMOKE_SHAPE).items()}
    losses = []
    for _ in range(8):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        assert math.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_smoke_decode_matches_forward(arch):
    """``test_decode_matches_forward`` on the port, in the config's bf16:
    B 2, S 12, within 0.06."""
    cfg = t_configs.get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, 0))
    full, _ = t_transformer.forward(params, cfg, toks)
    _, cache = model.prefill(params, {"tokens": toks[:, :S - 1]}, s_alloc=32,
                             cache_dtype=torch.float32)
    dec, _ = model.decode(params, cache, toks[:, S - 1], S - 1)
    assert _err(full[:, S - 1], dec) < 0.06


def test_reference_smoke_local_attention_window_respected():
    """``test_local_attention_window_respected`` on the port: a decoder
    with local attention (window 8) does not see a token more than the
    window back, and does see a near one; recurrentgemma's forward runs
    on the same tokens."""
    rng = np.random.default_rng(1)
    cfg = t_configs.get_config(HYBRID).reduced()
    t1 = rng.integers(0, cfg.vocab_size, size=(1, 40)).astype(np.int32)
    t2 = t1.copy()
    t2[0, 0] = (t2[0, 0] + 1) % cfg.vocab_size   # perturb a far-past token
    params = build_model(cfg).init(0, device="cpu")
    for t in (t1, t2):
        logits, _ = t_transformer.forward(params, cfg, torch.from_numpy(t))
        assert torch.isfinite(logits.float()).all()
    cfg_q = dataclasses.replace(t_configs.get_config("qwen3-1.7b").reduced(),
                                attention="local", window=8)
    pq = build_model(cfg_q).init(0, device="cpu")
    lq1, _ = t_transformer.forward(pq, cfg_q, torch.from_numpy(t1))
    lq2, _ = t_transformer.forward(pq, cfg_q, torch.from_numpy(t2))
    np.testing.assert_allclose(_np(lq1[0, -1]), _np(lq2[0, -1]), atol=1e-5)
    assert not np.allclose(_np(lq1[0, 1]), _np(lq2[0, 1]), atol=1e-5)


def test_local_decoder_matches_jax_f32():
    """A decoder with local attention (qwen3 reduced, window 8): forward
    and prefill + decode through the ring (12 slots) as the JAX
    package's."""
    jcfg = dataclasses.replace(j_configs.get_config("qwen3-1.7b").reduced(),
                               attention="local", window=8,
                               compute_dtype="float32")
    tcfg = dataclasses.replace(t_configs.get_config("qwen3-1.7b").reduced(),
                               attention="local", window=8,
                               compute_dtype="float32")
    values, _ = split(j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_reference(jax.tree.map(np.asarray, values), tcfg,
                                   "cpu")
    toks = _tokens(tcfg, 2, 30, 5)
    want, _ = jax.jit(lambda v, t: j_transformer.forward(v, jcfg, t))(
        values, toks)
    got, _ = t_transformer.forward(params, tcfg, torch.from_numpy(toks))
    assert _err(got, want) < F32_TOL
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jl, jc = jm.prefill(values, {"tokens": toks[:, :20]}, s_alloc=12,
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :20])},
                        s_alloc=12, cache_dtype=torch.float32)
    assert _err(tl, jl) < F32_TOL
    for i in range(20, 30):
        jl, jc = jm.decode(values, jc, toks[:, i], jnp.int32(i))
        tl, _ = tm.decode(params, tc, torch.from_numpy(toks[:, i]), i)
        assert _err(tl, jl) < F32_TOL, i
