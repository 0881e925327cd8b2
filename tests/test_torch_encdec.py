"""The encoder-decoder family (seamless-m4t-medium) on the port, against
the JAX package, on the CPU.

The JAX package's parameters (``jax.random``) go through
``params_from_reference``, so both packages compute with the same
numbers; frames and tokens are numpy-seeded.  Bounds, as
``tests/test_torch_serve.py``'s and ``tests/test_torch_train.py``'s:
the pieces (cross attention, the encoder's memory) within 1e-5 in f32
(sums in another order) and one bf16 step of the largest output in bf16;
logits within 1e-4 in f32 (``compute_dtype="float32"``, f32 cache),
greedy tokens equal in f32, logits within 0.06 in the config's bf16; the
loss and its gradients within 1e-5 and 1e-4 of each leaf's max |g| in
f32, 1e-3 and 0.05 in bf16.  The reference's ``tests/test_models_smoke.py``
cases for this arch run on the port.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import make_serve_fns  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_train_step, value_and_grad,
)

ARCH = "seamless-m4t-medium"
F32_TOL = 1e-4
BF16_TOL = 0.06
PART_TOL = 1e-5
LOSS_TOL = {"float32": {"loss": 1e-5, "grad": 1e-4},
            "bfloat16": {"loss": 1e-3, "grad": 0.05}}
SMOKE_SHAPE = ShapeConfig("smoke", "train", 64, 2)
_cache: dict = {}


def _pair(dtype: str):
    """(JAX cfg, JAX values, port cfg, port params) at reduced size with
    ``compute_dtype=dtype``, from ``jax.random.PRNGKey(0)``."""
    if dtype not in _cache:
        jcfg = dataclasses.replace(j_configs.get_config(ARCH).reduced(),
                                   compute_dtype=dtype)
        tcfg = dataclasses.replace(t_configs.get_config(ARCH).reduced(),
                                   compute_dtype=dtype)
        if "values" not in _cache:
            values, _ = split(j_build_model(jcfg).init(jax.random.PRNGKey(0)))
            _cache["values"] = values
        values = _cache["values"]
        params = params_from_reference(jax.tree.map(np.asarray, values),
                                       tcfg, "cpu")
        _cache[dtype] = (jcfg, values, tcfg, params)
    return _cache[dtype]


def _inputs(cfg, B: int, S_src: int, S: int, seed: int):
    """(frames, tokens) as numpy arrays."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, S_src, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return frames, toks


def _np(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))


def _err(a, b) -> float:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_cross_matches_jax(dtype):
    """Cross attention, Sq 19 against Sk 45 (several chunks each side)."""
    jcfg, values, tcfg, params = _pair(dtype)
    jp = jax.tree.map(lambda v: v[0], values["dec"]["cross_attn"])
    tp = t_transformer._unstack(params["dec"], tcfg.dec_layers)[0][
        "cross_attn"]
    rng = np.random.default_rng(41)
    x = rng.normal(size=(2, 19, tcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 45, tcfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_attn.attend_cross(jp, jnp.asarray(x, jdt), jnp.asarray(mem, jdt),
                               jcfg)
    got = t_attn.attend_cross(tp, torch.from_numpy(x).to(tdt),
                              torch.from_numpy(mem).to(tdt), tcfg)
    tol = PART_TOL if dtype == "float32" else 2.0 ** -7 * np.abs(
        _np(want)).max()
    assert got.dtype == tdt and _err(got, want) <= tol


def test_encode_matches_jax_f32():
    jcfg, values, tcfg, params = _pair("float32")
    frames, _ = _inputs(tcfg, 2, 45, 1, 42)
    want = jax.jit(lambda v, f: j_encdec.encode(v, jcfg, f))(values, frames)
    got = t_encdec.encode(params, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, 45, tcfg.d_model)
    assert _err(got, want) <= PART_TOL * max(1.0, np.abs(_np(want)).max())


def test_card_route_takes_cross_and_encoder_attention():
    """On ``meta`` tensors (the card's route up to the launch) the
    encoder's unmasked self-attention and the Sq != Sk cross attention
    reach kernel F's wrapper, which refuses the meta device itself."""
    q = torch.empty(2, 19, 4, 64, device="meta")
    kv = torch.empty(2, 45, 4, 64, device="meta")
    for k, mode in ((q, "none"), (kv, "none"), (q, "causal")):
        with pytest.raises(ValueError, match="unsupported device meta"):
            t_attn.flash_attention(
                q, k, k, q_positions=torch.arange(19),
                k_positions=torch.arange(k.shape[1]), mask_mode=mode)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax_f32():
    jcfg, values, tcfg, params = _pair("float32")
    frames, toks = _inputs(tcfg, 2, 45, 40, 1)
    want, _ = jax.jit(lambda v, f, t: j_encdec.forward(v, jcfg, f, t))(
        values, frames, toks)
    got, aux = t_encdec.forward(params, tcfg, *_t(frames, toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (2, 40, tcfg.vocab_size)
    assert _err(got, want) < F32_TOL


@pytest.mark.parametrize("s_alloc", [64, 24])
def test_prefill_and_decode_match_jax_f32(s_alloc):
    """Prefill (45 frames, 20 target tokens), then decode steps up to the
    cache's end (``dynamic_update_slice`` clamps past it): logits and
    every cache entry, ``xk``/``xv`` included, as the JAX package's."""
    jcfg, values, tcfg, params = _pair("float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    S, n_dec = 20, 6
    frames, toks = _inputs(tcfg, 2, 45, S + n_dec, 2)
    jl, jc = jm.prefill(values, {"frames": frames, "tokens": toks[:, :S]},
                        s_alloc=s_alloc, cache_dtype=jnp.float32)
    tl, tc = tm.prefill(params, dict(zip(("frames", "tokens"),
                                         _t(frames, toks[:, :S]))),
                        s_alloc=s_alloc, cache_dtype=torch.float32)
    assert _err(tl, jl) < F32_TOL
    assert tc["xk"].shape == (tcfg.dec_layers, 2, 45, tcfg.n_kv_heads,
                              tcfg.hd())

    def same_caches():
        for name in ("k", "v", "pos", "xk", "xv"):
            assert _err(tc[name].float(), jc[name]) < PART_TOL * max(
                1.0, np.abs(_np(jc[name])).max()), name

    same_caches()
    jd = jax.jit(lambda v, c, t, i: jm.decode(v, c, t, i))
    for i in range(n_dec):
        jl, jc = jd(values, jc, toks[:, S + i], jnp.int32(S + i))
        tl, tc2 = tm.decode(params, tc, torch.from_numpy(toks[:, S + i]),
                            S + i)
        assert tc2 is tc                  # updated in place
        assert _err(tl, jl) < F32_TOL, i
    same_caches()


def test_greedy_tokens_match_jax_f32():
    """``make_serve_fns`` with frames: prefill, then 8 greedy steps; the
    tokens equal the JAX package's."""
    jcfg, values, tcfg, params = _pair("float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    B, S, n = 3, 12, 8
    frames, prompts = _inputs(tcfg, B, 30, S, 3)
    fns = make_serve_fns(tm, batch=B, seq_len=S + n,
                         cache_dtype=torch.float32)
    assert fns["s_cross"] == 4096
    logits, cache = fns["prefill"](params, dict(zip(
        ("frames", "tokens"), _t(frames, prompts))))
    tok, got = torch.argmax(logits, dim=-1).to(torch.int32), []
    for i in range(n):
        got.append(tok)
        logits, cache = fns["decode"](params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    jl, jc = jm.prefill(values, {"frames": frames, "tokens": prompts},
                        s_alloc=fns["s_alloc"], cache_dtype=jnp.float32)
    jd = jax.jit(lambda v, c, t, i: jm.decode(v, c, t, i))
    jtok, want = jnp.argmax(jl, axis=-1).astype(jnp.int32), []
    for i in range(n):
        want.append(np.asarray(jtok))
        jl, jc = jd(values, jc, jtok, jnp.int32(S + i))
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    assert np.array_equal(torch.stack(got, dim=1).numpy(),
                          np.stack(want, axis=1))


def test_forward_bf16_matches_jax():
    jcfg, values, tcfg, params = _pair("bfloat16")
    frames, toks = _inputs(tcfg, 2, 45, 40, 4)
    want, _ = jax.jit(lambda v, f, t: j_encdec.forward(v, jcfg, f, t))(
        values, frames, toks)
    got, _ = t_encdec.forward(params, tcfg, *_t(frames, toks))
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < BF16_TOL
    # matrices cast once give the very same logits as a cast at each use;
    # the norms stay as stored
    cast = build_model(tcfg).compute_params(params)
    again, _ = t_encdec.forward(cast, tcfg, *_t(frames, toks))
    assert torch.equal(again, got)
    assert cast["dec"]["ln_x"].dtype == cast["ln_enc"].dtype == torch.float32
    assert cast["dec"]["cross_attn"]["wq"].dtype == torch.bfloat16


def test_param_counts_of_published_config_match_jax():
    """From shapes alone: the published config is never built."""
    tm = build_model(t_configs.get_config(ARCH))
    jm = j_build_model(j_configs.get_config(ARCH))
    assert tm.param_count() == jm.param_count()
    assert tm.active_param_count() == jm.active_param_count()


def test_params_from_reference_checks_names_and_shapes():
    _, values, tcfg, _ = _pair("float32")
    host = jax.tree.map(np.asarray, values)
    shapes = t_encdec.param_shapes(tcfg)
    assert jax.tree.map(np.shape, host) == jax.tree.map(
        tuple, shapes, is_leaf=lambda s: isinstance(s, tuple))
    host["dec"]["cross_attn"]["wk"] = host["dec"]["cross_attn"]["wk"][:, :1]
    with pytest.raises(ValueError, match="cross_attn/wk"):
        params_from_reference(host, tcfg, "cpu")
    host = jax.tree.map(np.asarray, values)
    del host["ln_enc"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(host, tcfg, "cpu")


def test_init_and_init_cache_layout():
    cfg = t_configs.get_config(ARCH).reduced()
    model = build_model(cfg)
    p = model.init(0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p) == \
        t_encdec.param_shapes(cfg)
    assert not p["ln_enc"].any() and not p["dec"]["ln_x"].any()
    cache = model.init_cache(2, 40, s_cross=16, cache_dtype=torch.float32,
                             device="cpu")
    assert cache["k"].shape == (cfg.dec_layers, 2, 40, cfg.n_kv_heads,
                                cfg.hd())
    assert cache["xv"].shape == (cfg.dec_layers, 2, 16, cfg.n_kv_heads,
                                 cfg.hd())
    assert (cache["pos"] == -1).all()


# ---------------------------------------------------------------------------
# the loss and the reference's smoke tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """``Model.loss`` (frames in, next-token CE on the decoder) and every
    gradient, against the JAX package's."""
    jcfg, values, tcfg, params = _pair(dtype)
    tol = LOSS_TOL[dtype]
    shape = ShapeConfig("smoke", "train", 48, 2)
    jbatch = j_configs.make_batch(jcfg, shape)
    loss, grads = jax.jit(jax.value_and_grad(j_build_model(jcfg).loss))(
        values, jbatch)
    tbatch = {k: torch.from_numpy(v)
              for k, v in t_configs.make_batch(tcfg, shape).items()}
    assert set(tbatch) == {"frames", "tokens", "loss_mask"}
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


def test_loss_takes_an_attention_function():
    """``Model.loss(attention=...)`` reaches every attention of the
    encoder-decoder, as the decoders' does (``chip_smoke.py`` holds F's
    gradient route against the plain version through it): the encoder's,
    the decoder's self and cross calls each pass through it once a
    forward, and the plain version gives the default's loss and grads
    (on the CPU the default is the plain version)."""
    _, _, tcfg, params = _pair("float32")
    batch = {k: torch.from_numpy(v) for k, v in t_configs.make_batch(
        tcfg, ShapeConfig("smoke", "train", 48, 2)).items()}
    calls = []

    def counting(q, k, v, **kw):
        calls.append((kw["mask_mode"], q.shape[1], k.shape[1]))
        return t_attn.flash_attention_plain(q, k, v, **kw)

    model = build_model(dataclasses.replace(tcfg, remat="none"))
    loss, grads = value_and_grad(model, params, batch)
    loss_a, grads_a = value_and_grad(model, params, batch,
                                     attention=counting)
    assert float(loss_a) == float(loss)
    for a, b in zip(tree_leaves(grads_a), tree_leaves(grads)):
        assert torch.equal(a, b)
    S = batch["tokens"].shape[1]
    S_src = batch["frames"].shape[1]
    assert calls == [("none", S_src, S_src)] * tcfg.enc_layers + [
        ("causal", S, S), ("none", S, S_src)] * tcfg.dec_layers


def _smoke_batch(cfg):
    return {k: torch.from_numpy(v)
            for k, v in t_configs.make_batch(cfg, SMOKE_SHAPE).items()}


def test_reference_smoke_forward_loss_finite():
    """``tests/test_models_smoke.py::test_forward_loss_finite`` on the
    port: the random-init CE is near ln(V)."""
    cfg = t_configs.get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with torch.no_grad():
        loss = float(model.loss(params, _smoke_batch(cfg)))
    assert math.isfinite(loss)
    assert abs(loss - math.log(cfg.vocab_size)) < 2.0


def test_reference_smoke_train_step_reduces_loss():
    """``test_train_step_reduces_loss`` on the port: 8 AdamW steps on one
    batch."""
    cfg = t_configs.get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    oc = OptConfig(learning_rate=5e-3, warmup_steps=1, weight_decay=0.0)
    state = opt_mod.init(params, oc)
    step = make_train_step(model, oc, n_micro=1)
    batch = _smoke_batch(cfg)
    losses = []
    for _ in range(8):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        assert math.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


def test_reference_smoke_decode_matches_forward():
    """``test_decode_matches_forward`` on the port, in the config's bf16:
    B 2, 8 frames, S 12, within 0.06."""
    cfg = t_configs.get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    B, S = 2, 12
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = rng.normal(size=(B, 8, cfg.d_model)).astype(np.float32)
    full, _ = t_encdec.forward(params, cfg, *_t(frames, toks))
    _, cache = model.prefill(params, dict(zip(
        ("frames", "tokens"), _t(frames, toks[:, :S - 1]))), s_alloc=32,
        cache_dtype=torch.float32)
    dec, _ = model.decode(params, cache, torch.from_numpy(toks[:, S - 1]),
                          S - 1)
    assert _err(full[:, S - 1], dec) < 0.06
