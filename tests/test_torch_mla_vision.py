"""MoE, MLA and the vision frontend on the port's model, against the JAX
package, on the CPU.

For llama4-scout-17b-a16e (MoE), deepseek-v3-671b (MLA; dense then MoE
layers) and internvl2-76b (1,024 patch embeddings prepended, 8 at
``.reduced()`` size), the JAX package's parameters (``jax.random``) go
through ``params_from_reference``, so both packages compute with the same
numbers, and the inputs are numpy-seeded.  Bounds, as
``tests/test_torch_serve.py``'s: logits within 1e-4 in f32
(``compute_dtype="float32"``, f32 cache; sums in another order), greedy
tokens equal in f32, 0.06 in the configs' bf16; MLA's pieces within
1e-5 in f32 (the absorbed decode's unnormalised partial sums within 1e-5
of max(1, their size)); the loss and its gradients as
``tests/test_torch_train.py``'s (f32: 1e-5 and 1e-4 of each leaf's max
|g|; bf16: 1e-3 and 0.05).  The reference's
``tests/test_models_smoke.py`` cases for these archs run on the port.
Kernel F's domain on a card (v at its own head dim where F has an
instance for the pair, and every other mismatch refused) is held on
``meta`` tensors, which take the card's route up to the launch; F with a
gradient on MLA's unpadded v is held to the zero-padded route it
replaced.
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
from repro.models import transformer as j_transformer  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    rope_tables, tree_leaves,
)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    greedy_generate, make_serve_fns,
)
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_train_step, value_and_grad,
)

ARCHS = ("llama4-scout-17b-a16e", "deepseek-v3-671b", "internvl2-76b")
MLA = "deepseek-v3-671b"
VLM = "internvl2-76b"
F32_TOL = 1e-4
BF16_TOL = 0.06
PART_TOL = 1e-5
LOSS_TOL = {"float32": {"loss": 1e-5, "grad": 1e-4},
            "bfloat16": {"loss": 1e-3, "grad": 0.05}}
SMOKE_SHAPE = ShapeConfig("smoke", "train", 64, 2)
_cache: dict = {}


def _pair(arch: str, dtype: str, **kw):
    """(JAX cfg, JAX values, port cfg, port params) at reduced size with
    ``compute_dtype=dtype`` (and ``kw``), from ``jax.random.PRNGKey(0)``."""
    key = (arch, dtype, tuple(sorted(kw.items())))
    if key not in _cache:
        jcfg = dataclasses.replace(j_configs.get_config(arch).reduced(),
                                   compute_dtype=dtype, **kw)
        tcfg = dataclasses.replace(t_configs.get_config(arch).reduced(),
                                   compute_dtype=dtype, **kw)
        if ("values", arch) not in _cache:
            values, _ = split(j_build_model(jcfg).init(jax.random.PRNGKey(0)))
            _cache[("values", arch)] = values
        values = _cache[("values", arch)]
        params = params_from_reference(jax.tree.map(np.asarray, values),
                                       tcfg, "cpu")
        _cache[key] = (jcfg, values, tcfg, params)
    return _cache[key]


def _no_drop(cfg):
    """capacity_factor 16, as the reference's decode test sets it: decode
    routes B tokens at a time and the forward B * S."""
    return {} if cfg.moe is None else {"moe": dataclasses.replace(
        cfg.moe, capacity_factor=16.0)}


def _tokens(cfg, B: int, S: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _embeds(cfg, B: int, seed: int):
    """(numpy, torch) patch embeddings for the vision frontend, or None."""
    if cfg.frontend != "vision":
        return None, None
    rng = np.random.default_rng(seed + 100)
    e = rng.normal(size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return e, torch.from_numpy(e)


def _err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# MLA pieces and kernel F's padded route
# ---------------------------------------------------------------------------

def _mla_layer():
    jcfg, values, tcfg, params = _pair(MLA, "float32")
    jp = jax.tree.map(lambda v: v[0], values["group0"]["sub0"]["attn"])
    tp = t_transformer._unstack(params["group0"]["sub0"], 1)[0]["attn"]
    return jcfg, jp, tcfg, tp


def test_mla_qkv_and_attend_match_jax():
    jcfg, jp, tcfg, tp = _mla_layer()
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 40, tcfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    want = j_attn._mla_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    rope = rope_tables(torch.from_numpy(pos), t_attn.rope_dim(tcfg),
                       tcfg.rope_theta)
    got = t_attn._mla_qkv(tp, torch.from_numpy(x), tcfg, rope)
    for g, w in zip(got, want):
        assert _err(g, w) <= PART_TOL
    assert got.k_rope.shape == (2, 40, 1, tcfg.mla.qk_rope_head_dim)
    out = t_attn.attend_mla(tp, torch.from_numpy(x), tcfg,
                            torch.from_numpy(pos))
    assert _err(out, j_attn.attend_mla(jp, jnp.asarray(x), jcfg,
                                       jnp.asarray(pos))) <= PART_TOL


@pytest.mark.parametrize("n_empty", [0, 5])
def test_decode_attention_mla_matches_jax(n_empty):
    jcfg, jp, tcfg, tp = _mla_layer()
    m = tcfg.mla
    rng = np.random.default_rng(22 + n_empty)
    B, H, S = 2, tcfg.n_heads, 24
    qn = rng.normal(size=(B, H, m.qk_nope_head_dim)).astype(np.float32)
    qr = rng.normal(size=(B, H, m.qk_rope_head_dim)).astype(np.float32)
    ckv = rng.normal(size=(B, S, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, S, m.qk_rope_head_dim)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    if n_empty:
        pos[-n_empty:] = -1
    scale = t_attn.mla_scale(tcfg)
    want = j_attn.decode_attention_mla(
        *(jnp.asarray(a) for a in (qn, qr, ckv, kr, pos)), jp["wkv_b"],
        nope_dim=m.qk_nope_head_dim, scale=scale)
    got = t_attn.decode_attention_mla(
        *(torch.from_numpy(a) for a in (qn, qr, ckv, kr, pos)), tp["wkv_b"],
        nope_dim=m.qk_nope_head_dim, scale=scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _err(g, w) <= PART_TOL * max(1.0, float(np.abs(w).max()))
    assert _err(t_attn.combine_partials(got),
                j_attn.combine_partials(want, None)) <= PART_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_padded_v_through_plain_f_equals_unpadded_attention(causal):
    """MLA's shapes (qk 192, v 128): F's plain version on v zero-padded to
    192 gives the unpadded attention in its first 128 columns (1e-6) and
    exactly 0 in the others; on v as it is, F gives those 128 columns."""
    rng = np.random.default_rng(23)
    B, S, H = 1, 40, 2
    q, k = (torch.from_numpy(rng.normal(size=(B, S, H, 192)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(B, S, H, 128)).astype(np.float32))
    out = t_attn.run_flash_kernel(q, k, t_attn.pad_head_dim(v, 192),
                                  causal=causal)
    assert out.shape == (B, S, H, 192)
    assert torch.equal(t_attn.run_flash_kernel(q, k, v, causal=causal),
                       out[..., :128])
    assert torch.equal(out[..., 128:], torch.zeros_like(out[..., 128:]))
    pos = torch.arange(S)
    want = t_attn.flash_attention_plain(
        q, k, v, q_positions=pos, k_positions=pos,
        mask_mode="causal" if causal else "none", scale=192 ** -0.5)
    assert _err(out[..., :128], want) <= 1e-6
    assert torch.equal(t_attn.pad_head_dim(v, 128), v)


@pytest.mark.parametrize("vd,scale,ok", [
    (128, None, True), (128, 192 ** -0.5, True), (192, None, True),
    (128, 0.1, False), (256, None, False),
])
def test_card_route_pads_v_and_refuses_other_mismatches(vd, scale, ok):
    """On a non-CPU tensor (``meta``: the card's route up to the launch),
    v head dims up to qk's at the default scale reach kernel F's wrapper
    unpadded (which refuses the meta device itself), with the local band
    too; other dims or scales raise ``NotImplementedError``."""
    B, S, H = 1, 8, 2
    q = torch.empty(B, S, H, 192, device="meta")
    v = torch.empty(B, S, H, vd, device="meta")
    pos = torch.arange(S, dtype=torch.int32)
    call = dict(q_positions=pos, k_positions=pos, mask_mode="causal",
                scale=scale)
    if ok:
        with pytest.raises(ValueError, match="unsupported device meta"):
            t_attn.flash_attention(q, q, v, **call)
    else:
        with pytest.raises(NotImplementedError, match="head dim"):
            t_attn.flash_attention(q, q, v, **call)
    local = {**call, "mask_mode": "local", "window": 4}
    if ok:
        with pytest.raises(ValueError, match="unsupported device meta"):
            t_attn.flash_attention(q, q, v, **local)
    else:
        with pytest.raises(NotImplementedError, match="head dim"):
            t_attn.flash_attention(q, q, v, **local)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_on_unpadded_v_matches_the_padded_route(causal):
    """``FlashAttention.apply`` (F with a gradient) on MLA's v at 128: the
    output and dq, dk and dv equal the route that zero-padded v to 192
    (the output and v's gradient cut back to 128), f32 on the CPU."""
    rng = np.random.default_rng(31)
    B, S, H = 1, 40, 2
    base = [torch.from_numpy(rng.normal(size=(B, S, H, d)).astype(
        np.float32)) for d in (192, 192, 128)]
    a = [t.clone().requires_grad_() for t in base]
    b = [t.clone().requires_grad_() for t in base]
    out = t_attn.FlashAttention.apply(*a, causal, 16, 16)
    padded = t_attn.FlashAttention.apply(
        b[0], b[1], t_attn.pad_head_dim(b[2], 192), causal, 16, 16)
    assert out.shape == (B, S, H, 128)
    assert torch.equal(out, padded[..., :128])
    g = torch.from_numpy(rng.normal(size=(B, S, H, 128)).astype(np.float32))
    got = torch.autograd.grad(out, a, g)
    want = torch.autograd.grad(padded[..., :128], b, g)
    assert got[2].shape == (B, S, H, 128)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_flash_wrapper_takes_head_dim_192():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    assert 192 in fa.HEAD_DIMS and 256 in fa.HEAD_DIMS
    rng = np.random.default_rng(24)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 70, 192)).astype(
        np.float32)) for _ in range(3))
    assert torch.equal(fa.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax_f32(arch):
    jcfg, values, tcfg, params = _pair(arch, "float32")
    toks = _tokens(tcfg, 2, 40, 1)        # 40 > the reduced 32-row chunk
    je, te = _embeds(tcfg, 2, 1)
    want, want_aux = jax.jit(lambda v, t, e: j_transformer.forward(
        v, jcfg, t, extra_embeds=e))(values, toks, je)
    got, aux = t_transformer.forward(params, tcfg, torch.from_numpy(toks),
                                     extra_embeds=te)
    assert got.dtype == torch.float32
    assert got.shape[1] == 40 + tcfg.frontend_len
    assert _err(got, want) < F32_TOL
    assert abs(float(aux) - float(want_aux)) < 1e-6
    assert (float(aux) > 0) == (tcfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s_alloc", [64, 16])      # linear, ring-aligned
def test_prefill_and_decode_match_jax_f32(arch, s_alloc):
    jcfg, values, tcfg, params = _pair(arch, "float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    S, n_dec = 20, 4
    toks = _tokens(tcfg, 2, S + n_dec, 2)
    je, te = _embeds(tcfg, 2, 2)
    F = tcfg.frontend_len
    jl, jc = jm.prefill(values, {"tokens": toks[:, :S], "extra_embeds": je},
                        s_alloc=s_alloc, cache_dtype=jnp.float32)
    tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]),
                                 "extra_embeds": te},
                        s_alloc=s_alloc, cache_dtype=torch.float32)
    assert _err(tl, jl) < F32_TOL
    # the cache after the prefill (MLA: compressed ckv / krope)
    names = ("ckv", "krope", "pos") if tcfg.attention == "mla" else \
        ("k", "v", "pos")
    for gi in range(len(tcfg.layer_groups())):
        for name in names:
            assert _err(tc[f"group{gi}"]["sub0"][name].float(),
                        jc[f"group{gi}"]["sub0"][name]) < PART_TOL, name
    jd = jax.jit(lambda v, c, t, i: jm.decode(v, c, t, i))
    for i in range(n_dec):
        jl, jc = jd(values, jc, toks[:, S + i], jnp.int32(F + S + i))
        tl, tc2 = tm.decode(params, tc, torch.from_numpy(toks[:, S + i]),
                            F + S + i)
        assert tc2 is tc                  # updated in place
        assert _err(tl, jl) < F32_TOL, i


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_f32(arch):
    jcfg, values, tcfg, params = _pair(arch, "float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    B, S, n = 3, 12, 8
    prompts = _tokens(tcfg, B, S, 3)
    fns = make_serve_fns(tm, batch=B, seq_len=S + n,
                         cache_dtype=torch.float32)
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
    je, te = _embeds(tcfg, 2, 4)
    want, _ = jax.jit(lambda v, t, e: j_transformer.forward(
        v, jcfg, t, extra_embeds=e))(values, toks, je)
    got, _ = t_transformer.forward(params, tcfg, torch.from_numpy(toks),
                                   extra_embeds=te)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < BF16_TOL
    # matrices cast once give the very same logits as a cast at each use;
    # the router, MLA's wkv_b and every norm stay as stored
    cast = build_model(tcfg).compute_params(params)
    again, _ = t_transformer.forward(cast, tcfg, torch.from_numpy(toks),
                                     extra_embeds=te)
    assert torch.equal(again, got)
    last = cast[f"group{len(tcfg.layer_groups()) - 1}"]["sub0"]
    for block, leaf in (("moe", "router"), ("attn", "wkv_b"),
                        ("attn", "kv_norm")):
        if leaf in last.get(block, {}):
            assert last[block][leaf].dtype == torch.float32, leaf
    assert last["attn"]["wo"].dtype == torch.bfloat16


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
    sub = host["group0"]["sub0"]["attn"]
    name = "wkv_b" if tcfg.attention == "mla" else "wq"
    sub[name] = sub[name][:, :1]
    with pytest.raises(ValueError, match=name):
        params_from_reference(host, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_the_cpu(arch):
    out = t_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert out["generated"] == 3 and out["device"] == "cpu"
    assert out["tokens_per_s"] > 0


# ---------------------------------------------------------------------------
# the loss and the reference's smoke tests
# ---------------------------------------------------------------------------

def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(arch, dtype):
    """``Model.loss`` (the MoE aux loss included, the vision frontend's
    positions cut off) and every gradient."""
    jcfg, values, tcfg, params = _pair(arch, dtype)
    tol = LOSS_TOL[dtype]
    shape = ShapeConfig("smoke", "train", 32 + tcfg.frontend_len, 2)
    jbatch = j_configs.make_batch(jcfg, shape)
    loss, grads = jax.jit(jax.value_and_grad(j_build_model(jcfg).loss))(
        values, jbatch)
    tbatch = {k: torch.from_numpy(v)
              for k, v in t_configs.make_batch(tcfg, shape).items()}
    assert ("extra_embeds" in tbatch) == (arch == VLM)
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
    capacity_factor 16, B 2, S 12, within 0.06."""
    cfg = t_configs.get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, **_no_drop(cfg))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, 0))
    full, _ = t_transformer.forward(params, cfg, toks)
    _, cache = model.prefill(params, {"tokens": toks[:, :S - 1]}, s_alloc=32,
                             cache_dtype=torch.float32)
    dec, _ = model.decode(params, cache, toks[:, S - 1], S - 1)
    assert _err(full[:, S - 1], dec) < 0.06


def test_vision_loss_cuts_off_the_frontend():
    """The loss reads only the token positions: the same tokens behind
    other patch embeddings give another loss, and a batch without them is
    the text-only model's."""
    cfg = t_configs.get_config(VLM).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    shape = ShapeConfig("smoke", "train", 24 + cfg.frontend_len, 2)
    batch = {k: torch.from_numpy(v)
             for k, v in t_configs.make_batch(cfg, shape).items()}
    assert batch["extra_embeds"].shape == (2, cfg.frontend_len, cfg.d_model)
    with torch.no_grad():
        with_img = float(model.loss(params, batch))
        other = float(model.loss(params, {**batch, "extra_embeds":
                                          batch["extra_embeds"] * -1.0}))
        text = float(model.loss(params, {k: v for k, v in batch.items()
                                         if k != "extra_embeds"}))
    assert with_img != other and math.isfinite(text) and text != with_img
