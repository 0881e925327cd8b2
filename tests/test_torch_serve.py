"""The port's serving path against the JAX package, on the CPU.

For each dense full-attention arch at ``.reduced()`` size, the JAX
package's parameters (from ``jax.random``) go through
``params_from_reference``, so both packages compute with the same
numbers.  Tolerances: 1e-4 on logits in f32 (``compute_dtype="float32"``,
f32 cache: the two packages sum in another order, logits are of unit
size); 0.06 in the configs' own bf16, the JAX package's own bound for
decode against forward (``tests/test_models_smoke.py``); greedy tokens
equal in f32.  Also: configs equal field for field, parameter counts
equal, the serve entry point's dict on the CPU, and the refusal of a
family or attention that no config has.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro import configs as j_configs  # noqa: E402
from repro.models import transformer as j_transformer  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    greedy_generate, make_serve_fns,
)

DENSE = ("qwen3-1.7b", "qwen3-8b", "qwen1.5-4b", "deepseek-7b")
F32_TOL = 1e-4
BF16_TOL = 0.06
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


def _err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax_f32(arch):
    jcfg, values, tcfg, params = _pair(arch, "float32")
    toks = _tokens(tcfg, 2, 40, 1)        # 40 > the reduced 32-row chunk
    want, _ = jax.jit(lambda v, t: j_transformer.forward(v, jcfg, t))(
        values, toks)
    got, aux = t_transformer.forward(params, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert _err(got, want) < F32_TOL


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("s_alloc", [32, 16])      # linear, ring-aligned
def test_prefill_and_decode_match_jax_f32(arch, s_alloc):
    jcfg, values, tcfg, params = _pair(arch, "float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    S, n_dec = 20, 4
    toks = _tokens(tcfg, 2, S + n_dec, 2)
    jl, jc = jm.prefill(values, {"tokens": toks[:, :S]}, s_alloc=s_alloc,
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                        s_alloc=s_alloc, cache_dtype=torch.float32)
    assert _err(tl, jl) < F32_TOL
    jd = jax.jit(lambda v, c, t, i: jm.decode(v, c, t, i))
    for i in range(n_dec):
        jl, jc = jd(values, jc, toks[:, S + i], jnp.int32(S + i))
        tl, tc2 = tm.decode(params, tc, torch.from_numpy(toks[:, S + i]),
                            S + i)
        assert tc2 is tc                  # updated in place
        assert _err(tl, jl) < F32_TOL, i
    for name in ("k", "v", "pos"):
        assert _err(tc["group0"]["sub0"][name].to(torch.float32),
                    jc["group0"]["sub0"][name]) < F32_TOL


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_match_jax_f32(arch):
    jcfg, values, tcfg, params = _pair(arch, "float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    B, S, n = 3, 12, 8
    prompts = _tokens(tcfg, B, S, 3)
    fns = make_serve_fns(tm, batch=B, seq_len=S + n,
                         cache_dtype=torch.float32)
    got = greedy_generate(tm, fns, params, torch.from_numpy(prompts),
                          n_steps=n)
    s_alloc = fns["s_alloc"]
    logits, cache = jm.prefill(values, {"tokens": prompts}, s_alloc=s_alloc,
                               cache_dtype=jnp.float32)
    jd = jax.jit(lambda v, c, t, i: jm.decode(v, c, t, i))
    tok, want = jnp.argmax(logits, axis=-1).astype(jnp.int32), []
    for i in range(n):
        want.append(np.asarray(tok))
        logits, cache = jd(values, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.stack(want, axis=1))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_bf16_matches_jax(arch):
    jcfg, values, tcfg, params = _pair(arch, "bfloat16")
    toks = _tokens(tcfg, 2, 40, 4)
    want, _ = jax.jit(lambda v, t: j_transformer.forward(v, jcfg, t))(
        values, toks)
    got, _ = t_transformer.forward(params, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < BF16_TOL
    # matrices cast once give the very same logits as a cast at each use
    cast = build_model(tcfg).compute_params(params)
    assert cast["group0"]["sub0"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["group0"]["sub0"]["ln1"].dtype == torch.float32
    again, _ = t_transformer.forward(cast, tcfg, torch.from_numpy(toks))
    assert torch.equal(again, got)


@pytest.mark.parametrize("arch", j_configs.list_archs())
def test_configs_equal_jax(arch):
    assert t_configs.list_archs() == j_configs.list_archs()
    full_t, full_j = t_configs.get_config(arch), j_configs.get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(full_t.reduced()) == \
        dataclasses.asdict(full_j.reduced())
    assert full_t.layer_groups() == full_j.layer_groups()
    assert t_configs.cache_alloc_len(672) == j_configs.cache_alloc_len(672)


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_jax(arch):
    got = build_model(t_configs.get_config(arch)).param_count()
    assert got == j_build_model(j_configs.get_config(arch)).param_count()
    if arch == "qwen3-1.7b":
        assert abs(got - 1.7e9) / 1.7e9 < 0.06


def test_params_from_reference_checks_names_and_shapes():
    _, values, tcfg, _ = _pair("qwen3-1.7b", "float32")
    host = jax.tree.map(np.asarray, values)
    del host["ln_f"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(host, tcfg, "cpu")
    host = jax.tree.map(np.asarray, values)
    host["group0"]["sub0"]["attn"]["wq"] = host["group0"]["sub0"]["attn"][
        "wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        params_from_reference(host, tcfg, "cpu")


def test_init_draws_mk_distributions():
    cfg = t_configs.get_config("qwen3-1.7b").reduced()
    p = build_model(cfg).init(0, device="cpu")
    shapes = t_transformer.param_shapes(cfg)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    attn = p["group0"]["sub0"]["attn"]
    d, H, hd = attn["wq"].shape[1:]
    assert abs(float(attn["wq"].std()) - (d * H) ** -0.5) < 0.1 * (d * H) ** -0.5
    assert abs(float(p["embed"]["tok"].std()) - 0.02) < 0.002
    assert not attn["q_norm"].any() and not p["ln_f"].any()
    again = build_model(cfg).init(0, device="cpu")
    assert torch.equal(again["embed"]["tok"], p["embed"]["tok"])


def test_serve_main_on_the_cpu():
    out = t_serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert out["batch"] == 2 and out["generated"] == 3
    assert out["device"] == "cpu" and out["prefill_calls"] == 2
    for k in ("tokens_per_s", "wall_s", "prefill_ms", "decode_ms_per_step"):
        assert out[k] > 0, k
    # a mesh of 2 ranks needs a process group of 2 (tests/test_torch_dist.py
    # serves on one); this process has none
    with pytest.raises(RuntimeError, match="mesh"):
        t_serve.main(["--reduced", "--device", "cpu", "--mesh-shape", "2,1"])


@pytest.mark.parametrize("field,value", [("family", "moe_only"),
                                         ("attention", "linear")])
def test_family_or_attention_no_config_has_raises(field, value):
    """Every family and attention of the configs is ported (the hybrid,
    rwkv and encdec families: tests/test_torch_recurrent.py and
    tests/test_torch_encdec.py); one that no config has is refused."""
    cfg = dataclasses.replace(t_configs.get_config("qwen3-1.7b").reduced(),
                              **{field: value})
    with pytest.raises(NotImplementedError, match=repr(value)):
        build_model(cfg)
    for arch in t_configs.list_archs():
        build_model(t_configs.get_config(arch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_and_attend_full_match_jax(dtype):
    """rmsnorm, apply_rope, apply_mlp and attend_full against the JAX
    package.  f32: 1e-5 (another summation order); bf16: one bf16 step
    (2**-7 relative) of the largest output."""
    from repro.models import attention as j_attn
    from repro.models import layers as j_layers
    from repro_torch.models import attention as t_attn
    from repro_torch.models import layers as t_layers

    jcfg, values, tcfg, params = _pair("qwen3-1.7b", dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    pos = np.arange(24, dtype=np.int32) + 5
    jp = jax.tree.map(lambda v: v[0], values["group0"]["sub0"])
    tp = t_transformer._unstack(params["group0"]["sub0"], tcfg.n_layers)[0]

    def check(got, want):
        w = np.asarray(jnp.asarray(want, jnp.float32))
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(w).max()
        assert got.dtype == tdt
        assert _err(got, want) <= tol

    check(t_layers.rmsnorm(tx, tp["ln1"], tcfg.norm_eps),
          j_layers.rmsnorm(jx, jp["ln1"], jcfg.norm_eps))
    heads = x.reshape(2, 24, 4, -1)
    check(t_layers.apply_rope(torch.from_numpy(heads).to(tdt),
                              torch.from_numpy(pos), tcfg.rope_theta),
          j_layers.apply_rope(jnp.asarray(heads, jdt), jnp.asarray(pos),
                              jcfg.rope_theta))
    check(t_layers.apply_mlp(tp["mlp"], tx, tcfg.act),
          j_layers.apply_mlp(jp["mlp"], jx, jcfg.act))
    check(t_attn.attend_full(tp["attn"], tx, tcfg, torch.from_numpy(pos)),
          j_attn.attend_full(jp["attn"], jx, jcfg, jnp.asarray(pos)))
