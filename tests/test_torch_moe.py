"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package.

Routing: the port's :func:`route` against the reference's arithmetic
(``repro.models.moe.apply_moe``, lines 172-188: f32 softmax, ``top_k``,
gates renormalised with a 1e-9 floor, the token-major one-hot cumsum,
capacity with Python's ``round``, the overflow row), both fed the same
f32 logits: ids, positions, keep, slots and C equal exactly, gates within
1e-6; at the reduced llama4-scout and deepseek-v3 configs, with drops
(capacity_factor 0.5), at decode's T = B = 2 and over a hypothesis sweep
of (T, E, k, capacity_factor).  ``apply_moe``: out and aux within 1e-5 in
f32 (sums in another order) and within the serve tests' bf16 bound
(0.06) in bf16, the JAX package's parameters converted to the port's.
"""
import dataclasses

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
from repro.models import moe as j_moe  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import count  # noqa: E402

MOE_ARCHS = ("llama4-scout-17b-a16e", "deepseek-v3-671b")
F32_TOL = 1e-5
BF16_TOL = 0.06
GATE_TOL = 1e-6


def _ref_route(logits, m):
    """The reference's routing arithmetic (``repro.models.moe.apply_moe``
    lines 172-188) on f32 logits (T, E)."""
    T, E = logits.shape
    k = m.top_k
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    C = int(max(1, round(T * k / E * m.capacity_factor)))
    flat_ids = expert_ids.reshape(-1)
    onehot = jax.nn.one_hot(flat_ids, E, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - 1) * onehot).sum(axis=-1)
    keep = pos < C
    slot = jnp.where(keep, flat_ids * C + pos, E * C)
    return {"ids": expert_ids, "gates": gate_vals, "pos": pos, "keep": keep,
            "slot": slot, "C": C}


def _check_route(logits: np.ndarray, m):
    want = _ref_route(jnp.asarray(logits), m)
    got = t_moe.route(torch.from_numpy(logits), m)
    assert got.C == want["C"]
    for name in ("ids", "pos", "keep", "slot"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(want[name])), name
    assert float(np.abs(got.gates.numpy() - np.asarray(want["gates"])).max()
                 ) <= GATE_TOL
    return got


def _moe_cfg(arch, **moe_kw):
    """(JAX cfg, port cfg) at reduced size, the MoE fields replaced."""
    out = []
    for mod in (j_configs, t_configs):
        cfg = mod.get_config(arch).reduced()
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


def _logits(rng, T, E, spread=1.0):
    return (rng.normal(size=(T, E)) * spread).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_routing_matches_reference(arch, cf):
    _, tcfg = _moe_cfg(arch, capacity_factor=cf)
    rng = np.random.default_rng(len(arch) + int(cf * 4))
    got = _check_route(_logits(rng, 96, tcfg.moe.n_experts, 3.0), tcfg.moe)
    if cf == 0.5:       # the capacity-drop case drops
        assert not got.keep.all()
        E, C = tcfg.moe.n_experts, got.C
        assert (got.slot[~got.keep] == E * C).all()
    kept = got.slot[got.keep]
    assert kept.unique().numel() == kept.numel()      # every kept slot once


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_at_decode_matches_reference(arch):
    """Decode routes T = B tokens: C = max(1, round(B k / E * cf))."""
    _, tcfg = _moe_cfg(arch)
    rng = np.random.default_rng(3)
    got = _check_route(_logits(rng, 2, tcfg.moe.n_experts), tcfg.moe)
    assert got.C == t_moe.capacity(2, tcfg.moe)


def test_capacity_uses_pythons_round():
    """Half to even, as the reference's ``round``: the published decode
    capacities at batch 8 are 1 (llama4: round(0.625); deepseek-v3:
    max(1, round(0.3125)))."""
    for arch in MOE_ARCHS:
        m = t_configs.get_config(arch).moe
        assert t_moe.capacity(8, m) == 1
    m = dataclasses.replace(t_configs.get_config(MOE_ARCHS[0]).moe,
                            n_experts=8, top_k=1, capacity_factor=1.0)
    assert t_moe.capacity(20, m) == 2 and t_moe.capacity(28, m) == 4


@settings(max_examples=40, deadline=None)
@given(T=st.integers(1, 80), E=st.sampled_from([2, 3, 8, 16]),
       k=st.integers(1, 4), cf=st.sampled_from([0.25, 0.5, 1.0, 1.25, 2.0]),
       seed=st.integers(0, 2**16))
def test_routing_sweep_matches_reference(T, E, k, cf, seed):
    m = dataclasses.replace(t_configs.get_config(MOE_ARCHS[1]).moe,
                            n_experts=E, top_k=min(k, E), capacity_factor=cf)
    _check_route(_logits(np.random.default_rng(seed), T, E), m)


_values: dict = {}


def _layer(arch):
    """The reduced config's first MoE layer: JAX values (jnp) and the
    port's tensors (through ``params_from_reference``)."""
    if arch not in _values:
        jcfg = j_configs.get_config(arch).reduced()
        tcfg = t_configs.get_config(arch).reduced()
        values, _ = split(j_moe.init_moe(jax.random.PRNGKey(7), jcfg))
        host = jax.tree.map(np.asarray, values)
        _values[arch] = (values, {k: torch.from_numpy(np.array(v))
                                  for k, v in host.items()})
    return _values[arch]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,cf", [(2, 24, 1.25), (2, 24, 0.5), (2, 1, 1.25)])
def test_apply_moe_matches_reference(arch, dtype, B, S, cf):
    jcfg, tcfg = _moe_cfg(arch, capacity_factor=cf)
    jvals, tvals = _layer(arch)
    rng = np.random.default_rng(B * S + int(cf * 8))
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, want_aux = j_moe.apply_moe(jvals, jx, jcfg)
    got, aux = t_moe.apply_moe(tvals, tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == (B, S, tcfg.d_model)
    err = float(np.abs(got.float().numpy()
                       - np.asarray(want, np.float32)).max())
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert err <= tol, err
    assert abs(float(aux) - float(want_aux)) <= F32_TOL


def test_apply_moe_has_gradients_to_every_leaf():
    _, tcfg = _moe_cfg(MOE_ARCHS[1])
    _, tvals = _layer(MOE_ARCHS[1])
    leaves = {k: v.clone().requires_grad_() for k, v in tvals.items()}
    x = torch.randn(2, 8, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0), requires_grad=True)
    out, aux = t_moe.apply_moe(leaves, x, tcfg)
    grads = torch.autograd.grad(out.square().sum() + aux,
                                [x, *leaves.values()])
    assert all(torch.isfinite(g).all() for g in grads)
    assert grads[0].abs().max() > 0 and leaves["router"] is not None
    assert grads[1 + list(leaves).index("router")].abs().max() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS + ("qwen3-1.7b",))
def test_init_moe_specs_match_reference(arch):
    jcfg = j_configs.get_config(arch).reduced()
    tcfg = t_configs.get_config(arch).reduced()
    if tcfg.moe is None:      # no shared expert where none is configured
        tcfg = dataclasses.replace(tcfg, moe=t_configs.MoEConfig(4, 1, 32))
        jcfg = dataclasses.replace(jcfg, moe=j_configs.base.MoEConfig(4, 1, 32))
    specs = t_moe.init_moe(tcfg)
    values, _ = split(j_moe.init_moe(jax.random.PRNGKey(0), jcfg))
    assert {k: tuple(s.shape) for k, s in specs.items()} == \
        {k: tuple(v.shape) for k, v in values.items()}
    assert specs["router"].scale == 0.02
    assert ("shared_wi" in specs) == bool(tcfg.moe.n_shared_experts)
    assert count(specs) == sum(v.size for v in values.values())


def test_sharded_moe_is_refused_off_a_mesh():
    cfg = t_configs.get_config(MOE_ARCHS[1])
    assert t_moe.moe_sharding_available(cfg) is False
    with pytest.raises(RuntimeError, match="current mesh"):
        t_moe.apply_moe_sharded({}, torch.zeros(1, 1, 4), cfg)


def test_params_from_reference_takes_moe_layouts():
    """The converter checks names and shapes of MoE and MLA layouts."""
    from repro.models.model import build_model as j_build_model
    tcfg = t_configs.get_config(MOE_ARCHS[1]).reduced()
    jcfg = j_configs.get_config(MOE_ARCHS[1]).reduced()
    values, _ = split(j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    host = jax.tree.map(np.asarray, values)
    params = params_from_reference(host, tcfg, "cpu")
    assert params["group1"]["sub0"]["moe"]["wi"].shape == \
        host["group1"]["sub0"]["moe"]["wi"].shape
    host["group1"]["sub0"]["moe"]["router"] = \
        host["group1"]["sub0"]["moe"]["router"][:, :1]
    with pytest.raises(ValueError, match="router"):
        params_from_reference(host, tcfg, "cpu")
    del host["group1"]["sub0"]["moe"]["router"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(host, tcfg, "cpu")
