"""The remat policies (``cfg.remat``) against each other and the JAX package.

``"none"``, ``"full"``, ``"dots"`` (save the outputs of matrix products
without batch dims) and ``"save_block_io"`` (save only the block outputs
tagged ``attn_out`` / ``ffn_out``) change what the backward keeps or
recomputes, never the numbers: in f32 on the CPU the loss and every
gradient must be equal under all four in the port, and within the f32
bounds of ``tests/test_torch_train.py`` of the JAX package's under the
same policy, for a dense (qwen3-1.7b), an MoE (llama4-scout, top-1 with a
shared expert) and an encoder-decoder (seamless-m4t) config, reduced.
The policies' own parts: the ``repro_torch::checkpoint_name`` op tags only
inside ``save_block_io``'s layers, and each policy saves what it says.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

POLICIES = ("none", "full", "dots", "save_block_io")
ARCHS = ("qwen3-1.7b", "llama4-scout-17b-a16e", "seamless-m4t-medium")
SHAPE = ShapeConfig("remat", "train", 32, 2)
F32 = {"loss": 1e-5, "grad": 1e-4}        # tests/test_torch_train.py's
_cache: dict = {}


def _ref(arch: str, policy: str):
    """The JAX package's f32 loss and grads under ``policy``."""
    key = (arch, policy)
    if key not in _cache:
        cfg = dataclasses.replace(j_configs.get_config(arch).reduced(),
                                  compute_dtype="float32", remat=policy)
        model = j_build_model(cfg)
        if arch not in _cache:
            _cache[arch], _ = split(model.init(jax.random.PRNGKey(0)))
        values = _cache[arch]
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            values, j_configs.make_batch(cfg, SHAPE))
        _cache[key] = (values, float(loss), grads)
    return _cache[key]


def _port(arch: str, policy: str):
    values, _, _ = _ref(arch, "full")
    cfg = dataclasses.replace(t_configs.get_config(arch).reduced(),
                              compute_dtype="float32", remat=policy)
    params = params_from_reference(jax.tree.map(np.asarray, values), cfg,
                                   "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in t_configs.make_batch(cfg, SHAPE).items()}
    return value_and_grad(build_model(cfg), params, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_policies_equal_each_other(arch):
    """All four policies: the same loss and the same gradients, bit for
    bit (the forward is the same ops; only what is kept differs)."""
    loss0, g0 = _port(arch, "none")
    for policy in POLICIES[1:]:
        loss, g = _port(arch, policy)
        assert torch.equal(loss, loss0), policy
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b), policy


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_matches_reference(arch, policy):
    _, loss, grads = _ref(arch, policy)
    t_loss, t_grads = _port(arch, policy)
    assert abs(float(t_loss) - loss) <= F32["loss"]
    n = 0
    for path, a in jax.tree_util.tree_flatten_with_path(grads)[0]:
        b = t_grads
        for k in path:
            b = b[k.key]
        a = np.asarray(a, np.float32)
        err = np.abs(a - b.float().numpy()).max() / max(np.abs(a).max(),
                                                        1e-30)
        assert err <= F32["grad"], (jax.tree_util.keystr(path), err)
        n += 1
    assert n == len(tree_leaves(t_grads))


def test_checkpoint_name_tags_only_inside_naming():
    x = torch.randn(3, 4, requires_grad=True)
    assert t_layers.checkpoint_name(x, "attn_out") is x
    with t_layers.naming():
        y = t_layers.checkpoint_name(x, "attn_out")
    assert y is not x and torch.equal(y, x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(3, 4))


def _saved_ops(policy: str) -> list:
    """The ops a one-layer selective checkpoint of a dense block keeps for
    the backward under ``policy``."""
    from torch.utils.checkpoint import CheckpointPolicy

    kept = []
    inner = t_tf._policy(policy)

    def spy(ctx, op, *args, **kwargs):
        out = inner(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(str(op) if args[1:2] == () or not isinstance(
                args[1], str) else f"{op}:{args[1]}")
        return out

    cfg = dataclasses.replace(t_configs.get_config("qwen3-1.7b").reduced(),
                              compute_dtype="float32", remat=policy,
                              n_layers=1)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in t_configs.make_batch(cfg, SHAPE).items()}
    orig = t_tf._policy
    t_tf._policy = lambda remat: spy
    try:
        value_and_grad(model, params, batch)
    finally:
        t_tf._policy = orig
    return kept


def test_dots_saves_unbatched_matmuls_only():
    kept = _saved_ops("dots")
    assert kept and all(k.startswith(("aten.mm", "aten.addmm")) for k in kept)


def test_save_block_io_saves_the_named_outputs_only():
    kept = _saved_ops("save_block_io")
    assert sorted(kept) == ["repro_torch.checkpoint_name.default:attn_out",
                            "repro_torch.checkpoint_name.default:ffn_out"]
