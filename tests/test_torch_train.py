"""The port's training plane against the JAX package, on the CPU.

The first part runs the JAX package's ``tests/test_train.py`` on the port
(``repro_torch.train``, ``Model.loss``, ``repro_torch.launch.train`` with
``--device cpu``, attention through ``flash_attention_plain``), each test
also held against the JAX package on the same numpy-seeded inputs.  The
JAX package's parameters (``jax.random.PRNGKey(0)``) reach the port
through ``params_from_reference``, its optimizer states through
``opt_state_from_reference``.

Bounds: ``make_batch``, ``quantize_int8`` and checkpoint arrays bit for
bit; the schedule within 1e-7; AdamW and adafactor updates from the same
params, grads and state within 1e-6 (f32 math in another order); in f32
compute (``compute_dtype="float32"``) the loss within 1e-5 and every
gradient within 1e-4 of its leaf's max |g| (sums in another order); in
the configs' own bf16, the loss within 1e-3 and each gradient within 0.05
of its leaf's max |g| (the flash-attention tests' bf16 bound: a few bf16
steps, as XLA rounds and fuses elsewhere than eager PyTorch).  A train
step is held as two parts, never through its post-step parameters: at
AdamW's first step m̂/√v̂ is about sign(g), so a gradient near zero that
differs by rounding flips a whole ±lr update.  (a) Its loss, grad norm
and clipped grads against the JAX package's; (b) the port's optimizer
applied to the JAX package's own grads against the JAX update.
"""
import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train.train_step import (  # noqa: E402
    make_train_step as j_make_train_step, quantize_int8 as j_quantize_int8,
)
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_reference, params_from_reference,
)
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    dequantize_int8, make_train_step, quantize_int8, value_and_grad,
)

SHAPE = ShapeConfig("smoke", "train", 64, 4)
ARCH = "qwen3-1.7b"
F32 = {"loss": 1e-5, "grad": 1e-4}
BF16 = {"loss": 1e-3, "grad": 0.05}
OPT_TOL = 1e-6
_cache: dict = {}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref(dtype: str):
    """The JAX package's reduced qwen3-1.7b in ``dtype`` compute: cfg,
    model, values, batch, and its loss and grads on the batch."""
    if dtype not in _cache:
        cfg = dataclasses.replace(j_configs.get_config(ARCH).reduced(),
                                  compute_dtype=dtype)
        model = j_build_model(cfg)
        if "values" not in _cache:
            _cache["values"], _ = split(model.init(jax.random.PRNGKey(0)))
        values = _cache["values"]
        batch = j_configs.make_batch(cfg, SHAPE)
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(values, batch)
        _cache[dtype] = (cfg, model, values, batch, float(loss), grads)
    return _cache[dtype]


def _port(dtype: str):
    """The port's counterpart of :func:`_ref`: cfg, model, params (the JAX
    package's values), batch (tensors)."""
    cfg = dataclasses.replace(t_configs.get_config(ARCH).reduced(),
                              compute_dtype=dtype)
    _, _, values, batch, _, _ = _ref(dtype)
    return (cfg, build_model(cfg), params_from_reference(_host(values), cfg,
                                                         "cpu"),
            _torch_batch(t_configs.make_batch(cfg, SHAPE)))


@pytest.fixture(scope="module")
def setup():
    """As ``tests/test_train.py``'s: the reduced config in its own bf16."""
    cfg, model, params, batch = _port("bfloat16")
    return cfg, model, params, batch


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _rel_errs(jtree, ttree) -> dict:
    """Max |a - b| over max |a| for every leaf of the JAX tree."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        a = np.asarray(a, np.float32)
        b = _leaf(ttree, path).float().numpy()
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
    return out


def _abs_err(jtree, ttree) -> float:
    return max(float(np.abs(np.asarray(a, np.float32)
                            - _leaf(ttree, path).float().numpy()).max())
               for path, a in jax.tree_util.tree_flatten_with_path(jtree)[0])


# ---------------------------------------------------------------------------
# tests/test_train.py on the port
# ---------------------------------------------------------------------------

def test_schedule_warmup_and_decay():
    oc = OptConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    steps = (1, 5, 10, 50, 100)
    lrs = [float(opt_mod.schedule(oc, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] == pytest.approx(1e-3, rel=1e-5)
    assert lrs[3] < lrs[2] and lrs[4] < lrs[3]
    assert lrs[4] >= 1e-4 * 0.99  # min_lr_frac floor
    j_oc = j_opt.OptConfig(learning_rate=1e-3, warmup_steps=10,
                           total_steps=100)
    want = [float(j_opt.schedule(j_oc, jnp.int32(s))) for s in steps]
    assert np.abs(np.array(lrs) - np.array(want)).max() <= 1e-7


def test_adamw_moves_params_and_clips(setup):
    cfg, model, values, batch = setup
    oc = OptConfig(grad_clip=1e-6)  # absurdly small clip
    p0 = _clone(values)
    state = opt_mod.init(p0, oc)
    p2, s2, m = make_train_step(model, oc)(p0, state, batch)
    assert float(m["grad_norm"]) > 0
    # clip bound: update magnitude limited
    diffs = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(values), tree_leaves(p2))]
    assert max(diffs) < 1.0
    # the JAX package's step on the same values and batch
    _, j_model, j_values, j_batch, _, _ = _ref("bfloat16")
    j_oc = j_opt.OptConfig(grad_clip=1e-6)
    _, _, jm = jax.jit(j_make_train_step(j_model, j_oc))(
        j_values, j_opt.init(j_values, j_oc), j_batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= BF16["loss"]
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
        <= BF16["grad"] * float(jm["grad_norm"])
    assert int(s2["step"]) == int(jm["step"]) == 1
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), abs=1e-7)


def test_microbatch_equivalence(setup):
    """n_micro=1 vs n_micro=4 must give (nearly) identical updates."""
    cfg, model, values, batch = setup
    oc = OptConfig(learning_rate=1e-3, weight_decay=0.0)
    p1, p4 = _clone(values), _clone(values)
    s1, s4 = opt_mod.init(p1, oc), opt_mod.init(p4, oc)
    p1, _, m1 = make_train_step(model, oc, n_micro=1)(p1, s1, batch)
    p4, _, m4 = make_train_step(model, oc, n_micro=4)(p4, s4, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(p1), tree_leaves(p4)))
    assert err < 5e-3, err
    # both losses are the JAX package's loss of the whole batch
    loss = _ref("bfloat16")[4]
    assert abs(float(m4["loss"]) - loss) <= BF16["loss"]


def test_adafactor_runs(setup):
    cfg, model, values, batch = setup
    oc = OptConfig(kind="adafactor", learning_rate=1e-3)
    p = _clone(values)
    state = opt_mod.init(p, oc)
    p2, s2, m = make_train_step(model, oc)(p, state, batch)
    assert np.isfinite(float(m["loss"]))
    # factored states are smaller than params
    n_v = sum(x.numel() for x in tree_leaves(s2["f"]))
    n_p = sum(x.numel() for x in tree_leaves(values))
    assert n_v < 0.6 * n_p
    # the same factored shapes as the JAX package's state
    j_state = j_opt.init(_ref("bfloat16")[2], j_opt.OptConfig(
        kind="adafactor"))
    assert [list(x.shape) for x in jax.tree.leaves(j_state["f"])] == \
        [list(x.shape) for x in tree_leaves(s2["f"])]


def test_int8_quantization_error_feedback():
    g = torch.tensor([1.0, -0.5, 0.003, 100.0])
    q, s = quantize_int8(g)
    d = dequantize_int8(q, s)
    assert float((g - d).abs().max()) <= float(s) * 0.5 + 1e-6
    # error feedback: residual accumulates what quantization lost
    resid = g - d
    q2, s2 = quantize_int8(g + resid)
    d2 = dequantize_int8(q2, s2)
    assert float(((g + resid) - d2).abs().max()) <= float(s2) * 0.5 + 1e-6
    jq, js = j_quantize_int8(jnp.asarray(g.numpy()))
    assert np.array_equal(np.asarray(jq), q.numpy())
    assert np.float32(js) == s.numpy()


def test_compressed_training_converges(setup):
    cfg, model, values, batch = setup
    oc = OptConfig(learning_rate=5e-3, weight_decay=0.0, warmup_steps=1)
    params = _clone(values)
    state = opt_mod.init(params, oc)
    step = make_train_step(model, oc, compress=True)
    losses = []
    for _ in range(8):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert "ef" in state  # error-feedback buffer present
    # the first step's loss is the JAX package's
    assert abs(losses[0] - _ref("bfloat16")[4]) <= BF16["loss"]


# ---- checkpointing

def test_checkpoint_roundtrip(tmp_path, setup):
    cfg, model, values, batch = setup
    oc = OptConfig()
    state = opt_mod.init(values, oc)
    d = str(tmp_path)
    ckpt.save(d, (values, state), step=7)
    assert ckpt.latest_step(d) == 7
    (v2, s2), manifest = ckpt.restore(d, 7, (values, state), device="cpu")
    assert manifest["step"] == 7
    for a, b in zip(tree_leaves(values), tree_leaves(v2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # named and ordered as the JAX package names the same tree
    j_values = _ref("bfloat16")[2]
    want, _ = zip(*jax.tree_util.tree_flatten_with_path(
        (j_values, j_opt.init(j_values, j_opt.OptConfig())))[0])
    assert manifest["paths"] == ["/".join(str(k) for k in p) for p in want]


def test_checkpoint_ignores_partial_writes(tmp_path, setup):
    cfg, model, values, batch = setup
    d = str(tmp_path)
    ckpt.save(d, values, step=3)
    # simulate a crashed write: directory without DONE
    os.makedirs(os.path.join(d, "step_00000009"))
    assert ckpt.latest_step(d) == 3
    assert j_ckpt.latest_step(d) == 3


def test_async_checkpointer(tmp_path, setup):
    cfg, model, values, batch = setup
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        w.save(values, step=s)
    w.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    # gc kept only 2
    steps = [n for n in os.listdir(str(tmp_path)) if n.startswith("step_")]
    assert len(steps) == 2
    # the JAX package restores what the port's writer wrote
    j_values = _ref("bfloat16")[2]
    got, _ = j_ckpt.restore(str(tmp_path), 3, j_values)
    for a, b in zip(jax.tree.leaves(j_values), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


TRAIN_ARGS = [
    "--arch", ARCH, "--reduced", "--dataset", "ycsb",
    "--steps", "10", "--batch", "2", "--seq", "64",
    "--ckpt-every", "2", "--n-clients", "2",
    "--chunks-per-client", "2", "--chunk-records", "64", "--log-every", "5",
]


def test_train_crash_and_resume(tmp_path):
    """Fault injection: run crashes at step 6, restart resumes and finishes."""
    d = str(tmp_path / "run")
    args = TRAIN_ARGS + ["--ckpt-dir", d, "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        train_mod.main(args + ["--fail-at-step", "6"])
    assert exc.value.code == 42
    resumed_from = ckpt.latest_step(d)
    assert resumed_from is not None and 2 <= resumed_from <= 6
    res = train_mod.main(args)  # auto-resume
    # async writer may still land step 6 between our read and the resume
    assert 10 - 6 <= res["steps_run"] <= 10 - 2
    assert res["last_loss"] is not None
    assert ckpt.latest_step(d) == 10
    # the same CIAO data as the JAX package's trainer: plan, store, batches
    ns = argparse.Namespace(
        dataset="ycsb", seed=0, n_queries=20, budget_us=1.0,
        chunk_records=64, straggler=False, n_clients=2, chunks_per_client=2,
        seq=64, batch=2)
    cfg = t_configs.get_config(ARCH).reduced()
    j_rep, j_store, _, j_recipe, j_batcher = j_train.build_data(
        ns, cfg.vocab_size)
    rep, store, _, recipe, batcher = train_mod.build_data(ns, cfg.vocab_size)
    assert res["loading_ratio"] == j_store.stats.loading_ratio \
        == store.stats.loading_ratio
    assert rep.selection.describe() == j_rep.selection.describe()
    for (a, am), (b, bm), _ in zip(batcher.batches(recipe),
                                   j_batcher.batches(j_recipe), range(3)):
        assert np.array_equal(a, b) and np.array_equal(am, bm)


# ---------------------------------------------------------------------------
# held against the JAX package, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [
    ("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
    ("qwen3-1.7b", "decode_32k"), ("seamless-m4t-medium", "train_4k"),
    ("seamless-m4t-medium", "prefill_32k"), ("internvl2-76b", "train_4k"),
    ("internvl2-76b", "prefill_32k"),
])
def test_make_batch_bit_equal(arch, shape):
    jcfg = j_configs.get_config(arch).reduced()
    tcfg = t_configs.get_config(arch).reduced()
    small = dataclasses.replace(j_configs.SHAPES[shape], seq_len=64,
                                global_batch=2)
    j_spec = j_configs.input_specs(jcfg, small)
    t_spec = t_configs.input_specs(tcfg, small)
    assert list(j_spec) == list(t_spec)
    for k, (shp, dt) in t_spec.items():
        assert tuple(j_spec[k].shape) == shp
        assert str(j_spec[k].dtype) == str(dt).removeprefix("torch.")
    for seed in (0, 3):
        want = j_configs.make_batch(jcfg, small, seed=seed)
        got = t_configs.make_batch(tcfg, small, seed=seed)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("warmup,total", [(100, 10000), (10, 100), (0, 1)])
def test_schedule_matches_jax(warmup, total):
    oc = OptConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    j_oc = j_opt.OptConfig(learning_rate=3e-4, warmup_steps=warmup,
                           total_steps=total)
    for s in (0, 1, 2, 7, 50, 99, 100, 101, 5000, 9999, 10000, 20000):
        got = float(opt_mod.schedule(oc, torch.tensor(s, dtype=torch.int32)))
        want = float(j_opt.schedule(j_oc, jnp.int32(s)))
        assert abs(got - want) <= 1e-7, (s, got, want)


def _random_tree(rng, shapes):
    return {k: (_random_tree(rng, v) if isinstance(v, dict) else
                rng.normal(size=v).astype(np.float32))
            for k, v in shapes.items()}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(kind):
    """Three updates from the same params, grads and state (numpy)."""
    rng = np.random.default_rng(7)
    shapes = {"w": (3, 5, 8), "b": (8,), "n": {"m": (4, 6), "s": (2,)},
              "z": ()}
    params = _random_tree(rng, shapes)
    j_oc = j_opt.OptConfig(kind=kind, learning_rate=1e-2, warmup_steps=2)
    oc = OptConfig(kind=kind, learning_rate=1e-2, warmup_steps=2)
    j_p = jax.tree.map(jnp.asarray, params)
    j_s = j_opt.init(j_p, j_oc)
    t_p = tree_map(torch.from_numpy, _random_tree(
        np.random.default_rng(7), shapes))
    t_s = opt_mod.init(t_p, oc)
    for _ in range(3):
        grads = _random_tree(rng, shapes)
        grads["b"][0] = 0.0
        j_p, j_s, j_lr = j_opt.update(j_p, jax.tree.map(jnp.asarray, grads),
                                      j_s, j_oc)
        t_p, t_s, t_lr = opt_mod.update(
            t_p, tree_map(torch.from_numpy, grads), t_s, oc)
        assert _abs_err(j_p, t_p) <= OPT_TOL
        assert abs(float(j_lr) - float(t_lr)) <= 1e-9
        assert int(t_s["step"]) == int(j_s["step"])
        moments = ("m", "v") if kind == "adamw" else ("f",)
        for k in moments:
            assert _abs_err(j_s[k], t_s[k]) <= OPT_TOL, k


def test_optimizer_in_pieces_matches_jax(monkeypatch):
    """Large leaves run the global norm and adafactor's update in pieces
    (``optimizer.PIECE`` elements; a deepseek-v3 expert stack would
    otherwise need 15 GB f32 temporaries): with PIECE lowered to 8, a
    (3, 5, 8) leaf runs as three matrices and its norm in 8-element
    pieces, and three clipped adafactor updates still equal the JAX
    package's within 1e-6."""
    monkeypatch.setattr(opt_mod, "PIECE", 8)
    rng = np.random.default_rng(11)
    shapes = {"w": (3, 5, 8), "b": (8,), "m": (4, 6)}
    params = _random_tree(rng, shapes)
    j_oc = j_opt.OptConfig(kind="adafactor", learning_rate=1e-2,
                           warmup_steps=2)
    oc = OptConfig(kind="adafactor", learning_rate=1e-2, warmup_steps=2)
    j_p = jax.tree.map(jnp.asarray, params)
    j_s = j_opt.init(j_p, j_oc)
    t_p = tree_map(torch.from_numpy, _random_tree(
        np.random.default_rng(11), shapes))
    t_s = opt_mod.init(t_p, oc)
    for _ in range(3):
        grads = _random_tree(rng, shapes)
        j_g, j_norm = j_opt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, grads), 0.5)
        t_g, t_norm = opt_mod.clip_by_global_norm(
            tree_map(torch.from_numpy, grads), 0.5)
        assert abs(float(t_norm) - float(j_norm)) <= OPT_TOL * float(j_norm)
        assert _abs_err(j_g, t_g) <= OPT_TOL
        j_p, j_s, _ = j_opt.update(j_p, j_g, j_s, j_oc)
        t_p, t_s, _ = opt_mod.update(t_p, t_g, t_s, oc)
        assert _abs_err(j_p, t_p) <= OPT_TOL
        assert _abs_err(j_s["f"], t_s["f"]) <= OPT_TOL


@pytest.mark.parametrize("seed", range(4))
def test_quantize_int8_bit_equal(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=4096) * 10.0 ** rng.uniform(-4, 4)).astype(
        np.float32)
    g[:64] = np.round(g[:64] * 2) / 2      # ties of round-half-to-even
    if seed == 3:
        g[:] = 0.0                         # the 1e-12 floor of the scale
    q, s = quantize_int8(torch.from_numpy(g))
    jq, js = j_quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    assert np.array_equal(np.asarray(jq), q.numpy())
    assert np.float32(js).tobytes() == s.numpy().tobytes()


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_loss_and_grads_match_jax(dtype, tol):
    _, _, _, _, loss, grads = _ref(dtype)
    cfg, model, params, batch = _port(dtype)
    t_loss, t_grads = value_and_grad(model, params, batch)
    assert abs(float(t_loss) - loss) <= tol["loss"]
    errs = _rel_errs(grads, t_grads)
    assert len(errs) == len(tree_leaves(params))
    assert max(errs.values()) <= tol["grad"], errs
    # every leaf has a gradient, the attention's included
    for name in ("wq", "wk", "wv", "q_norm", "k_norm"):
        g = t_grads["group0"]["sub0"]["attn"][name]
        assert torch.isfinite(g).all() and g.abs().max() > 0, name


def test_train_step_parts_match_jax():
    """(a) loss, grad norm and clipped grads; (b) the port's AdamW on the
    JAX package's own grads against the JAX update (f32 compute)."""
    jcfg, j_model, j_values, j_batch, loss, grads = _ref("float32")
    cfg, model, params, batch = _port("float32")
    oc, j_oc = OptConfig(grad_clip=0.5), j_opt.OptConfig(grad_clip=0.5)
    # (a) the step's first half, as make_train_step runs it
    j_clipped, j_norm = j_opt.clip_by_global_norm(grads, 0.5)
    t_loss, t_grads = value_and_grad(model, params, batch)
    t_clipped, t_norm = opt_mod.clip_by_global_norm(t_grads, 0.5)
    assert float(j_norm) > 0.5          # the clip is active
    assert abs(float(t_norm) - float(j_norm)) <= F32["grad"] * float(j_norm)
    assert max(_rel_errs(j_clipped, t_clipped).values()) <= F32["grad"]
    # the step's metrics agree with the JAX package's step
    p = _clone(params)
    _, _, m = make_train_step(model, oc)(p, opt_mod.init(p, oc), batch)
    _, _, jm = jax.jit(j_make_train_step(j_model, j_oc))(
        j_values, j_opt.init(j_values, j_oc), j_batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= F32["loss"]
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
        <= F32["grad"] * float(jm["grad_norm"])
    # (b) the update from the JAX package's clipped grads
    j_p, j_s, _ = j_opt.update(j_values, j_clipped,
                               j_opt.init(j_values, j_oc), j_oc)
    p = _clone(params)
    t_p, t_s, _ = opt_mod.update(
        p, params_from_reference(_host(j_clipped), cfg, "cpu"),
        opt_mod.init(p, oc), oc)
    assert _abs_err(j_p, t_p) <= OPT_TOL
    assert _abs_err(j_s["m"], t_s["m"]) <= OPT_TOL
    assert _abs_err(j_s["v"], t_s["v"]) <= OPT_TOL


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(tmp_path, kind, writer):
    cfg = t_configs.get_config(ARCH).reduced()
    j_values = _ref("bfloat16")[2]
    j_oc = j_opt.OptConfig(kind=kind)
    j_state = j_opt.update(j_values, jax.tree.map(jnp.ones_like, j_values),
                           j_opt.init(j_values, j_oc), j_oc)[1]
    params = params_from_reference(_host(j_values), cfg, "cpu")
    state = opt_state_from_reference(_host(j_state), cfg, "cpu")
    d = str(tmp_path)
    if writer == "jax":
        j_ckpt.save(d, (j_values, j_state), step=5, extra={"k": 1})
        (tp, ts), manifest = ckpt.restore(d, 5, (params, state),
                                          device="cpu")
        got = jax.tree.leaves((j_values, j_state))
        mine = tree_leaves({"a": tp, "b": ts})
    else:
        ckpt.save(d, (params, state), step=5, extra={"k": 1})
        (jp, js), manifest = j_ckpt.restore(d, 5, (j_values, j_state))
        got = jax.tree.leaves((jp, js))
        mine = tree_leaves({"a": params, "b": state})
    j_paths = ["/".join(str(k) for k in p) for p, _ in
               jax.tree_util.tree_flatten_with_path((j_values, j_state))[0]]
    assert manifest["paths"] == j_paths and manifest["extra"] == {"k": 1}
    assert len(got) == len(mine)
    for a, b in zip(got, mine):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(a, b.numpy())


def test_flash_attention_function_grads_on_cpu():
    """Kernel F's autograd Function on the CPU, where its wrapper runs F's
    plain version: the output is the plain version's, and the gradients
    equal autograd through ``flash_attention_plain`` bit for bit."""
    rng = np.random.default_rng(11)
    B, S, H, Hkv, d = 2, 48, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, d)).astype(
        np.float32)) for h in (H, Hkv, Hkv))
    g = torch.from_numpy(rng.normal(size=(B, S, H, d)).astype(np.float32))
    for causal in (True, False):
        qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
        out = t_attn.FlashAttention.apply(qa, ka, va, causal, 32, 16)
        got = torch.autograd.grad(out, (qa, ka, va), g)
        qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
        pos = torch.arange(S)
        want_out = t_attn.flash_attention_plain(
            qb, kb, vb, q_positions=pos, k_positions=pos,
            mask_mode="causal" if causal else "none", q_chunk=32, k_chunk=16)
        want = torch.autograd.grad(want_out, (qb, kb, vb), g)
        assert out.grad_fn is not None
        assert torch.allclose(out, want_out, atol=2e-5, rtol=0)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_model_forward_honours_remat():
    """'full' (checkpointed layers), 'none' and the selective policies
    'dots' and 'save_block_io' give the same loss and grads (more in
    tests/test_torch_remat.py)."""
    cfg, model, params, batch = _port("float32")
    l_full, g_full = value_and_grad(model, params, batch)
    for policy in ("none", "dots", "save_block_io"):
        m = build_model(dataclasses.replace(cfg, remat=policy))
        l_p, g_p = value_and_grad(m, params, batch)
        assert torch.equal(l_full, l_p), policy
        for a, b in zip(tree_leaves(g_full), tree_leaves(g_p)):
            assert torch.equal(a, b), policy


def test_refusals_of_what_is_not_ported(monkeypatch):
    cfg, model, params, batch = _port("float32")
    # grad_specs off a mesh: plain grads are left as they are
    specs = tree_map(lambda p: (), params)
    p0 = tree_map(torch.clone, params)
    opt = OptConfig()
    _, _, m_spec = make_train_step(model, opt, grad_specs=specs)(
        p0, opt_mod.init(p0, opt), batch)
    p1 = tree_map(torch.clone, params)
    _, _, m_none = make_train_step(model, opt)(p1, opt_mod.init(p1, opt),
                                               batch)
    assert torch.equal(m_spec["loss"], m_none["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p0),
                                                 tree_leaves(p1)))
    # a mesh of 2 ranks needs a process group of 2 (tests/test_torch_dist.py
    # trains on one); this process has none
    with pytest.raises(RuntimeError, match="mesh"):
        train_mod.main(["--reduced", "--mesh-shape", "2,1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference(_host(_ref("float32")[2]), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore("unused", 0, params)
    from repro_torch.benchmarks import bench_train
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_train.main(["--arch", ARCH, "--steps", "1"])


def test_tokenizer_at_full_vocab_matches_jax():
    """The recipe batches' tokens at qwen3-1.7b's vocab (151,936 ids:
    65,536 byte pairs), where the port builds its pair table once."""
    from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
    from repro_torch.data.datasets import generate_records
    from repro_torch.data.tokenizer import ByteTokenizer

    vocab = t_configs.get_config(ARCH).vocab_size
    ours, theirs = ByteTokenizer(vocab), JByteTokenizer(vocab)
    recs = generate_records("ycsb", 6, seed=5) + [b"", b"a", b"ab"]
    for r in recs:
        for kw in ({}, {"add_bos": False, "max_len": 7}):
            got, want = ours.encode(r, **kw), theirs.encode(r, **kw)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ours.encode(recs[0]).max() >= 259       # pairs were folded
