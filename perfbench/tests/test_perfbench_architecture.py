"""An architecture is found by its configuration's ``reference`` alone.

The decoder's counts, the port's configurations and the weights drawn at
a tiny size are held, bit for bit, to values frozen from the harness
before the loader (``bench.architecture``) took their place; a stub
architecture made of modules alone runs a tiny cell of each kind to a
correct end; the drivers and readers name no architecture; and the
weights' fan-in leaves out a stacked ``expert`` axis.
"""
import collections
import dataclasses
import hashlib
import re
import sys
import time
import types

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig

from perfbench import run as run_mod
from perfbench.harness import bench, flops, serve, train, weights
from perfbench.harness.ports import decoder as decoder_port
from perfbench.reference import decoder
from perfbench.tests import tiny

CONFIG = "qwen3-1.7b"
H100 = "NVIDIA H100 80GB HBM3"

#: the parent harness's counts at the cells' shapes (B 1, one logit position)
FORWARD_FLOPS = {16384: 76968315322368, 24576: 138541906001920, 32768: 215508659470336}
PREFILL_ATTENTION_BOUND_S = {16384: 0.031130641684448943, 24576: 0.07004251882929828,
                             32768: 0.12451876684256422}
TRAIN_STEP_FLOPS_B8_S2048 = 180677731418112
#: the parent's readers on RUN's synthetic requests, steps and trace
READINGS = {"prefill_mfu.serve": 34.32321864774369, "f_roofline.serve": 63.80345263909011,
            "mfu.train": 17.42070143120556}
#: the parent's ``port.model_config`` fields; every other field at its default
MODEL_CONFIG = dict(
    name=CONFIG, family="decoder", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1000000.0,
    tied_embeddings=True, norm_eps=1e-06, compute_dtype="bfloat16", remat="full",
    microbatches=1, mla=None, moe=None)
PARAM_DTYPE = {"serve": "bfloat16", "run": "float32"}
#: sha256 (first 16 hex digits) of each leaf's bytes, tiny config, seed 2**31 + 11
WEIGHTS = {
    torch.float32: {
        "embed.tok": "7d41c67f979d8872",
        "group0.sub0.attn.k_norm": "38723a2e5e8a17aa",
        "group0.sub0.attn.q_norm": "38723a2e5e8a17aa",
        "group0.sub0.attn.wk": "379a13142d613b74",
        "group0.sub0.attn.wo": "c312f00094ceee75",
        "group0.sub0.attn.wq": "517b717b97531bd0",
        "group0.sub0.attn.wv": "b4e8bac6639dc5ee",
        "group0.sub0.ln1": "076a27c79e5ace2a",
        "group0.sub0.ln2": "076a27c79e5ace2a",
        "group0.sub0.mlp.wg": "e12d7650d9cd72c2",
        "group0.sub0.mlp.wi": "a96661db157886c8",
        "group0.sub0.mlp.wo": "2c73007ae7619cf5",
        "ln_f": "5341e6b2646979a7",
    },
    torch.bfloat16: {
        "embed.tok": "56936d3570813569",
        "group0.sub0.attn.k_norm": "f5a5fd42d16a2030",
        "group0.sub0.attn.q_norm": "f5a5fd42d16a2030",
        "group0.sub0.attn.wk": "a81d53c88ad57257",
        "group0.sub0.attn.wo": "d1afd793e5227ac6",
        "group0.sub0.attn.wq": "583e87bd263724ca",
        "group0.sub0.attn.wv": "6a00fbdd18cff503",
        "group0.sub0.ln1": "5341e6b2646979a7",
        "group0.sub0.ln2": "5341e6b2646979a7",
        "group0.sub0.mlp.wg": "3c0a92b94f8df6c9",
        "group0.sub0.mlp.wi": "8b96e39fa2d4aa84",
        "group0.sub0.mlp.wo": "b9a08f3a333a1b4a",
        "ln_f": "38723a2e5e8a17aa",
    },
}


def _conf():
    return bench.load_json("configs", CONFIG)


def _arch():
    return bench.architecture(_conf()).reference.arch_from_config(_conf())


@pytest.mark.parametrize("S", sorted(FORWARD_FLOPS))
def test_forward_flops_are_the_parents(S):
    a = _arch()
    assert a.forward_flops(1, S, 1) == FORWARD_FLOPS[S]
    assert flops.forward_flops(a, 1, S, 1) == FORWARD_FLOPS[S]


@pytest.mark.parametrize("S", sorted(PREFILL_ATTENTION_BOUND_S))
def test_prefill_attention_bound_is_the_parents(S):
    a, peak = _arch(), flops.PEAKS["H100"]
    assert a.prefill_attention_bound_s(1, S, peak) == PREFILL_ATTENTION_BOUND_S[S]
    assert flops.prefill_attention_bound_s(a, 1, S, peak) == PREFILL_ATTENTION_BOUND_S[S]


def test_train_step_flops_are_the_parents():
    assert flops.train_step_flops(_arch(), 8, 2048) == TRAIN_STEP_FLOPS_B8_S2048


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_count_readers_read_the_parents_values(metric):
    requests = [dict(batch=1, L=L, prefill_s=s) for L, s in (
        (16384, 0.2431), (32768, 0.6101), (24576, 0.4013), (16384, 0.2502), (24576, 0.3999))]
    run = types.SimpleNamespace(
        arch=_arch(), device_name=H100, requests=requests, steps=[{}] * 29,
        trace=types.SimpleNamespace(kernel_seconds=lambda names: 0.5123),
        traffic={"batch": 8, "seq_len": 2048}, window_s=30.4117)
    assert bench.metric_reader(metric)(run) == READINGS[metric]


@pytest.mark.parametrize("run", ["serve", "run"])
def test_port_model_config_is_the_parents(run):
    conf = _conf()
    cfg = bench.architecture(conf).port.model_config(CONFIG, conf, conf[run])
    assert cfg == ModelConfig(**MODEL_CONFIG, param_dtype=PARAM_DTYPE[run])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tiny_weights_are_the_parents_bits(dtype):
    c = tiny.cell("qwen3-longdoc")
    cfg = bench.architecture(c["config"]).port.model_config("tiny", c["config"])
    got = {path: hashlib.sha256(t.contiguous().view(torch.uint8).numpy().tobytes())
           .hexdigest()[:16]
           for path, t in weights.iter_weights(cfg, 2**31 + 11, torch.device("cpu"), dtype)}
    assert got == WEIGHTS[dtype]


# ---------------------------------------------------------------------------
# a new architecture is modules, found by name
# ---------------------------------------------------------------------------

STUB = "stub_arch"


def _stub(monkeypatch) -> collections.Counter:
    """A reference module and a port adapter named ``STUB``, each function
    the decoder's behind a call count."""
    calls = collections.Counter()

    def counted(f):
        def g(*a, **kw):
            calls[f.__name__] += 1
            return f(*a, **kw)
        return g

    ref = types.ModuleType(f"perfbench.reference.{STUB}")
    for f in (decoder.arch_from_config, decoder.request_logits, decoder.row_loss_sum):
        setattr(ref, f.__name__, counted(f))
    ref.TINY = dict(decoder.TINY)
    port = types.ModuleType(f"perfbench.harness.ports.{STUB}")
    port.model_config = counted(decoder_port.model_config)
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setitem(sys.modules, port.__name__, port)
    return calls


@pytest.mark.parametrize("kind,driver,used", [
    ("serve_closed_loop", serve, "request_logits"),
    ("train_ciao", train, "row_loss_sum")])
def test_a_stub_architecture_runs_a_tiny_cell_correctly(monkeypatch, kind, driver, used):
    calls = _stub(monkeypatch)
    names = [w["name"] for w in bench.benchmark()["workloads"]]
    c = next(c for c in map(bench.cell, names) if c["traffic"]["kind"] == kind)
    c["config"]["reference"] = STUB
    c = tiny.cut(c)
    assert bench.architecture(c["config"]).reference is sys.modules[f"perfbench.reference.{STUB}"]
    r = driver.run(c, 2**31 + 21, 0.5, False, torch.device("cpu"), time.monotonic_ns())
    out = run_mod.result_line(c, r, False, "cpu", 1)
    assert out["correct"] is True, out["check"]
    assert calls["model_config"] == 1 and calls["arch_from_config"] >= 1 and calls[used] >= 1


def test_an_unknown_architecture_is_refused_with_the_names_there_are():
    for name in ("no_such_arch", "train", "../decoder"):
        with pytest.raises(KeyError, match=r"architectures are \['decoder'"):
            bench.architecture({"reference": name})


def test_drivers_readers_and_entry_name_no_architecture():
    root = bench.PERFBENCH
    sources = (sorted((root / "harness").glob("*.py")) + sorted((root / "metrics").glob("*.py"))
               + [root / "run.py"])
    banned = re.compile(r"^\s*(from\s+\S*reference\s+import\s[^\n]*\b(decoder|arch)\b"
                        r"|(from|import)\s+\S*reference\.(decoder|arch)\b)", re.M)
    for path in sources:
        text = path.read_text()
        assert "qwen" not in text.lower(), path
        assert not banned.search(text), path


# ---------------------------------------------------------------------------
# fan-in
# ---------------------------------------------------------------------------

def _tiny_decoder():
    c = tiny.cell("qwen3-longdoc")
    return decoder_port.model_config("tiny", c["config"])


def _mla_moe():
    return dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=4)


@pytest.mark.parametrize("model,path,fan_in", [
    # an expert's matrix contracts d (wi, wg) or its ff (wo), not E x that
    (_mla_moe, "group1.sub0.moe.wi", 7168),
    (_mla_moe, "group1.sub0.moe.wg", 7168),
    (_mla_moe, "group1.sub0.moe.wo", 2048),
    # the parent's values
    (_mla_moe, "group1.sub0.moe.shared_wo", 2048),
    (_mla_moe, "group0.sub0.attn.wq_b", 1536),
    (_mla_moe, "group0.sub0.attn.wo", 16384),
    (_mla_moe, "group0.sub0.attn.wkv_b", 512),
    (_tiny_decoder, "group0.sub0.attn.wq", 64),
    (_tiny_decoder, "group0.sub0.attn.wk", 128),
    (_tiny_decoder, "group0.sub0.attn.wv", 128),
    (_tiny_decoder, "group0.sub0.attn.wo", 64),
    (_tiny_decoder, "group0.sub0.mlp.wi", 64),
    (_tiny_decoder, "group0.sub0.mlp.wg", 64),
    (_tiny_decoder, "group0.sub0.mlp.wo", 128),
])
def test_fan_in_leaves_out_the_expert_axis(model, path, fan_in):
    _, spec = weights._specs(model())[path]
    assert weights._fan_in(spec.shape, spec.axes) == fan_in
