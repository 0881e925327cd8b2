"""The plain references against the program at a tiny preset, in f32: a
wrong reference shows here before any chip time is spent."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train.train_step import init_opt_state, make_train_step

from perfbench.harness import bench, port, traffic, weights
from perfbench.harness.ports import decoder as decoder_port
from perfbench.reference import decoder, precision, train as ref_train
from perfbench.reference.arch import arch_from_config
from perfbench.reference.train import named_leaves
from perfbench.tests import tiny

CPU = torch.device("cpu")


def _f32(name):
    c = tiny.cell(name)
    c["config"]["run"] = {**c["config"]["run"], "param_dtype": "float32",
                          "compute_dtype": "float32"}
    return c


@pytest.mark.parametrize("name,run", [("qwen3-longdoc", "serve"), ("qwen3-train", "run")])
def test_port_config_is_the_registrys(name, run):
    full = bench.cell(name)["config"]
    assert bench.architecture(full).port is decoder_port
    ours = decoder_port.model_config("qwen3-1.7b", full, full[run])
    reg = get_config("qwen3-1.7b")
    reg = dataclasses.replace(reg, n_layers=ours.n_layers, param_dtype=ours.param_dtype,
                              microbatches=1, opt_dtype=ours.param_dtype)
    for f in ("d_model", "n_heads", "n_kv_heads", "hd", "d_ff", "vocab_size", "qk_norm",
              "rope_theta", "tied_embeddings", "norm_eps", "mla", "moe", "attention"):
        a, b = getattr(ours, f), getattr(reg, f)
        assert (a() if callable(a) else a) == (b() if callable(b) else b), f
    assert ours.compute_dtype == full[run]["compute_dtype"]


@pytest.mark.parametrize("seed,B", [(0, 1), (7, 1), (3, 2)])
def test_request_logits_match_prefill_and_decode(seed, B):
    c = _f32("qwen3-longdoc")
    conf = c["config"]
    a = arch_from_config(conf)
    cfg = decoder_port.model_config("tiny", conf)
    model = build_model(cfg)
    w = weights.make_weights(cfg, seed, CPU, torch.float32)
    L, n_out = 40, 6
    fns = make_serve_fns(model, batch=B, seq_len=L + n_out, cache_dtype=torch.float32)
    prompt = torch.from_numpy(traffic.prompts(traffic.prompt_rng(seed, 2), B, L, a.vocab))
    logits, cache = fns["prefill"](w, {"tokens": prompt})
    outs, toks = [logits], [logits.argmax(-1)]
    for j in range(n_out - 1):
        logits, cache = fns["decode"](w, cache, toks[-1].to(torch.int32), L + j)
        outs.append(logits)
        toks.append(logits.argmax(-1))
    prog = torch.stack(outs, 1)
    full = torch.cat([prompt.long(), torch.stack(toks[:-1], 1)], 1)
    ref = decoder.request_logits(w, a, full, L)
    scale = ref.std()
    assert ((prog - ref).abs().max() / scale) < 2e-4


def test_qwen3_train_step_matches_reference():
    c = _f32("qwen3-train")
    conf = c["config"]
    a = arch_from_config(conf)
    cfg = decoder_port.model_config("tiny", conf)
    model = build_model(cfg)
    opt_cfg = port.opt_config(conf)
    seed = 4
    w = weights.make_weights(cfg, seed, CPU, torch.float32)
    state = init_opt_state(model, w, opt_cfg)
    step = make_train_step(model, opt_cfg, n_micro=1)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, a.vocab, (2, 32))).long() for _ in range(2)]
    losses = []
    for i, b in enumerate(batches):
        w, state, m = step(w, state, {"tokens": b.to(torch.int32),
                                      "loss_mask": torch.ones(b.shape)})
        losses.append(float(m["loss"]))
        if i == 0:
            first = {p: float(t.norm()) / (1 - opt_cfg.b1)
                     for p, t in named_leaves(state["m"])}
    start = dict(weights.iter_weights(cfg, seed, CPU, torch.float32))
    change = {p: float((t - start[p]).norm()) for p, t in named_leaves(w)}
    ref = ref_train.train(decoder.row_loss_sum,
                          weights.make_weights(cfg, seed, CPU, torch.float32), a, batches,
                          conf["run"]["optimizer"],
                          lambda: weights.iter_weights(cfg, seed, CPU, torch.float32))
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for p in first:
        assert first[p] == pytest.approx(ref["first_grad"][p], rel=1e-4, abs=1e-9), p
        assert change[p] == pytest.approx(ref["change"][p], rel=1e-4, abs=1e-9), p


def test_fp8_control_differs_and_f32_products_are_exact():
    x = torch.randn(64, 64)
    assert torch.equal(precision.mm(x, x, "f32"), x @ x)
    err = (precision.mm(x, x, "fp8") - x @ x).abs().max() / (x @ x).abs().max()
    assert 1e-3 < float(err) < 0.2
