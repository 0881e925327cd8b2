"""The serving driver: one client in a closed loop over the serve engine.

Set-up draws the weights on the device, builds the engine's prefill and
decode steps for each prompt length of the mix (``make_serve_fns``) and
serves one request of each length.  The window then serves requests one
after another until ``seconds`` have passed, and closes when the last
request started has its last token: a request is one prefill of
``batch`` prompts, whose greedy token is its first, then decode steps,
each ending when its token is on the host, as a server streams them.

``correct``: a sample of the finished requests drawn from the seed, the
longest among them, is run again by the plain reference (each prompt with
its served tokens, in one pass), and the served tokens' logits are held
to it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import build_model
from repro_torch.serve.engine import make_serve_fns

from . import bench, traffic as traffic_mod, weights as weights_mod
from .record import Tracer, sync
from .runs import Run, free, log, memory_peak, now_ns


def _serve(fns, params, prompt, n_out: int, spans):
    """One request: (tokens (B, n_out) on the host, logits of each step,
    prefill seconds, decode seconds of each step).  The prefill ends when
    its token is on the host: that is the first token's time."""
    with spans.span("prefill"):
        logits, cache = fns["prefill"](params, {"tokens": prompt})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        host = [tok.cpu()]
    out_logits = [logits]
    cur = prompt.shape[1]
    for _ in range(n_out - 1):
        with spans.span("decode"):
            logits, cache = fns["decode"](params, cache, tok, cur)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            host.append(tok.cpu())
        out_logits.append(logits)
        cur += 1
    seconds = [(b - a) / 1e9 for _, a, b in spans.items[-n_out:]]
    return torch.stack(host, 1).numpy(), out_logits, seconds[0], seconds[1:]


def run(cell: dict, seed: int, seconds: float, trace: bool, dev: torch.device,
        t0_ns: int, *, device_name: str = "", control: bool = False,
        make_fns=make_serve_fns) -> Run:
    conf, tr = cell["config"], cell["traffic"]
    reference, adapter = bench.architecture(conf)
    arch = reference.arch_from_config(conf)
    cfg = adapter.model_config(cell["workload"]["config"], conf, conf["serve"])
    model = build_model(cfg)
    B, n_out = tr["batch"], tr["output_tokens"]
    lengths = sorted({int(k) for k in tr["prompt_lengths"]})
    run_ = Run(arch, tr, device_name)

    log("weights")
    weights = weights_mod.make_weights(cfg, seed, dev,
                                       torch_dtype(conf["serve"]["param_dtype"]))
    params = model.compute_params(weights)
    fns = {L: make_fns(model, batch=B, seq_len=L + n_out) for L in lengths}
    warm = traffic_mod.prompt_rng(seed, 0)
    for L in lengths:
        log(f"warm-up, prompt {L}")
        p = torch.from_numpy(traffic_mod.prompts(warm, B, L, arch.vocab)).to(dev)
        _serve(fns[L], params, p, n_out, run_.spans)
    sync(dev)
    run_.spans.items.clear()

    schedule = traffic_mod.serve_schedule(tr, seed)
    rng = traffic_mod.prompt_rng(seed, 2)
    tracer = Tracer(trace, dev)
    log(f"window, {seconds} s")
    with tracer.window():
        w0 = now_ns()
        run_.setup_s = (w0 - t0_ns) / 1e9
        while now_ns() - w0 < seconds * 1e9:
            L = next(schedule)
            prompt_np = traffic_mod.prompts(rng, B, L, arch.vocab)
            t_start = now_ns()
            prompt = torch.from_numpy(prompt_np).to(dev)
            tokens, logits, prefill_s, decode_s = _serve(
                fns[L], params, prompt, n_out, run_.spans)
            run_.requests.append(dict(
                L=L, batch=B, ttft_s=(run_.spans.items[-n_out][2] - t_start) / 1e9,
                prefill_s=prefill_s, decode_s=decode_s, tokens_in=B * L,
                tokens_out=B * n_out, served=tokens, prompt=prompt_np, logits=logits))
        sync(dev)
        w1 = now_ns()
    run_.window_s = (w1 - w0) / 1e9
    run_.memory_peak_bytes = memory_peak(dev)
    if trace:
        run_.trace = tracer.reduce((w0, w1), run_.spans)
    log(f"window closed: {len(run_.requests)} requests in {run_.window_s:.3f} s")

    sample = _sample(run_.requests, tr["check_requests"], seed)
    kept = {i: [lg.float() for lg in run_.requests[i]["logits"]] for i in sample}
    for r in run_.requests:
        r.pop("logits")
    del fns, params, tracer
    free(dev)
    run_.check = check(reference, weights, arch, [run_.requests[i] for i in sample],
                       [kept[i] for i in sample], dev, control)
    return run_


def _sample(requests: list, n: int, seed: int) -> list[int]:
    """Indices of ``n`` requests drawn from the seed, one of the longest
    first."""
    rng = np.random.default_rng([seed, 3])
    longest = max(r["L"] for r in requests)
    tops = [i for i, r in enumerate(requests) if r["L"] == longest]
    first = int(rng.choice(tops))
    rest = [i for i in range(len(requests)) if i != first]
    more = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [first] + sorted(rest[int(i)] for i in more)


def check(reference, weights, arch, requests: list, logits: list, dev, control: bool) -> dict:
    """The numbers compared, over every served position of the sample (a
    prompt's last position, then each decode step's), in units of the
    reference logits' standard deviation there (``reference``: the
    architecture's reference module): ``served_gap_max``, the
    widest gap by which a served token's logit lies below the reference's
    best, and ``logit_err_max``, the largest RMS difference of the served
    logits from the reference's.  ``positions`` keeps every (gap, error)
    pair, row by row.  With ``control``, the same of the reference rounded
    to fp8 in the program's place (``*.control``), teacher-forced on the
    served tokens, the token it puts first read as the one it serves."""
    sides = {"": []} if not control else {"": [], ".control": []}
    for r, prog in zip(requests, logits):
        toks = np.concatenate([r["prompt"], r["served"][:, :-1]], axis=1)
        toks = torch.from_numpy(toks).to(dev).long()
        log(f"reference, prompt {r['L']}")
        ref = reference.request_logits(weights, arch, toks, r["L"], "f32")
        served = torch.from_numpy(r["served"]).to(dev).long()
        sides[""].append(_gap_err(ref, torch.stack(prog, 1), served))
        if control:
            ctl = reference.request_logits(weights, arch, toks, r["L"], "fp8")
            sides[".control"].append(_gap_err(ref, ctl, ctl.argmax(-1)))
        del ref
    out = {}
    for suffix, parts in sides.items():
        gap = torch.cat([g.flatten() for g, _ in parts])
        err = torch.cat([e.flatten() for _, e in parts])
        out["served_gap_max" + suffix] = float(gap.max())
        out["logit_err_max" + suffix] = float(err.max())
        out["positions" + suffix] = torch.stack([gap, err], -1).tolist()
    return out


def _gap_err(ref, other, chosen):
    """(gap, err), each (B, steps), of (B, steps, V) logits."""
    std = ref.std(-1)
    gap = (ref.amax(-1) - ref.gather(-1, chosen[..., None])[..., 0]) / std
    err = (other - ref).square().mean(-1).sqrt() / std
    return gap.cpu(), err.cpu()
