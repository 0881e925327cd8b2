"""Serving entry point: batched prefill + greedy decode on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-1.7b --reduced --batch 4 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-1.7b --reduced --device cpu        # no card needed

The port of ``repro.launch.serve``: records from the dataset become the
prompts (byte tokenizer, padded with ``PAD_ID``), one prefill builds the
caches, then the decode step runs with the caches updated in place.
Parameters are drawn from ``--seed`` (no weights are read) and cast once
to the compute dtype.  One warm-up generation of one step runs first;
the timed generation reports ``prefill_ms`` and ``decode_ms_per_step``
from the host clock with the device synchronised around each step.

``--mesh-shape`` takes any shape the initialised process group holds
(``launch.train.make_mesh``): the parameters are sharded by the config's
rules as in the JAX package's driver, the prompts laid out over the batch
axes, and every shape serves through DTensors (``serve.engine``).  A
``model`` axis over 1 decodes into the JAX package's flash-decoding stub,
which raises as it does there.  Without a process group ``1,1`` serves on one device without a
mesh.  The returned dict adds the generated ``tokens`` (B, gen) to the
printed result.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.datasets import generate_records
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.dist import sharding as shd
from repro_torch.launch.train import mesh_for
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import build_model, family_module
from repro_torch.serve.engine import greedy_generate, make_serve_fns


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, seconds: list, dev: torch.device):
    """``fn`` with its wall time, device work included, appended to
    ``seconds``."""
    def call(*args):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        return out
    return call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh-shape", default="1,1")
    ap.add_argument("--dataset", default="ycsb")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be at least 1")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    dev = resolve_device(args.device)
    mesh = mesh_for(args.mesh_shape)
    params = model.init(args.seed, device=dev)
    params_sh = None
    if mesh is not None:
        params_sh = shd.param_shardings(
            params, family_module(cfg).param_axes(cfg), mesh)
        params = shd.shard_params(params, params_sh)
    params = model.compute_params(params)

    tok = ByteTokenizer(vocab_size=cfg.vocab_size)
    recs = generate_records(args.dataset, args.batch, seed=args.seed)
    prompts = torch.from_numpy(tok.pad_batch(
        [tok.encode(r, add_eos=False) for r in recs], args.prompt_len)).to(dev)

    fns = make_serve_fns(model, mesh, batch=args.batch,
                         seq_len=args.prompt_len + args.gen + 128,
                         param_shardings=params_sh)
    greedy_generate(model, fns, params, prompts, n_steps=1)     # warm-up
    prefill_s: list[float] = []
    decode_s: list[float] = []
    timed = {**fns, "prefill": _timed(fns["prefill"], prefill_s, dev),
             "decode": _timed(fns["decode"], decode_s, dev)}
    _sync(dev)
    t0 = time.perf_counter()
    out = greedy_generate(model, timed, params, prompts, n_steps=args.gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    result = {
        "batch": args.batch,
        "generated": int(out.shape[1]),
        "tokens_per_s": args.batch * args.gen / dt,
        "wall_s": dt,
        "prefill_ms": prefill_s[0] * 1e3,
        "decode_ms_per_step": sum(decode_s) / len(decode_s) * 1e3,
        "prefill_calls": 2,         # the warm-up's and the timed one
        "device": str(dev),
    }
    print(f"[serve] {result}")
    if shd.is_dtensor(out):
        out = out.full_tensor()
    return {**result, "tokens": out}


if __name__ == "__main__":
    main()
