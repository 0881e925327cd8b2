"""The program's configuration objects, built from a configuration file.

The port takes a ``ModelConfig`` (and an ``OptConfig`` to train); this
module fills them from the file's published keys and its ``run`` section,
so the configuration that is run is the one the file states.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.train.optimizer import OptConfig

from perfbench.reference.arch import arch_from_config


def model_config(name: str, conf: dict, run: dict | None = None) -> ModelConfig:
    """``run``: how the program runs it (precision, remat), by default the
    file's ``run`` (training); serving passes the file's ``serve``."""
    a = arch_from_config(conf)           # refuses what is not modelled
    run = conf["run"] if run is None else run
    return ModelConfig(
        name=name, family="decoder", n_layers=a.layers, d_model=a.d,
        n_heads=a.heads, n_kv_heads=a.kv_heads, d_ff=a.ff, vocab_size=a.vocab,
        head_dim=a.head_dim, qk_norm=a.qk_norm, rope_theta=a.theta,
        tied_embeddings=a.tied, norm_eps=a.eps, param_dtype=run["param_dtype"],
        compute_dtype=run["compute_dtype"], remat=run.get("remat", "full"),
        microbatches=1)


def opt_config(conf: dict) -> OptConfig:
    o = conf["run"]["optimizer"]
    return OptConfig(kind=o["kind"], learning_rate=o["learning_rate"], b1=o["b1"],
                     b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                     grad_clip=o["grad_clip"], opt_dtype=conf["run"]["param_dtype"],
                     warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                     min_lr_frac=o["min_lr_frac"])
