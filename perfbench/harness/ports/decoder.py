"""The port's ``ModelConfig`` of a configuration whose reference is
:mod:`perfbench.reference.decoder`: a dense GQA decoder."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from perfbench.reference.decoder import arch_from_config


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
