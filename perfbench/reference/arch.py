"""The shape of a decoder configuration, read from its published keys.

Both the plain reference and the benchmark's FLOP counts read a
configuration through :func:`arch_from_config`, so neither depends on the
program's own configuration classes.  A key the reference does not model
(RoPE scaling, sliding windows, another model type) is refused.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Arch:
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    eps: float
    theta: float
    tied: bool
    qk_norm: bool


def _refuse(conf: dict, key: str, allowed) -> None:
    if conf.get(key, allowed[0]) not in allowed:
        raise ValueError(f"{key}={conf[key]!r}: the reference models only "
                         f"{allowed}; state the configuration as it is run")


def arch_from_config(conf: dict) -> Arch:
    """An :class:`Arch` from a configuration file's published keys."""
    mt = conf["model_type"]
    if mt != "qwen3":
        raise ValueError(f"model_type {mt!r}: no reference for it")
    if (conf.get("rope_scaling") or {}).get("type", "none") != "none":
        raise ValueError("rope_scaling: the reference models plain RoPE only")
    _refuse(conf, "hidden_act", ("silu",))
    _refuse(conf, "attention_bias", (False,))
    _refuse(conf, "use_sliding_window", (False,))
    return Arch(
        d=conf["hidden_size"], layers=conf["num_hidden_layers"],
        heads=conf["num_attention_heads"], kv_heads=conf["num_key_value_heads"],
        head_dim=conf["head_dim"], ff=conf["intermediate_size"],
        vocab=conf["vocab_size"], eps=conf["rms_norm_eps"],
        theta=float(conf["rope_theta"]), tied=bool(conf["tie_word_embeddings"]),
        qk_norm=True)
