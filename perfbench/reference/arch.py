"""The shape of a decoder configuration, read from its published keys.

Both the plain reference and the benchmark's FLOP counts read a
configuration through :func:`arch_from_config`, so neither depends on the
program's own configuration classes.  A key the reference does not model
(RoPE scaling, sliding windows, another model type) is refused.

:class:`Arch` carries its own yardstick counts, by the counting rules of
:mod:`perfbench.harness.flops`.
"""
from __future__ import annotations

from dataclasses import dataclass

from perfbench.harness.flops import attention_pairs


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

    def forward_flops(self, B: int, S: int, logit_positions: int) -> int:
        """Model FLOPs of a forward over B rows of S positions, with logits
        at ``logit_positions`` positions a row."""
        hd = self.head_dim
        proj = 2 * (self.d * self.heads * hd + 2 * self.d * self.kv_heads * hd
                    + self.heads * hd * self.d)
        per_token = self.layers * (proj + 3 * 2 * self.d * self.ff)
        score = self.layers * self.heads * attention_pairs(S) * 2 * (hd + hd)
        head = 2 * self.d * self.vocab * logit_positions
        return B * (S * per_token + score + head)

    def prefill_attention_bound_s(self, B: int, S: int, peak: dict) -> float:
        """The least time a prefill's causal attention calls (one a layer,
        all alike) can take: for each, the larger of its bytes at HBM
        bandwidth and its operations at the bf16 peak."""
        H, Hkv, hd = self.heads, self.kv_heads, self.head_dim
        elems = B * S * hd * (2 * H + 2 * Hkv)
        ops = B * H * attention_pairs(S) * 2 * (hd + hd)
        return self.layers * max(2 * elems / peak["hbm_bytes"], ops / peak["bf16_flops"])


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
