"""Plain reference of the decoder the benchmark runs: f32, TF32 off.

Written from the published description (Qwen3: GQA with q and k
RMS-normed per head, RoPE, SwiGLU MLP, tied embeddings), over the
parameters the benchmark draws in the program's layout:

* ``embed.tok`` (V, d) and ``embed.unembed`` (d, V) unless tied;
  ``ln_f`` (d,); ``group0.sub0`` the layers, each leaf stacked over them.
* A norm scale is stored as an offset from one: ``x * rms(x)^-1 * (1 + w)``.
* RoPE rotates the two halves of the rotated dims (a permutation of the
  published interleaved pairs, which random weights cannot tell apart).

Nothing here imports the program.  Attention and MLPs run in blocks of
rows so that a 32k-token prompt fits beside the served weights.
``prec="fp8"`` is the benchmark's control (:mod:`.precision`).

The configuration files whose ``reference`` is ``"decoder"`` are read by
:func:`arch_from_config`; their port adapter is
``perfbench/harness/ports/decoder.py``.
"""
from __future__ import annotations

import torch

from .arch import Arch, arch_from_config  # noqa: F401  (the loader's entry)
from .precision import einsum, exact_f32, mm

#: published-key overrides that cut a configuration to a CPU test's size
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            intermediate_size=128, num_hidden_layers=2, vocab_size=512)

#: queries a block of the attention's score matrix
Q_BLOCK = 256
#: rows a block of an MLP
ROW_BLOCK = 4096


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def rope(x, pos, theta: float):
    """Rotate the halves of x (..., S, heads, r) at positions ``pos`` (S,)."""
    r = x.shape[-1]
    freqs = theta ** (-torch.arange(0, r, 2, dtype=torch.float32,
                                    device=x.device) / r)
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x):
    return x * torch.sigmoid(x)


def mlp(h, wi, wg, wo, prec: str):
    """SwiGLU over rows of h (N, d), in blocks of rows."""
    outs = []
    for i in range(0, h.shape[0], ROW_BLOCK):
        x = h[i:i + ROW_BLOCK]
        a = mm(x, wi.float(), prec) * silu(mm(x, wg.float(), prec))
        outs.append(mm(a, wo.float(), prec))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def causal_attention(q, k, v, scale: float, prec: str):
    """One row: q, k (S, H, dqk), v (S, H, dv); query i sees keys 0..i."""
    S = q.shape[0]
    outs = []
    for i0 in range(0, S, Q_BLOCK):
        i1 = min(S, i0 + Q_BLOCK)
        s = einsum("qhd,khd->hqk", q[i0:i1], k[:i1], prec) * scale
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(einsum("hqk,khd->qhd", p, v[:i1], prec))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def attention_row(p, h, arch: Arch, pos, prec: str):
    """The attention sublayer of one row h (S, d) -> (S, d)."""
    S, d = h.shape
    hd, G = arch.head_dim, arch.heads // arch.kv_heads
    q = mm(h, p["wq"].float().reshape(d, -1), prec).view(S, arch.heads, hd)
    k = mm(h, p["wk"].float().reshape(d, -1), prec).view(S, -1, hd)
    v = mm(h, p["wv"].float().reshape(d, -1), prec).view(S, -1, hd)
    if arch.qk_norm:
        q = rmsnorm(q, p["q_norm"], arch.eps)
        k = rmsnorm(k, p["k_norm"], arch.eps)
    q, k = rope(q, pos, arch.theta), rope(k, pos, arch.theta)
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    o = causal_attention(q, k, v, hd ** -0.5, prec)
    return mm(o.reshape(S, -1), p["wo"].float().reshape(-1, d), prec)


def layer_params(weights, i: int) -> dict:
    """Layer ``i``'s leaves (views of the stacked group)."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return pick(weights["group0"]["sub0"])


def unembed_weight(weights, arch: Arch):
    return weights["embed"]["tok"].T if arch.tied else weights["embed"]["unembed"]


# ---------------------------------------------------------------------------
# serving: a request's logits
# ---------------------------------------------------------------------------

@torch.no_grad()
def request_logits(weights, arch: Arch, tokens, n_prompt: int, prec: str = "f32"):
    """Logits (B, S - n_prompt + 1, V) at positions ``n_prompt - 1 .. S - 1``
    of ``tokens`` (B, S): a prompt of ``n_prompt`` tokens, then the tokens
    served after it, each row in one causal pass."""
    with exact_f32():
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)
        x = weights["embed"]["tok"][tokens].float()
        for i in range(arch.layers):
            p = layer_params(weights, i)
            for b in range(B):
                x[b] += attention_row(p["attn"], rmsnorm(x[b], p["ln1"], arch.eps),
                                      arch, pos, prec)
                h = rmsnorm(x[b], p["ln2"], arch.eps)
                x[b] += mlp(h, p["mlp"]["wi"], p["mlp"]["wg"], p["mlp"]["wo"], prec)
        xo = rmsnorm(x[:, n_prompt - 1:], weights["ln_f"], arch.eps)
        return mm(xo, unembed_weight(weights, arch).float(), prec)


# ---------------------------------------------------------------------------
# training: a row's summed next-token loss
# ---------------------------------------------------------------------------

def row_loss_sum(weights, arch: Arch, tokens, prec: str = "f32"):
    """Summed next-token cross-entropy of one row ``tokens`` (S,), every
    position weighted one, over f32 ``weights`` (which may require grads)."""
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = weights["embed"]["tok"][tokens].float()
    for i in range(arch.layers):
        p = layer_params(weights, i)
        x = x + attention_row(p["attn"], rmsnorm(x, p["ln1"], arch.eps), arch,
                              pos, prec)
        h = rmsnorm(x, p["ln2"], arch.eps)
        x = x + mlp(h, p["mlp"]["wi"], p["mlp"]["wg"], p["mlp"]["wo"], prec)
    logits = mm(rmsnorm(x[:-1], weights["ln_f"], arch.eps),
                unembed_weight(weights, arch).float(), prec)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, tokens[1:, None])[:, 0]
    return nll.sum()
