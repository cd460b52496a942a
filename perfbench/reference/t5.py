"""The T5 encoder (flan-t5): RMSNorm before each block, relative position
buckets shared by all layers, unscaled dot products, a gated-GELU FFN."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import Weights, attend, heads, unheads


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def buckets(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bidirectional relative position buckets (T5 paper, HF
    ``_relative_position_bucket``): half the buckets for each sign, exact
    below ``num_buckets // 4``, log-spaced up to ``max_distance``."""
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = exact + (torch.log(n.float().clamp(min=1) / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = large.clamp(max=half - 1)
    return out + torch.where(n < exact, n, large)


def encode(w: Weights, cfg: dict, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, S) ids and {0,1} mask -> final-normed (B, S, d_model)."""
    eps, n = cfg["layer_norm_epsilon"], cfg["num_heads"]
    act = (lambda x: F.gelu(x, approximate="tanh")) if cfg["dense_act_fn"] == "gelu_new" else F.relu
    x = w("token_embed.embedding")[ids]
    s = ids.shape[1]
    pos = torch.arange(s, device=ids.device)
    bucket = buckets(pos[None, :] - pos[:, None], cfg["relative_attention_num_buckets"],
                     cfg["relative_attention_max_distance"])
    bias = w("rel_attn_bias.embedding")[bucket].permute(2, 0, 1)[None]  # (1, H, S, S)
    allowed = mask.bool()[:, None, None, :]
    for i in range(cfg["num_layers"]):
        lw = w.sub(f"layers.{i}.")
        h = rms(x, lw("ln_attn.scale"), eps)
        q, k, v = (heads(h @ lw(f"attn.{p}.kernel"), n) for p in "qkv")
        x = x + unheads(attend(q, k, v, allowed, bias)) @ lw("attn.o.kernel")
        h = rms(x, lw("ln_ffn.scale"), eps)
        if cfg["is_gated_act"]:
            h = act(h @ lw("ffn.wi_0.kernel")) * (h @ lw("ffn.wi_1.kernel"))
        else:
            h = act(h @ lw("ffn.wi.kernel"))
        x = x + h @ lw("ffn.wo.kernel")
    return rms(x, w("final_ln.scale"), eps)
