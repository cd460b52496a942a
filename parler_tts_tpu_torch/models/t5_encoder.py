"""Flan-T5 text encoder.

Port of ``parler_tts_tpu/models/t5_encoder.py``: relative-position-bucket
attention bias shared by all layers, RMSNorm, gated-GELU FFN, no absolute
positions and no q scaling (T5 folds it into the init).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from parler_tts_tpu_torch.core.config import T5EncoderConfig
from parler_tts_tpu_torch.ops.nn import (
    ACTIVATIONS,
    Dense,
    Embedding,
    RMSNorm,
    attention_scores,
    merge_heads,
    split_heads,
)


def relative_position_bucket(relative_position: torch.Tensor, *, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucket of each relative position (int tensor).  The
    log is taken in fp32 and cast to int by truncation, as in the JAX and HF
    versions, so the buckets agree exactly."""
    num_buckets //= 2
    ret = torch.where(relative_position > 0, num_buckets, 0)
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        d, inner = cfg.d_model, cfg.inner_dim
        self.num_heads = cfg.num_heads
        self.q, self.k, self.v = Dense(d, inner), Dense(d, inner), Dense(d, inner)
        self.o = Dense(inner, d)

    def forward(self, x, bias, mask):
        h = self.num_heads
        q, k, v = split_heads(self.q(x), h), split_heads(self.k(x), h), split_heads(self.v(x), h)
        return self.o(merge_heads(attention_scores(q, k, v, bias=bias, mask=mask)))


class T5FFN(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.act = ACTIVATIONS[cfg.dense_act_fn]
        self.gated = cfg.is_gated_act
        if self.gated:
            self.wi_0 = Dense(cfg.d_model, cfg.d_ff)
            self.wi_1 = Dense(cfg.d_model, cfg.d_ff)
        else:
            self.wi = Dense(cfg.d_model, cfg.d_ff)
        self.wo = Dense(cfg.d_ff, cfg.d_model)

    def forward(self, x):
        h = self.act(self.wi_0(x)) * self.wi_1(x) if self.gated else self.act(self.wi(x))
        return self.wo(h)


class T5Layer(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.attn = T5Attention(cfg)
        self.ln_attn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.ffn = T5FFN(cfg)
        self.ln_ffn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, bias, mask):
        x = x + self.attn(self.ln_attn(x), bias, mask)
        return x + self.ffn(self.ln_ffn(x))


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = Embedding(cfg.vocab_size, cfg.d_model)
        self.rel_attn_bias = Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)
        self.layers = nn.ModuleList(T5Layer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def position_bias(self, q_len: int, k_len: int) -> torch.Tensor:
        """(1, heads, q_len, k_len) additive bias from the shared table."""
        device = self.rel_attn_bias.embedding.device
        ctx = torch.arange(q_len, device=device)[:, None]
        mem = torch.arange(k_len, device=device)[None, :]
        buckets = relative_position_bucket(
            mem - ctx,
            num_buckets=self.cfg.relative_attention_num_buckets,
            max_distance=self.cfg.relative_attention_max_distance,
        )
        return self.rel_attn_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """(B, T) ids, (B, T) {0,1} mask -> final-normed (B, T, d_model) in
        the compute ``dtype`` (None = the parameters')."""
        x = self.token_embed(input_ids, dtype)
        bias = self.position_bias(input_ids.shape[1], input_ids.shape[1]).to(x.dtype)
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        for layer in self.layers:
            x = layer(x, bias, mask)
        return self.final_ln(x)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, factor: float = 1.0) -> None:
        """HF T5's fan-in-scaled normal init, as the JAX ``init``."""
        d, dkv, dff = self.cfg.d_model, self.cfg.d_kv, self.cfg.d_ff
        inner = self.cfg.inner_dim
        self.token_embed.embedding.normal_(0.0, factor, generator=generator)
        self.rel_attn_bias.embedding.normal_(0.0, factor * (d * dkv) ** -0.5, generator=generator)
        for layer in self.layers:
            a, f = layer.attn, layer.ffn
            a.q.kernel.normal_(0.0, factor * (d * dkv) ** -0.5, generator=generator)
            a.k.kernel.normal_(0.0, factor * d**-0.5, generator=generator)
            a.v.kernel.normal_(0.0, factor * d**-0.5, generator=generator)
            a.o.kernel.normal_(0.0, factor * inner**-0.5, generator=generator)
            for w in (f.wi_0, f.wi_1) if f.gated else (f.wi,):
                w.kernel.normal_(0.0, factor * d**-0.5, generator=generator)
            f.wo.kernel.normal_(0.0, factor * dff**-0.5, generator=generator)
            layer.ln_attn.scale.fill_(1.0)
            layer.ln_ffn.scale.fill_(1.0)
        self.final_ln.scale.fill_(1.0)
