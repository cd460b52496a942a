"""MusicGen-style multi-codebook decoder LM.

Port of ``parler_tts_tpu/models/decoder.py`` (inference side):

* the K codebook tables are one ``(K, vocab+1, H)`` parameter, summed over
  codebooks; the K LM heads are one ``(K, H, V)`` parameter;
* prompt hidden states are concatenated in front of the codec-token
  embeddings and take sinusoidal position ids (``[cos | sin]`` order) over
  the fused sequence; ``embed_scale`` is never applied;
* the full/prefill forward runs its causal self-attention through the
  flash-attention kernel (``ops/flash_attention.py``) whenever T > 1;
* cross-attention K/V are computed once at prefill and cached; the cached
  single-token decode runs plain PyTorch attention.

The KV cache is not the JAX package's: its time-minor ``(L, B, H, D, T)``
buffers, staged flushes and growing buckets exist for the TPU's tiling.
Here the self K/V is one ``(L, B, H, T_max, D)`` pair allocated once at
``prompt_len + max_length`` and written in place at ``index``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from parler_tts_tpu_torch.core.config import DecoderConfig
from parler_tts_tpu_torch.ops.flash_attention import flash_attention_bhtd
from parler_tts_tpu_torch.ops.nn import (
    ACTIVATIONS,
    Dense,
    LayerNorm,
    attention_scores,
    merge_heads,
    split_heads,
)


def sinusoidal_positions(num_positions: int, dim: int) -> torch.Tensor:
    """(num_positions, dim) fp32 table in ``[cos | sin]`` order, computed with
    the JAX package's fp32 operation order."""
    half = dim // 2
    step = torch.log(torch.tensor(10000.0)) / (half - 1)
    freq = torch.exp(torch.arange(half, dtype=torch.float32) * -step)
    angles = torch.arange(num_positions, dtype=torch.float32)[:, None] * freq[None, :]
    table = torch.cat([torch.cos(angles), torch.sin(angles)], dim=1)
    if dim % 2 == 1:
        table = F.pad(table, (0, 1))
    return table


@dataclasses.dataclass
class KVCache:
    """Decode cache.  ``self_k``/``self_v`` ``(L, B, H, T_max, D)`` hold the
    keys/values of fused positions ``[0, index)`` and are updated in place;
    ``cross_k``/``cross_v`` ``(L, B, H, S, D)`` are written once at prefill."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    index: int = 0


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, enc_len: int, *,
               dtype: torch.dtype, device: torch.device) -> KVCache:
    l, h, d = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim

    def buf(t):
        return torch.zeros((l, batch, h, t, d), dtype=dtype, device=device)

    return KVCache(buf(max_len), buf(max_len), buf(enc_len), buf(enc_len))


class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.scale = cfg.head_dim**-0.5
        self.q, self.k, self.v, self.o = Dense(h, h), Dense(h, h), Dense(h, h), Dense(h, h)

    def project(self, x: torch.Tensor):
        """(B, T, H) -> pre-scaled q, k, v, each (B, heads, T, D)."""
        n = self.num_heads
        return split_heads(self.q(x), n) * self.scale, split_heads(self.k(x), n), split_heads(self.v(x), n)


def _attend(q, k, v, mask):
    """Single-query attention over cached (B, H, S, D) K/V; ``mask`` (B, S)."""
    return attention_scores(q, k, v, mask=mask[:, None, None, :].bool())


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.act = ACTIVATIONS[cfg.activation_function]
        self.self_attn = DecoderAttention(cfg)
        self.ln_self = LayerNorm(h)
        self.cross_attn = DecoderAttention(cfg)
        self.ln_cross = LayerNorm(h)
        self.fc1 = Dense(h, cfg.ffn_dim)
        self.fc2 = Dense(cfg.ffn_dim, h)
        self.ln_ffn = LayerNorm(h)

    def _ffn(self, x):
        return x + self.fc2(self.act(self.fc1(self.ln_ffn(x))))

    def forward_full(self, x, flash_mask, self_mask, enc, enc_mask):
        """Full-sequence layer.  Returns (x, self K/V, cross K/V)."""
        q, k, v = self.self_attn.project(self.ln_self(x))
        if q.shape[2] > 1:
            out = flash_attention_bhtd(q, k, v, flash_mask, scale=1.0, causal=True)  # q pre-scaled
        else:
            out = attention_scores(q, k, v, mask=self_mask)
        x = x + self.self_attn.o(merge_heads(out))

        ca = self.cross_attn
        cq = split_heads(ca.q(self.ln_cross(x)), ca.num_heads) * ca.scale
        ck, cv = split_heads(ca.k(enc), ca.num_heads), split_heads(ca.v(enc), ca.num_heads)
        x = x + ca.o(merge_heads(attention_scores(cq, ck, cv, mask=enc_mask[:, None, None, :].bool())))
        return self._ffn(x), (k, v), (ck, cv)

    def forward_decode(self, x, cache: KVCache, layer: int, kv_mask, enc_mask):
        """One cached token: writes its K/V at ``cache.index`` (in place) and
        attends over positions ``[0, index]``."""
        i = cache.index
        q, k, v = self.self_attn.project(self.ln_self(x))
        cache.self_k[layer, :, :, i] = k[:, :, 0]
        cache.self_v[layer, :, :, i] = v[:, :, 0]
        out = _attend(q, cache.self_k[layer, :, :, : i + 1], cache.self_v[layer, :, :, : i + 1],
                      kv_mask[:, : i + 1])
        x = x + self.self_attn.o(merge_heads(out))

        ca = self.cross_attn
        cq = split_heads(ca.q(self.ln_cross(x)), ca.num_heads) * ca.scale
        out = _attend(cq, cache.cross_k[layer], cache.cross_v[layer], enc_mask)
        x = x + ca.o(merge_heads(out))
        return self._ffn(x)


class ParlerDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        k, h = cfg.num_codebooks, cfg.hidden_size
        self.embed_tokens = nn.Module()
        self.embed_tokens.embedding = nn.Parameter(torch.empty(k, cfg.vocab_size + 1, h))
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_ln = LayerNorm(h)
        self.lm_heads = nn.Module()
        self.lm_heads.kernel = nn.Parameter(torch.empty(k, h, cfg.vocab_size))
        self.register_buffer(
            "positions", sinusoidal_positions(cfg.max_position_embeddings, h), persistent=False
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.embedding.dtype

    def embed_codebooks(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, K, T) ids -> (B, T, H): one gather over the offset-flattened
        table, summed over codebooks."""
        tables = self.embed_tokens.embedding
        k, v1, h = tables.shape
        offsets = (torch.arange(k, device=ids.device, dtype=ids.dtype) * v1)[None, :, None]
        return F.embedding(ids + offsets, tables.reshape(k * v1, h)).sum(dim=1)

    def _positions(self, start: int, length: int) -> torch.Tensor:
        if start + length > self.positions.shape[0]:
            raise ValueError(
                f"positions [{start}, {start + length}) exceed max_position_embeddings="
                f"{self.positions.shape[0]}"
            )
        return self.positions[start : start + length].to(self.dtype)

    def forward(self, input_ids: torch.Tensor, *, encoder_hidden_states: torch.Tensor,
                encoder_attention_mask: torch.Tensor,
                prompt_hidden_states: torch.Tensor | None = None,
                attention_mask: torch.Tensor | None = None,
                cache: KVCache | None = None) -> torch.Tensor:
        """Full-sequence forward over the fused (prompt + codes) sequence.

        ``input_ids`` (B, K, T); ``attention_mask`` (B, >= T_fused) covers the
        fused sequence, 1 = valid (None = all valid).  With a ``cache`` at
        index 0 this is the prefill: every layer's self K/V and cross K/V are
        written to it and its index advances to ``T_fused``.  Returns the
        final-normed hidden states (B, T_fused, H)."""
        x = self.embed_codebooks(input_ids)
        if prompt_hidden_states is not None:
            x = torch.cat([prompt_hidden_states.to(x.dtype), x], dim=1)
        b, t, _ = x.shape
        x = x + self._positions(0, t)[None]

        if attention_mask is None:
            flash_mask = torch.ones((b, t), dtype=torch.int32, device=x.device)
        else:
            flash_mask = attention_mask[:, :t].to(torch.int32)
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
        self_mask = causal[None, None] & flash_mask[:, None, None, :].bool()

        enc = encoder_hidden_states.to(x.dtype)
        if cache is not None and cache.index != 0:
            raise ValueError("prefill needs an empty cache (index 0)")
        for layer_idx, layer in enumerate(self.layers):
            x, (k, v), (ck, cv) = layer.forward_full(x, flash_mask, self_mask, enc, encoder_attention_mask)
            if cache is not None:
                cache.self_k[layer_idx, :, :, :t] = k
                cache.self_v[layer_idx, :, :, :t] = v
                cache.cross_k[layer_idx] = ck
                cache.cross_v[layer_idx] = cv
        if cache is not None:
            cache.index = t
        return self.final_ln(x)

    def decode_step(self, input_ids: torch.Tensor, cache: KVCache, *,
                    encoder_attention_mask: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """One cached step: ``input_ids`` (B, K, 1) at fused position
        ``cache.index``; ``attention_mask`` (B, >= index+1) is the fused mask.
        Returns (B, 1, H) and advances the cache index."""
        x = self.embed_codebooks(input_ids) + self._positions(cache.index, 1)[None]
        for layer_idx, layer in enumerate(self.layers):
            x = layer.forward_decode(x, cache, layer_idx, attention_mask, encoder_attention_mask)
        cache.index += 1
        return self.final_ln(x)

    def logits(self, hidden: torch.Tensor, num_labels: int | None = None) -> torch.Tensor:
        """Fused K heads: (B, T, H) -> (B, K, T', V), projecting only the last
        ``num_labels`` positions when given."""
        if num_labels is not None:
            hidden = hidden[:, -num_labels:]
        return torch.einsum("bth,khv->bktv", hidden, self.lm_heads.kernel.to(hidden.dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0, initializer_factor) for linears and embeddings, ones and
        zeros for the layer norms, as the JAX ``init``."""
        std = self.cfg.initializer_factor
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
