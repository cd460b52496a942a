"""MusicGen-style multi-codebook decoder LM.

Port of ``parler_tts_tpu/models/decoder.py``:

* the K codebook tables are one ``(K, vocab+1, H)`` parameter, summed over
  codebooks; the K LM heads are one ``(K, H, V)`` parameter;
* prompt hidden states are concatenated in front of the codec-token
  embeddings and take sinusoidal position ids (``[cos | sin]`` order) over
  the fused sequence; ``embed_scale`` is never applied;
* the full/prefill forward runs its causal self-attention through the
  flash-attention kernels (``ops/flash_attention.py``: K1 forward, K4 or
  K2 + K3 backward) whenever T > 1;
* cross-attention K/V are computed once at prefill and cached; the cached
  single-token decode runs plain PyTorch attention;
* the forward takes a compute dtype apart from the parameters' (fp32
  parameters, bf16 activations in training) and, in train mode, dropout at
  the JAX sites (embedded sequence, residual branches, FFN activation and,
  when ``attention_dropout > 0``, the attention probabilities on the plain
  score-materialising path), layerdrop and per-layer recomputation
  (``torch.utils.checkpoint``).

Train mode is entered by passing a ``generator`` (the JAX ``train_key``).
Its draws seed one device generator per layer inside the layer, so a
recomputed layer replays its dropout masks.  Torch's random bits are not
JAX's: masks agree in distribution, not value.

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
from torch.utils.checkpoint import checkpoint

from parler_tts_tpu_torch.core.config import DecoderConfig
from parler_tts_tpu_torch.ops.flash_attention import flash_attention_bhtd
from parler_tts_tpu_torch.ops.nn import (
    ACTIVATIONS,
    Dense,
    LayerNorm,
    attention_scores,
    dropout,
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


def _layer_out(layer: DecoderLayer, *args) -> torch.Tensor:
    return layer.forward_full(*args)[0]


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
        self.dropout = cfg.dropout
        self.attention_dropout = cfg.attention_dropout
        self.activation_dropout = cfg.activation_dropout
        self.self_attn = DecoderAttention(cfg)
        self.ln_self = LayerNorm(h)
        self.cross_attn = DecoderAttention(cfg)
        self.ln_cross = LayerNorm(h)
        self.fc1 = Dense(h, cfg.ffn_dim)
        self.fc2 = Dense(cfg.ffn_dim, h)
        self.ln_ffn = LayerNorm(h)

    def _ffn(self, x, gen=None):
        h = dropout(self.act(self.fc1(self.ln_ffn(x))), self.activation_dropout, gen)
        return x + dropout(self.fc2(h), self.dropout, gen)

    def forward_full(self, x, flash_mask, self_mask, enc, enc_mask, seed: int | None = None):
        """Full-sequence layer.  Returns (x, self K/V, cross K/V).  ``seed``
        (train mode) seeds this layer's dropout generator."""
        gen = None if seed is None else torch.Generator(device=x.device).manual_seed(seed)
        q, k, v = self.self_attn.project(self.ln_self(x))
        attn_drop = self.attention_dropout if gen is not None else 0.0
        if q.shape[2] > 1 and not attn_drop:
            out = flash_attention_bhtd(q, k, v, flash_mask, scale=1.0, causal=True)  # q pre-scaled
        else:
            out = attention_scores(q, k, v, mask=self_mask, dropout_rate=attn_drop, generator=gen)
        x = x + dropout(self.self_attn.o(merge_heads(out)), self.dropout, gen)

        ca = self.cross_attn
        cq = split_heads(ca.q(self.ln_cross(x)), ca.num_heads) * ca.scale
        ck, cv = split_heads(ca.k(enc), ca.num_heads), split_heads(ca.v(enc), ca.num_heads)
        out = attention_scores(cq, ck, cv, mask=enc_mask[:, None, None, :].bool(), dropout_rate=attn_drop,
                               generator=gen)
        x = x + dropout(ca.o(merge_heads(out)), self.dropout, gen)
        return self._ffn(x, gen), (k, v), (ck, cv)

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

    def embed_codebooks(self, ids: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """(B, K, T) ids -> (B, T, H): one gather over the offset-flattened
        table (cast to ``dtype`` first), summed over codebooks."""
        tables = self.embed_tokens.embedding
        if dtype is not None:
            tables = tables.to(dtype)
        k, v1, h = tables.shape
        offsets = (torch.arange(k, device=ids.device, dtype=ids.dtype) * v1)[None, :, None]
        return F.embedding(ids + offsets, tables.reshape(k * v1, h)).sum(dim=1)

    def _positions(self, start: int, length: int, dtype: torch.dtype | None = None) -> torch.Tensor:
        if start + length > self.positions.shape[0]:
            raise ValueError(
                f"positions [{start}, {start + length}) exceed max_position_embeddings="
                f"{self.positions.shape[0]}"
            )
        return self.positions[start : start + length].to(dtype or self.dtype)

    def forward(self, input_ids: torch.Tensor, *, encoder_hidden_states: torch.Tensor,
                encoder_attention_mask: torch.Tensor,
                prompt_hidden_states: torch.Tensor | None = None,
                attention_mask: torch.Tensor | None = None,
                cache: KVCache | None = None,
                dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None,
                remat: bool = False) -> torch.Tensor:
        """Full-sequence forward over the fused (prompt + codes) sequence.

        ``input_ids`` (B, K, T); ``attention_mask`` (B, >= T_fused) covers the
        fused sequence, 1 = valid (None = all valid).  With a ``cache`` at
        index 0 this is the prefill: every layer's self K/V and cross K/V are
        written to it and its index advances to ``T_fused``.  ``dtype`` is
        the compute dtype (None = the parameters').  Without a cache,
        ``generator`` turns on train mode (dropout and layerdrop; see the
        module docstring) and ``remat`` recomputes each layer in the
        backward.  Returns the final-normed hidden states (B, T_fused, H)."""
        dtype = dtype or self.dtype
        x = self.embed_codebooks(input_ids, dtype)
        if prompt_hidden_states is not None:
            x = torch.cat([prompt_hidden_states.to(dtype), x], dim=1)
        b, t, _ = x.shape
        x = x + self._positions(0, t, dtype)[None]

        if attention_mask is None:
            flash_mask = torch.ones((b, t), dtype=torch.int32, device=x.device)
        else:
            flash_mask = attention_mask[:, :t].to(torch.int32)
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
        self_mask = causal[None, None] & flash_mask[:, None, None, :].bool()

        enc = encoder_hidden_states.to(dtype)
        if cache is not None:
            if cache.index != 0:
                raise ValueError("prefill needs an empty cache (index 0)")
            if generator is not None or remat:
                raise ValueError("train mode and remat run without a cache")
            for layer_idx, layer in enumerate(self.layers):
                x, (k, v), (ck, cv) = layer.forward_full(x, flash_mask, self_mask, enc, encoder_attention_mask)
                cache.self_k[layer_idx, :, :, :t] = k
                cache.self_v[layer_idx, :, :, :t] = v
                cache.cross_k[layer_idx] = ck
                cache.cross_v[layer_idx] = cv
            cache.index = t
            return self.final_ln(x)

        n = len(self.layers)
        seeds, keep = [None] * n, [True] * n
        if generator is not None:
            drawn = torch.randint(0, 2**62, (n + 1,), generator=generator, device=generator.device).tolist()
            seeds = drawn[:n]
            emb_gen = torch.Generator(device=x.device).manual_seed(drawn[n])
            x = dropout(x, self.cfg.dropout, emb_gen)
            if self.cfg.layerdrop > 0.0:  # per-layer Bernoulli skip
                draws = torch.rand(n, generator=generator, device=generator.device)
                keep = (draws >= self.cfg.layerdrop).tolist()
        for layer, seed, kept in zip(self.layers, seeds, keep):
            if not kept:
                continue
            args = (x, flash_mask, self_mask, enc, encoder_attention_mask, seed)
            if remat:
                x = checkpoint(_layer_out, layer, *args, use_reentrant=False)
            else:
                x = _layer_out(layer, *args)
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


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, decoder_input_ids: torch.Tensor,
            cfg: DecoderConfig, ignore_id: int = -100) -> torch.Tensor:
    """Per-codebook masked cross-entropy averaged over the K codebooks.

    ``logits`` (B, K, T, V), ``labels`` and ``decoder_input_ids`` (B, K, T).
    BOS labels are ignored and positions whose input is EOS are excluded, so
    one EOS per codebook counts; each codebook's mean uses its own valid
    count.  The log-softmax is fp32."""
    labels = labels.masked_fill(labels == cfg.bos_token_id, ignore_id)
    mask = (decoder_input_ids != cfg.eos_token_id) & (labels != ignore_id)
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    token_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    per_cb_sum = torch.where(mask, -token_ll, torch.zeros_like(token_ll)).sum(dim=(0, 2))
    per_cb_cnt = mask.sum(dim=(0, 2)).clamp(min=1)
    return (per_cb_sum / per_cb_cnt).mean()
