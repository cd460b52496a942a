"""The LFM2 block family as Parler-TTS's codec decoder (``DecoderConfig.
block_type == "lfm2"``; no JAX counterpart, its yardstick is
``perfbench/reference/lfm2.py``).

Published LFM2 / LFM2-MoE blocks (LiquidAI), each pre-RMSNorm with a
residual, in ``layer_types`` order:

* a gated short convolution (``conv``): ``in_proj`` H -> 3H splits into B,
  C, x; a depthwise causal convolution of ``conv_L_cache`` taps over B*x,
  no bias; C times that; ``out_proj``;
* GQA attention (``full_attention``): heads of ``head_dim``, ``num_key_value_heads``
  K/V heads each shared by a group of query heads, RMSNorm on q and k per
  head, RoPE (rotate-half, ``rope_theta``) at the fused position, causal;
* a feed-forward: SwiGLU of width ``intermediate_size`` in the first
  ``num_dense_layers`` layers, then the sigmoid-routed experts of
  ``ops/moe.py`` (``num_experts`` of width ``moe_intermediate_size``,
  ``num_experts_per_tok`` a token);
* a final RMSNorm, eps ``norm_eps`` everywhere.

What Parler adds, as in its MusicGen decoder (``models/decoder.py``): the
summed codebook tables and the prompt's embeddings in front of them in
place of the text embedding, K LM heads, and in every block a
cross-attention sublayer to the projected text-encoder states (RMSNorm,
multi-head, bias-free) between the operator and the feed-forward.  There is
no position table: RoPE counts positions over the fused prompt + audio
sequence.  Prompt padding (on the left) is masked as a key and zeroed as
the convolution's input, so a row's result does not depend on it.

The cache (``decoder.KVCache``) holds self K/V for the attention layers
only, at the K/V heads, the cross K/V of every layer, and each conv layer's
state: B*x at the last ``conv_L_cache - 1`` positions, seeded by the
prefill.  A decode step writes both in place (K/V at its position; the conv
state shifted by one), so a step whose position is not kept must not run
while a stream it serves is unfinished: the decode loop runs such steps only
once every stream has finished.  The prefill attends through K1 with K/V
repeated to the query heads; the step's self attention is K5 over the
grouped cache, its cross attention K5 over the cross K/V, its experts the
grouped route.

Not built for this family (they raise ``NotImplementedError``): int8
weights or cache, a model group (tensor parallelism) and training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from parler_tts_tpu_torch.core.config import DecoderConfig
from parler_tts_tpu_torch.models.decoder import DecodeParams, DecoderAttention, KVCache, ParlerDecoder
from parler_tts_tpu_torch.ops import moe
from parler_tts_tpu_torch.ops.decode_attention import decode_attention
from parler_tts_tpu_torch.ops.flash_attention import flash_attention_bhtd
from parler_tts_tpu_torch.ops.nn import Dense, DenseWeight, RMSNorm, attention_scores, merge_heads, split_heads


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x (B, H, T, D) at ``positions`` (T,), in fp32,
    returned in x's dtype."""
    d = x.shape[-1]
    inv_freq = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    angles = positions.to(torch.float32)[:, None] * inv_freq[None]
    cos, sin = torch.cos(angles).repeat(1, 2), torch.sin(angles).repeat(1, 2)
    x32 = x.float()
    half = torch.cat([-x32[..., d // 2:], x32[..., : d // 2]], dim=-1)
    return (x32 * cos + half * sin).to(x.dtype)


class ShortConv(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.in_proj, self.out_proj = Dense(h, 3 * h), Dense(h, h)
        self.conv = nn.Module()
        self.conv.kernel = nn.Parameter(torch.empty(cfg.conv_L_cache, h))  # (taps, channels)

    def gates(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T, H) normed input -> (B*x, C)."""
        b, c, x = self.in_proj(h).chunk(3, dim=-1)
        return b * x, c

    def mix(self, window: torch.Tensor) -> torch.Tensor:
        """(B, T + L - 1, H) B*x with its L - 1 earlier positions -> (B, T, H):
        the causal depthwise convolution, summed in fp32."""
        taps = self.conv.kernel.float()
        t = window.shape[1] - taps.shape[0] + 1
        return sum(window[:, j:j + t].float() * taps[j] for j in range(taps.shape[0])).to(window.dtype)


class GQAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        h, d = cfg.hidden_size, cfg.head_dim
        self.heads, self.kv_heads, self.head_dim, self.theta = (cfg.num_attention_heads, cfg.num_key_value_heads, d,
                                                                cfg.rope_theta)
        self.scale = d**-0.5
        self.q, self.k, self.v = Dense(h, h), Dense(h, self.kv_heads * d), Dense(h, self.kv_heads * d)
        self.o = Dense(h, h)
        self.q_norm, self.k_norm = RMSNorm(d, cfg.norm_eps), RMSNorm(d, cfg.norm_eps)

    def project(self, h: torch.Tensor, positions: torch.Tensor):
        """(B, T, H) -> pre-scaled q (B, heads, T, D), k and v (B, kv_heads,
        T, D): q and k normed per head (on the projection's contiguous
        (B, T, heads, D) rows, before the heads move in front of T) and
        rotated."""
        q = rope(self.q_norm(self.q(h).unflatten(-1, (self.heads, -1))).transpose(1, 2), positions, self.theta)
        k = rope(self.k_norm(self.k(h).unflatten(-1, (self.kv_heads, -1))).transpose(1, 2), positions, self.theta)
        return q * self.scale, k, split_heads(self.v(h), self.kv_heads)


class SwiGLU(nn.Module):
    def __init__(self, h: int, f: int):
        super().__init__()
        self.w13, self.w2 = Dense(h, 2 * f), Dense(f, h)  # [gate | up]

    def forward(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        g, u = self.w13(x).chunk(2, dim=-1)
        return self.w2(F.silu(g) * u)


class MoE(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        h, f, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
        self.k, self.norm_topk_prob, self.scaling = (cfg.num_experts_per_tok, cfg.norm_topk_prob,
                                                     cfg.routed_scaling_factor)
        self.router = Dense(h, e)
        self.expert_bias = nn.Parameter(torch.zeros(e)) if cfg.use_expert_bias else None
        self.w13 = nn.Parameter(torch.empty(e, h, 2 * f))  # each expert's [gate | up]
        self.w2 = nn.Parameter(torch.empty(e, f, h))

    def forward(self, x: torch.Tensor, stats: torch.Tensor | None = None) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        weights, experts = moe.route(flat, self.router.kernel, self.expert_bias, self.k,
                                     norm_topk_prob=self.norm_topk_prob, scaling=self.scaling)
        return moe.experts(flat, self.w13, self.w2, weights, experts, stats).view(x.shape)


class LFM2Layer(nn.Module):
    def __init__(self, cfg: DecoderConfig, index: int):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.norm_eps
        self.kind = cfg.layer_types[index]
        self.operator_norm, self.cross_norm, self.ffn_norm = RMSNorm(h, eps), RMSNorm(h, eps), RMSNorm(h, eps)
        if self.kind == "conv":
            self.conv = ShortConv(cfg)
        else:
            self.self_attn = GQAttention(cfg)
        self.cross_attn = DecoderAttention(cfg)
        self.feed_forward = SwiGLU(h, cfg.intermediate_size) if index < cfg.num_dense_layers else MoE(cfg)

    def _cross_and_ffn(self, x, cross_q_and_attend, stats):
        ca = self.cross_attn
        if cross_q_and_attend is not None:
            q = split_heads(ca.q(self.cross_norm(x)), ca.num_heads) * ca.scale
            x = x + ca.o(merge_heads(cross_q_and_attend(q)))
        return x + self.feed_forward(self.ffn_norm(x), stats)

    def forward_full(self, x, positions, valid, flash_mask, enc, enc_mask, stats):
        """(B, T, H) over the fused sequence.  Returns (x, the operator's
        state: (k, v) at the K/V heads or the conv's B*x (B, T, H), cross
        K/V or None)."""
        h = self.operator_norm(x)
        if self.kind == "conv":
            bx, c = self.conv.gates(h)
            state = bx = bx * valid[..., None].to(bx.dtype)
            y = self.conv.mix(F.pad(bx, (0, 0, self.conv.conv.kernel.shape[0] - 1, 0)))
            x = x + self.conv.out_proj(c * y)
        else:
            sa = self.self_attn
            q, k, v = sa.project(h, positions)
            state = (k, v)
            group = sa.heads // sa.kv_heads
            out = flash_attention_bhtd(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1), flash_mask,
                                       scale=1.0, causal=True)
            x = x + sa.o(merge_heads(out))
        cross_kv = attend = None
        if enc is not None:
            ca = self.cross_attn
            cross_kv = split_heads(ca.k(enc), ca.num_heads), split_heads(ca.v(enc), ca.num_heads)

            def attend(q):
                return attention_scores(q, *cross_kv, mask=enc_mask[:, None, None, :].bool())
        return self._cross_and_ffn(x, attend, stats), state, cross_kv

    def forward_decode(self, x, cache: KVCache, slot: int, layer: int, position, kv_mask, enc_mask, stats):
        """One cached token (B, 1, H) at fused ``position`` ((1,) on the
        device); ``slot`` is the layer's index among its kind's layers."""
        h = self.operator_norm(x)
        if self.kind == "conv":
            bx, c = self.conv.gates(h)
            window = torch.cat([cache.conv[slot], bx], dim=1)
            cache.conv[slot].copy_(window[:, 1:])
            x = x + self.conv.out_proj(c * self.conv.mix(window))
        else:
            sa = self.self_attn
            q, k, v = sa.project(h, position)
            cache.self_k[slot].index_copy_(2, position, k)
            cache.self_v[slot].index_copy_(2, position, v)
            r = kv_mask.shape[1]
            out = decode_attention(q, cache.self_k[slot, :, :, :r], cache.self_v[slot, :, :, :r], kv_mask)
            x = x + sa.o(merge_heads(out))
        attend = None
        if cache.cross_k is not None:
            def attend(q):
                return decode_attention(q, cache.cross_k[layer], cache.cross_v[layer], enc_mask)
        return self._cross_and_ffn(x, attend, stats)


class LFM2Decoder(nn.Module):
    """The decoder's interface to ``generation/generate.py`` is
    ``ParlerDecoder``'s: ``forward`` (with a cache: the prefill), ``step``,
    ``decode_step``, ``logits``, ``decode_params``, ``check_positions``.  ``moe_stats``
    ((3,) int64 on the device: routed pairs, experts touched summed over
    MoE calls, pairs dropped) counts from each prefill on; ``generate``
    reads it once a call."""

    model_group = None
    family = "LFM2"  # as refusals name it

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        k, h = cfg.num_codebooks, cfg.hidden_size
        self.embed_tokens = nn.Module()
        self.embed_tokens.embedding = nn.Parameter(torch.empty(k, cfg.vocab_size + 1, h))
        self.layers = nn.ModuleList(LFM2Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(h, cfg.norm_eps)
        self.lm_heads = nn.Module()
        self.lm_heads.kernel = nn.Parameter(torch.empty(k, h, cfg.vocab_size))
        self.register_buffer("moe_stats", torch.zeros(3, dtype=torch.int64), persistent=False)
        kinds = cfg.layer_types
        self.slots = [kinds[:i].count(kind) for i, kind in enumerate(kinds)]

    embed_codebooks = ParlerDecoder.embed_codebooks
    logits = ParlerDecoder.logits
    decode_step = ParlerDecoder.decode_step

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.embedding.dtype

    @property
    def num_heads(self) -> int:
        """The self K/V heads a cache holds."""
        return self.cfg.num_key_value_heads

    def check_positions(self, end: int) -> None:
        if end > self.cfg.max_position_embeddings:
            raise ValueError(f"positions up to {end} exceed max_position_embeddings={self.cfg.max_position_embeddings}")

    def forward(self, input_ids: torch.Tensor, *, encoder_hidden_states: torch.Tensor | None = None,
                encoder_attention_mask: torch.Tensor | None = None,
                prompt_hidden_states: torch.Tensor | None = None, attention_mask: torch.Tensor | None = None,
                cache: KVCache | None = None, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None, train_random=None, remat: bool = False,
                prompt_positions: torch.Tensor | None = None) -> torch.Tensor:
        """``ParlerDecoder.forward``'s contract, in eval mode only: with a
        cache at index 0 this is the prefill, which writes every layer's
        state and zeroes ``moe_stats`` first.  ``prompt_positions`` is not
        read: RoPE counts the sequence as given (``generate``'s prefill moves
        each prompt against its BOS frame, so the convolution there reads
        the prompt's last tokens and RoPE sees their true distance).
        Returns the final-normed hidden states (B, T_fused, H)."""
        if generator is not None or train_random is not None or remat:
            raise NotImplementedError("training the LFM2 block family")
        dtype = dtype or self.dtype
        x = self.embed_codebooks(input_ids, dtype)
        if prompt_hidden_states is not None:
            x = torch.cat([prompt_hidden_states.to(dtype), x], dim=1)
        b, t, _ = x.shape
        self.check_positions(t)
        flash_mask = (torch.ones((b, t), dtype=torch.int32, device=x.device) if attention_mask is None
                      else attention_mask[:, :t].to(torch.int32))
        valid = flash_mask.bool()
        positions = torch.arange(t, device=x.device)
        enc = None if encoder_hidden_states is None else encoder_hidden_states.to(dtype)
        if cache is not None:
            if cache.index != 0:
                raise ValueError("prefill needs an empty cache (index 0)")
            if (enc is None) != (cache.cross_k is None):
                raise ValueError("the cache's cross K/V and the encoder states must come together")
            self.moe_stats.zero_()
        for i, layer in enumerate(self.layers):
            x, state, cross_kv = layer.forward_full(x, positions, valid, flash_mask, enc, encoder_attention_mask,
                                                    self.moe_stats)
            if cache is None:
                continue
            slot = self.slots[i]
            if layer.kind == "conv":
                tail = cache.conv.shape[2]
                cache.conv[slot] = F.pad(state, (0, 0, max(tail - t, 0), 0))[:, -tail:]
            else:
                cache.self_k[slot, :, :, :t], cache.self_v[slot, :, :, :t] = state
            if cross_kv is not None:
                cache.cross_k[i], cache.cross_v[i] = cross_kv
        if cache is not None:
            cache.index = t
        return self.final_norm(x)

    def decode_params(self, int8: bool = False) -> DecodeParams:
        """The step reads the layers' own weights: the view holds only the
        LM heads (the decode loop keeps a copy of them)."""
        if int8:
            raise NotImplementedError("int8 weights for the LFM2 block family")
        return DecodeParams([], DenseWeight(self.lm_heads.kernel))

    def step(self, input_ids: torch.Tensor, cache: KVCache, position: torch.Tensor, read_len: int, *,
             params: DecodeParams, attention_mask: torch.Tensor,
             encoder_attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``ParlerDecoder.step``'s contract: one cached step at fused
        ``position`` (a device tensor), the self K/V read over ``[0,
        read_len)``, nothing read on the host.  Returns (B, 1, H)."""
        position = position.view(1)
        x = self.embed_codebooks(input_ids)
        keys = torch.arange(read_len, device=position.device)
        kv_mask = attention_mask[:, :read_len].bool() & (keys <= position)
        for i, layer in enumerate(self.layers):
            x = layer.forward_decode(x, cache, self.slots[i], i, position, kv_mask, encoder_attention_mask,
                                     self.moe_stats)
        return self.final_norm(x)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0, initializer_factor) for the kernels, tables and
        experts; ones for the norms' scales, zeros for the expert bias."""
        std = self.cfg.initializer_factor
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith("expert_bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
