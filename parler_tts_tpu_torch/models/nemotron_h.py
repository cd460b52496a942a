"""The Nemotron-H block family as Parler-TTS's codec decoder (``DecoderConfig.
block_type == "nemotron_h"``; no JAX counterpart, its yardstick is
``perfbench/reference/nemotron_h.py``).

Published NemotronH blocks (NVIDIA, ``hybrid_override_pattern`` as
``layer_types``), each ``x + mixer(RMSNorm(x))`` with one mixer:

* ``mamba``, a Mamba-2 mixer: ``in_proj`` H -> [z | xBC | dt] (inner, inner +
  2 G N, heads); a depthwise causal convolution of ``conv_kernel`` taps over
  xBC with a bias, SiLU; xBC splits into x (heads x head dim), B and C (G
  groups of N, head h reading group h // (heads / G)); ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the state S (heads, head dim, N) follows
  ``S_t = exp(dt A) S_{t-1} + dt x_t (x) B_t`` and ``y = S_t C_t + D x_t``;
  a gated RMSNorm (``y * silu(z)`` in fp32, normed over groups of inner / G
  channels, times its scale); ``out_proj``;
* ``attention``: GQA without positional encoding (NoPE; the Mamba layers
  carry order), ``num_attention_heads`` query heads and
  ``num_key_value_heads`` K/V heads of ``attention_head_dim``, scaled by
  its -1/2 power, causal, bias-free;
* ``moe``: ``ops/moe.py``'s sigmoid router in fp32 over ``num_experts``,
  the top ``num_experts_per_tok`` of ``s + expert_bias``, weights over their
  sum + 1e-20 times ``routed_scaling_factor``; relu2 experts
  ``down(relu(up(x))**2)`` of ``moe_intermediate_size``, and a shared relu2
  expert of ``moe_shared_expert_intermediate_size`` added for every token;
* a final RMSNorm, eps ``norm_eps`` everywhere.

Expert parallelism: the layer holds the experts ``[first_expert, first_expert
+ experts_held)`` and routes over all of them; it computes its experts' part
of the result and the whole shared expert, and pairs routed elsewhere are
counted (``moe_stats``) and left out.  On one card that partial result is
what the next layer reads.

What Parler adds, as in its MusicGen decoder (``models/decoder.py``): the
summed codebook tables and the prompt's embeddings in front of them in place
of the text embedding, K LM heads, and in each attention block a
cross-attention sublayer to the projected text-encoder states (RMSNorm,
multi-head at the attention's head dim, bias-free) after the
self-attention.  Prompt padding (moved to the front by ``generate``'s
prefill) is masked as a key and zeroed as the convolution's input and
output, so the state stays zero through it and a row's result does not
depend on it.

The cache (``decoder.KVCache``) holds self K/V at the K/V heads and cross K/V
of the attention blocks, and for each Mamba layer its conv state (xBC at the
last ``conv_kernel - 1`` positions, in the served dtype) and its SSM state in
fp32, both seeded by the prefill (the chunked SSD scan of ``ops/ssm.py`` at
``chunk_size``).  A decode step updates both in place (the conv state shifted
by one, the SSM state by K8), so a step whose position is not kept must not
run while a stream it serves is unfinished: the decode loop runs such steps
only once every stream has finished.  The prefill attends through K1 with
K/V repeated to the query heads; the step's self attention is K5 over the
grouped cache, its cross attention K5 over the cross K/V, its experts the
grouped route, its state update K8.

Not built for this family (they raise ``NotImplementedError``): int8 weights
or cache, a model group (tensor parallelism), training, ``stream_generate``
and the batching server.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from parler_tts_tpu_torch.core.config import DecoderConfig
from parler_tts_tpu_torch.models.decoder import DecodeParams, KVCache, ParlerDecoder
from parler_tts_tpu_torch.ops import moe, ssm
from parler_tts_tpu_torch.ops.decode_attention import decode_attention
from parler_tts_tpu_torch.ops.flash_attention import flash_attention_bhtd
from parler_tts_tpu_torch.ops.nn import Dense, DenseWeight, RMSNorm, attention_scores, merge_heads, split_heads

#: the moe_stats entries: routed pairs, held experts touched, pairs dropped, pairs held elsewhere
MOE_STATS = 4


class MambaMixer(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        h, heads = cfg.hidden_size, cfg.mamba_num_heads
        self.heads, self.head_dim, self.state_size = heads, cfg.mamba_head_dim, cfg.ssm_state_size
        self.groups, self.chunk, self.eps = cfg.mamba_n_groups, cfg.chunk_size, cfg.norm_eps
        self.inner, self.conv_dim = cfg.mamba_inner, cfg.mamba_conv_dim
        self.in_proj = Dense(h, self.inner + self.conv_dim + heads)
        self.conv = nn.Module()
        self.conv.kernel = nn.Parameter(torch.empty(cfg.conv_kernel, self.conv_dim))  # (taps, channels)
        self.conv.bias = nn.Parameter(torch.zeros(self.conv_dim)) if cfg.use_conv_bias else None
        self.dt_bias = nn.Parameter(torch.empty(heads))
        self.A_log = nn.Parameter(torch.empty(heads))
        self.D = nn.Parameter(torch.empty(heads))
        self.norm = RMSNorm(self.inner, cfg.norm_eps)  # the gated norm's scale
        self.out_proj = Dense(self.inner, h)

    def _split(self, zxbcdt: torch.Tensor):
        """in_proj's output -> z, xBC, dt (views)."""
        return zxbcdt.split([self.inner, self.conv_dim, self.heads], dim=-1)

    def _conv(self, window: torch.Tensor) -> torch.Tensor:
        """(B, T + taps - 1, C) xBC with its earlier positions -> SiLU of the
        causal depthwise convolution (B, T, C), summed in fp32."""
        taps = self.conv.kernel.float()
        t = window.shape[1] - taps.shape[0] + 1
        y = sum(window[:, j:j + t].float() * taps[j] for j in range(taps.shape[0]))
        if self.conv.bias is not None:
            y = y + self.conv.bias.float()
        return F.silu(y).to(window.dtype)

    def _xbc(self, act: torch.Tensor):
        n = self.groups * self.state_size
        return act.split([self.inner, n, n], dim=-1)

    def _gated_norm(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """``y * silu(z)`` in fp32, RMS-normed over each of the G groups of
        channels, times the scale; in z's dtype."""
        g = (y.float() * F.silu(z.float())).unflatten(-1, (self.groups, -1))
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + self.eps)
        return (g.flatten(-2) * self.norm.scale.float()).to(z.dtype)

    def forward_full(self, h: torch.Tensor, valid: torch.Tensor):
        """(B, T, H) normed input, ``valid`` (B, T) -> (output, (conv state
        (B, taps - 1, C), SSM state (B, heads, head dim, N) fp32))."""
        b, t, _ = h.shape
        z, xbc, dt = self._split(self.in_proj(h))
        keep = valid[..., None].to(xbc.dtype)
        window = F.pad(xbc * keep, (0, 0, self.conv.kernel.shape[0] - 1, 0))
        x, bm, cm = self._xbc(self._conv(window) * keep)
        dt, a = ssm.discretize(dt, self.dt_bias, self.A_log)
        xs = x.float().view(b, t, self.heads, self.head_dim)
        y, state = ssm.ssd_scan(xs, dt, a, bm.float().view(b, t, self.groups, -1),
                                cm.float().view(b, t, self.groups, -1), self.chunk)
        y = (y + self.D.float()[:, None] * xs).reshape(b, t, self.inner)
        return self.out_proj(self._gated_norm(y, z)), (window[:, t:], state)

    def forward_decode(self, h: torch.Tensor, conv: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """One token (B, 1, H), normed; ``conv`` and ``state`` this layer's
        cache entries, updated in place."""
        z, xbc, dt = self._split(self.in_proj(h))
        window = torch.cat([conv, xbc], dim=1)
        conv.copy_(window[:, 1:])
        x, bm, cm = self._xbc(self._conv(window)[:, 0])
        y = ssm.ssm_step(state, x, bm, cm, dt[:, 0], self.dt_bias, self.A_log, self.D)
        return self.out_proj(self._gated_norm(y[:, None], z))


class Attention(nn.Module):
    """Bias-free attention of ``heads`` query heads over ``kv_heads`` K/V
    heads of ``head_dim``; q is returned pre-scaled."""

    def __init__(self, h: int, heads: int, kv_heads: int, head_dim: int, kv_in: int | None = None):
        super().__init__()
        self.heads, self.kv_heads, self.scale = heads, kv_heads, head_dim**-0.5
        self.q, self.o = Dense(h, heads * head_dim), Dense(heads * head_dim, h)
        self.k, self.v = Dense(kv_in or h, kv_heads * head_dim), Dense(kv_in or h, kv_heads * head_dim)

    def query(self, h: torch.Tensor) -> torch.Tensor:
        return split_heads(self.q(h), self.heads) * self.scale

    def keys(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return split_heads(self.k(h), self.kv_heads), split_heads(self.v(h), self.kv_heads)


class MoE(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        h, f, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
        self.k, self.norm_topk_prob, self.scaling = (cfg.num_experts_per_tok, cfg.norm_topk_prob,
                                                     cfg.routed_scaling_factor)
        self.first = cfg.first_expert
        self.router = Dense(h, e)
        self.expert_bias = nn.Parameter(torch.zeros(e)) if cfg.use_expert_bias else None
        self.up = nn.Parameter(torch.empty(cfg.experts_held, h, f))
        self.down = nn.Parameter(torch.empty(cfg.experts_held, f, h))
        fs = cfg.moe_shared_expert_intermediate_size
        self.shared_up, self.shared_down = Dense(h, fs), Dense(fs, h)

    def forward(self, x: torch.Tensor, stats: torch.Tensor | None = None) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        weights, experts = moe.route(flat, self.router.kernel, self.expert_bias, self.k,
                                     norm_topk_prob=self.norm_topk_prob, scaling=self.scaling, fp32_logits=True,
                                     eps=1e-20)
        routed = moe.experts(flat, self.up, self.down, weights, experts, stats, act=moe.relu2, first=self.first)
        return (routed + self.shared_down(moe.relu2(self.shared_up(flat)))).view(x.shape)


class NemotronHBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, index: int):
        super().__init__()
        h = cfg.hidden_size
        self.kind = cfg.layer_types[index]
        self.norm = RMSNorm(h, cfg.norm_eps)
        if self.kind == "mamba":
            self.mixer = MambaMixer(cfg)
        elif self.kind == "moe":
            self.mixer = MoE(cfg)
        else:
            heads, d = cfg.num_attention_heads, cfg.head_dim
            self.mixer = Attention(h, heads, cfg.num_key_value_heads, d)
            self.cross_norm = RMSNorm(h, cfg.norm_eps)
            self.cross_attn = Attention(h, heads, heads, d)

    def _cross(self, x, attend):
        if attend is None:
            return x
        ca = self.cross_attn
        return x + ca.o(merge_heads(attend(ca.query(self.cross_norm(x)))))

    def forward_full(self, x, valid, flash_mask, enc, enc_mask, stats):
        """(B, T, H) over the fused sequence.  Returns (x, the mixer's state:
        (conv, ssm) of a Mamba layer, (k, v) at the K/V heads of an attention
        one, else None; cross K/V or None)."""
        h = self.norm(x)
        if self.kind == "mamba":
            out, state = self.mixer.forward_full(h, valid)
            return x + out, state, None
        if self.kind == "moe":
            return x + self.mixer(h, stats), None, None
        sa = self.mixer
        q, (k, v) = sa.query(h), sa.keys(h)
        group = sa.heads // sa.kv_heads
        out = flash_attention_bhtd(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1), flash_mask,
                                   scale=1.0, causal=True)
        x = x + sa.o(merge_heads(out))
        cross_kv = attend = None
        if enc is not None:
            cross_kv = self.cross_attn.keys(enc)

            def attend(q):
                return attention_scores(q, *cross_kv, mask=enc_mask[:, None, None, :].bool())
        return self._cross(x, attend), (k, v), cross_kv

    def forward_decode(self, x, cache: KVCache, slot: int, position, kv_mask, enc_mask, stats):
        """One cached token (B, 1, H) at fused ``position`` ((1,) on the
        device); ``slot`` is the block's index among its kind's blocks."""
        h = self.norm(x)
        if self.kind == "mamba":
            return x + self.mixer.forward_decode(h, cache.conv[slot], cache.ssm[slot])
        if self.kind == "moe":
            return x + self.mixer(h, stats)
        sa = self.mixer
        q, (k, v) = sa.query(h), sa.keys(h)
        cache.self_k[slot].index_copy_(2, position, k)
        cache.self_v[slot].index_copy_(2, position, v)
        r = kv_mask.shape[1]
        x = x + sa.o(merge_heads(decode_attention(q, cache.self_k[slot, :, :, :r], cache.self_v[slot, :, :, :r],
                                                  kv_mask)))
        attend = None
        if cache.cross_k is not None:
            def attend(q):
                return decode_attention(q, cache.cross_k[slot], cache.cross_v[slot], enc_mask)
        return self._cross(x, attend)


class NemotronHDecoder(nn.Module):
    """The decoder's interface to ``generation/generate.py`` is
    ``ParlerDecoder``'s, as ``LFM2Decoder``'s: ``forward`` (with a cache: the
    prefill), ``step``, ``decode_step``, ``logits``, ``decode_params``,
    ``check_positions``.  ``moe_stats`` ((4,) int64 on the device: routed
    pairs, held experts touched summed over MoE calls, pairs dropped, pairs
    routed to experts held elsewhere) counts from each prefill on;
    ``generate`` reads it once a call."""

    model_group = None
    family = "Nemotron-H"  # as refusals name it

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        k, h = cfg.num_codebooks, cfg.hidden_size
        self.embed_tokens = nn.Module()
        self.embed_tokens.embedding = nn.Parameter(torch.empty(k, cfg.vocab_size + 1, h))
        self.layers = nn.ModuleList(NemotronHBlock(cfg, i) for i in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(h, cfg.norm_eps)
        self.lm_heads = nn.Module()
        self.lm_heads.kernel = nn.Parameter(torch.empty(k, h, cfg.vocab_size))
        self.register_buffer("moe_stats", torch.zeros(MOE_STATS, dtype=torch.int64), persistent=False)
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
        read (no positional encoding).  Returns the final-normed hidden
        states (B, T_fused, H)."""
        if generator is not None or train_random is not None or remat:
            raise NotImplementedError("training the Nemotron-H block family")
        dtype = dtype or self.dtype
        x = self.embed_codebooks(input_ids, dtype)
        if prompt_hidden_states is not None:
            x = torch.cat([prompt_hidden_states.to(dtype), x], dim=1)
        b, t, _ = x.shape
        self.check_positions(t)
        flash_mask = (torch.ones((b, t), dtype=torch.int32, device=x.device) if attention_mask is None
                      else attention_mask[:, :t].to(torch.int32))
        valid = flash_mask.bool()
        enc = None if encoder_hidden_states is None else encoder_hidden_states.to(dtype)
        if cache is not None:
            if cache.index != 0:
                raise ValueError("prefill needs an empty cache (index 0)")
            if (enc is None) != (cache.cross_k is None):
                raise ValueError("the cache's cross K/V and the encoder states must come together")
            self.moe_stats.zero_()
        for i, layer in enumerate(self.layers):
            x, state, cross_kv = layer.forward_full(x, valid, flash_mask, enc, encoder_attention_mask,
                                                    self.moe_stats)
            if cache is None or state is None:
                continue
            slot = self.slots[i]
            if layer.kind == "mamba":
                cache.conv[slot], cache.ssm[slot] = state
            else:
                cache.self_k[slot, :, :, :t], cache.self_v[slot, :, :, :t] = state
                if cross_kv is not None:
                    cache.cross_k[slot], cache.cross_v[slot] = cross_kv
        if cache is not None:
            cache.index = t
        return self.final_norm(x)

    def decode_params(self, int8: bool = False) -> DecodeParams:
        """The step reads the layers' own weights: the view holds only the
        LM heads (the decode loop keeps a copy of them)."""
        if int8:
            raise NotImplementedError("int8 weights for the Nemotron-H block family")
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
            x = layer.forward_decode(x, cache, self.slots[i], position, kv_mask, encoder_attention_mask,
                                     self.moe_stats)
        return self.final_norm(x)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0, initializer_factor) for the kernels, tables and experts;
        ones for the norms' scales, zeros for biases and the expert bias; the
        Mamba layers at the published Mamba-2 init: A in [1, 16], dt
        log-uniform in [1e-3, 0.1] (``dt_bias`` its inverse softplus), D = 1,
        the convolution at PyTorch's default (uniform within fan-in^-1/2)."""
        std = self.cfg.initializer_factor
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale" or leaf == "D":
                p.fill_(1.0)
            elif leaf in ("bias", "expert_bias"):
                p.zero_()
            elif leaf == "A_log":
                p.copy_(torch.log(torch.empty_like(p, dtype=torch.float32).uniform_(1.0, 16.0, generator=generator)))
            elif leaf == "dt_bias":
                u = torch.empty_like(p, dtype=torch.float32).uniform_(0.0, 1.0, generator=generator)
                dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
                p.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif name.endswith("conv.kernel"):
                bound = p.shape[0] ** -0.5
                p.uniform_(-bound, bound, generator=generator)
            else:
                p.normal_(0.0, std, generator=generator)
