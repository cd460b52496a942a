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
* without encoder states (decoder-only generation) every layer skips its
  whole cross-attention block, ``ln_cross`` included;
* cross-attention K/V are computed once at prefill and cached; the cached
  single-token decode runs plain PyTorch attention over the decode
  parameter view (``decode_params``: fused q/k/v, optionally int8);
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
``prompt_len + max_length`` and written in place at ``index``.  With
``kv_dtype="int8"`` every K/V row is stored as int8 with a per-position
bf16 scale (JAX ``_store_kv``); the decode folds the scales out of both
products and attends to its own position unquantized, as JAX does.

Split over a model group (``parallel/mesh.shard_params``), every layer
holds its rank's heads and FFN columns, the LM heads its rank's vocabulary,
and the cache its rank's heads: the outputs of o and fc2 are summed over the
group, the logits gathered over the vocabulary (``parallel/
tensor_parallel.py``).  Dropout on replicated activations (the embedded
sequence, the residual branches) draws the same mask on every model rank;
on split ones (the FFN activation, attention probabilities) each rank draws
its own.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from parler_tts_tpu_torch.core.config import DecoderConfig
from parler_tts_tpu_torch.ops.flash_attention import flash_attention_bhtd
from parler_tts_tpu_torch.ops.nn import (
    ACTIVATIONS,
    NEG_INF,
    Dense,
    DenseWeight,
    LayerNorm,
    attention_scores,
    dropout,
    merge_heads,
    split_heads,
)
from parler_tts_tpu_torch.ops.quantization import quantize_kv
from parler_tts_tpu_torch.parallel import tensor_parallel as tp


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
    ``cross_k``/``cross_v`` ``(L, B, H, S, D)`` are written once at prefill,
    or are None when the decoder runs without cross-attention.  In an int8
    cache the ``*_scale`` buffers ``(L, B, H, T)`` hold each row's bf16
    scale; they are None otherwise."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor | None
    cross_v: torch.Tensor | None
    self_k_scale: torch.Tensor | None = None
    self_v_scale: torch.Tensor | None = None
    cross_k_scale: torch.Tensor | None = None
    cross_v_scale: torch.Tensor | None = None
    index: int = 0

    @property
    def nbytes(self) -> int:
        """Bytes of every buffer the cache holds."""
        return sum(t.numel() * t.element_size() for t in (
            self.self_k, self.self_v, self.cross_k, self.cross_v, self.self_k_scale, self.self_v_scale,
            self.cross_k_scale, self.cross_v_scale) if t is not None)


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, enc_len: int, *,
               dtype: torch.dtype, device: torch.device, kv_dtype: str | None = None,
               heads: int | None = None) -> KVCache:
    """An empty cache for ``max_len`` fused positions and ``enc_len`` encoder
    positions (0: no cross-attention) of ``heads`` heads (None: the
    config's; a model rank holds its share).  ``kv_dtype``: None stores K/V
    in ``dtype``; ``"int8"`` stores int8 rows with bf16 per-position
    scales."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    l, h, d = cfg.num_hidden_layers, heads or cfg.num_attention_heads, cfg.head_dim
    quant = kv_dtype == "int8"

    def buf(t):
        return torch.zeros((l, batch, h, t, d), dtype=torch.int8 if quant else dtype, device=device)

    def scales(t):
        return torch.zeros((l, batch, h, t), dtype=torch.bfloat16, device=device) if quant else None

    cross = enc_len > 0
    return KVCache(buf(max_len), buf(max_len), buf(enc_len) if cross else None, buf(enc_len) if cross else None,
                   scales(max_len), scales(max_len), scales(enc_len) if cross else None,
                   scales(enc_len) if cross else None)


def _put(buf: torch.Tensor, scales: torch.Tensor | None, layer: int, pos, values: torch.Tensor) -> None:
    """Write K or V ``values`` ((B, H, t, D), or (B, H, D) for one position)
    at positions ``pos`` of layer ``layer``: as they are, or int8 with bf16
    scales (rounded to bf16 before they are stored, as JAX does) when the
    cache is int8."""
    if scales is None:
        buf[layer, :, :, pos] = values
        return
    q, s = quantize_kv(values)
    buf[layer, :, :, pos] = q
    scales[layer, :, :, pos] = s.to(scales.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
            k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
            current: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Single-query attention over cached (B, H, S, D) K/V; ``mask`` (B, S).
    With ``k_scale``/``v_scale`` (B, H, S) the K/V are int8 and the scales
    fold out of both products: the key scale multiplies the fp32 scores, the
    value scale the fp32 probabilities, which are then cast to the compute
    dtype (JAX ``_self_attention_decode`` / ``_cross_attention_decode``).
    ``current`` = (k, v) of the query's own position (B, H, 1, D) adds that
    position unquantized, as one more key after the cached ones."""
    dtype = q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, :]
    scores = scores.masked_fill(~mask[:, None, None, :].bool(), NEG_INF)
    if current is not None:
        scores = torch.cat([scores, (q.float() * current[0].float()).sum(-1, keepdim=True)], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    p_cached = probs[..., : k.shape[2]]
    if v_scale is not None:
        p_cached = p_cached * v_scale.float()[:, :, None, :]
    out = torch.matmul(p_cached.to(dtype), v.to(dtype))
    if current is not None:
        out = out + probs[..., -1:].to(dtype) * current[1].to(dtype)
    return out


class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.head_dim = cfg.head_dim
        self.scale = cfg.head_dim**-0.5
        self.q, self.k, self.v, self.o = Dense(h, h), Dense(h, h), Dense(h, h), Dense(h, h)

    @property
    def num_heads(self) -> int:
        """The heads this rank holds (all of them unless split)."""
        return self.q.kernel.shape[1] // self.head_dim

    def project(self, x: torch.Tensor):
        """(B, T, H) -> pre-scaled q, k, v, each (B, heads, T, D)."""
        n = self.num_heads
        return split_heads(self.q(x), n) * self.scale, split_heads(self.k(x), n), split_heads(self.v(x), n)


class DecodeLayer(NamedTuple):
    """One layer's decode weights (JAX ``prepare_decode_params``)."""

    qkv: DenseWeight  # self q, k, v fused: (H, 3H)
    o: DenseWeight
    cross_q: DenseWeight
    cross_o: DenseWeight
    fc1: DenseWeight
    fc2: DenseWeight


class DecodeParams(NamedTuple):
    """The decode loop's view of the decoder's weights, built once per
    generation (``ParlerDecoder.decode_params``); layer norms and the
    embedding tables are read from the module."""

    layers: list[DecodeLayer]
    lm_heads: DenseWeight


class DecoderLayer(nn.Module):
    model_group: tp.ModelGroup | None = None  # set by parallel/mesh.shard_params

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

    def _ffn(self, x, gen, split_gen):
        h = dropout(self.act(self.fc1(tp.copy(self.ln_ffn(x), self.model_group))), self.activation_dropout,
                    split_gen)
        return x + dropout(tp.reduce(self.fc2(h), self.model_group), self.dropout, gen)

    def decode_weights(self, int8: bool) -> DecodeLayer:
        """Split over a model group, the fused qkv is this rank's
        ``[q_r | k_r | v_r]``; the row-split o, cross o and fc2 take their
        int8 scales over the group (every rank calls this together)."""
        sa, ca = self.self_attn, self.cross_attn
        qkv = torch.cat([sa.q.kernel, sa.k.kernel, sa.v.kernel], dim=-1)

        def of(kernel, input_split=False):
            return DenseWeight.of(kernel, int8, self.model_group if input_split else None)

        return DecodeLayer(of(qkv), of(sa.o.kernel, True), of(ca.q.kernel), of(ca.o.kernel, True), of(self.fc1.kernel),
                           of(self.fc2.kernel, True))

    def forward_full(self, x, flash_mask, self_mask, enc, enc_mask, seed: int | None = None):
        """Full-sequence layer.  Returns (x, self K/V, cross K/V or None when
        ``enc`` is None).  ``seed`` (train mode) seeds this layer's dropout
        generator; split activations draw from a second one seeded by
        (``seed``, model rank) when the layer is split.  ``enc`` must come
        through ``tp.copy`` when the layer is split (``ParlerDecoder``
        does that once for every layer)."""
        group = self.model_group
        gen = split_gen = None
        if seed is not None:
            gen = split_gen = torch.Generator(device=x.device).manual_seed(seed)
            if group is not None:
                split_gen = torch.Generator(device=x.device).manual_seed(hash((seed, group.index)) % 2**62)
        q, k, v = self.self_attn.project(tp.copy(self.ln_self(x), group))
        attn_drop = self.attention_dropout if gen is not None else 0.0
        if q.shape[2] > 1 and not attn_drop:
            out = flash_attention_bhtd(q, k, v, flash_mask, scale=1.0, causal=True)  # q pre-scaled
        else:
            out = attention_scores(q, k, v, mask=self_mask, dropout_rate=attn_drop, generator=split_gen)
        x = x + dropout(tp.reduce(self.self_attn.o(merge_heads(out)), group), self.dropout, gen)

        cross_kv = None
        if enc is not None:
            ca = self.cross_attn
            cq = split_heads(ca.q(tp.copy(self.ln_cross(x), group)), ca.num_heads) * ca.scale
            cross_kv = split_heads(ca.k(enc), ca.num_heads), split_heads(ca.v(enc), ca.num_heads)
            out = attention_scores(cq, *cross_kv, mask=enc_mask[:, None, None, :].bool(),
                                   dropout_rate=attn_drop, generator=split_gen)
            x = x + dropout(tp.reduce(ca.o(merge_heads(out)), group), self.dropout, gen)
        return self._ffn(x, gen, split_gen), (k, v), cross_kv

    def forward_decode(self, x, cache: KVCache, layer: int, kv_mask, enc_mask, p: DecodeLayer):
        """One cached token at ``cache.index`` with the decode weights ``p``.
        An unquantized cache is written first and read over ``[0, index]``;
        an int8 cache is read over ``[0, index)`` with the new position
        attended unquantized, then written."""
        i, n = cache.index, self.self_attn.num_heads
        q, k, v = (split_heads(t, n) for t in p.qkv(self.ln_self(x)).chunk(3, dim=-1))
        q = q * self.self_attn.scale
        if cache.self_k_scale is None:
            _put(cache.self_k, None, layer, i, k[:, :, 0])
            _put(cache.self_v, None, layer, i, v[:, :, 0])
            out = _attend(q, cache.self_k[layer, :, :, : i + 1], cache.self_v[layer, :, :, : i + 1],
                          kv_mask[:, : i + 1])
        else:
            out = _attend(q, cache.self_k[layer, :, :, :i], cache.self_v[layer, :, :, :i], kv_mask[:, :i],
                          k_scale=cache.self_k_scale[layer, :, :, :i], v_scale=cache.self_v_scale[layer, :, :, :i],
                          current=(k, v))
            _put(cache.self_k, cache.self_k_scale, layer, i, k[:, :, 0])
            _put(cache.self_v, cache.self_v_scale, layer, i, v[:, :, 0])
        group = self.model_group
        x = x + tp.reduce(p.o(merge_heads(out)), group)

        if cache.cross_k is not None:
            ca = self.cross_attn
            cq = split_heads(p.cross_q(self.ln_cross(x)), ca.num_heads) * ca.scale
            scales = {} if cache.cross_k_scale is None else dict(
                k_scale=cache.cross_k_scale[layer], v_scale=cache.cross_v_scale[layer])
            out = _attend(cq, cache.cross_k[layer], cache.cross_v[layer], enc_mask, **scales)
            x = x + tp.reduce(p.cross_o(merge_heads(out)), group)
        return x + tp.reduce(p.fc2(self.act(p.fc1(self.ln_ffn(x)))), group)


class ParlerDecoder(nn.Module):
    model_group: tp.ModelGroup | None = None  # set by parallel/mesh.shard_params

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

    @property
    def num_heads(self) -> int:
        """The attention heads this rank holds (all of them unless split)."""
        return self.layers[0].self_attn.num_heads

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

    def forward(self, input_ids: torch.Tensor, *, encoder_hidden_states: torch.Tensor | None = None,
                encoder_attention_mask: torch.Tensor | None = None,
                prompt_hidden_states: torch.Tensor | None = None,
                attention_mask: torch.Tensor | None = None,
                cache: KVCache | None = None,
                dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None,
                remat: bool = False) -> torch.Tensor:
        """Full-sequence forward over the fused (prompt + codes) sequence.

        ``input_ids`` (B, K, T); ``attention_mask`` (B, >= T_fused) covers the
        fused sequence, 1 = valid (None = all valid).  Without
        ``encoder_hidden_states`` no layer runs cross-attention.  With a
        ``cache`` at index 0 this is the prefill: every layer's self K/V and
        cross K/V are written to it (int8 when the cache is; the layers
        themselves attend over unquantized K/V) and its index advances to
        ``T_fused``.  ``dtype`` is the compute dtype (None = the
        parameters').  Without a cache, ``generator`` turns on train mode
        (dropout and layerdrop; see the module docstring) and ``remat``
        recomputes each layer in the backward.  Returns the final-normed
        hidden states (B, T_fused, H)."""
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

        enc = None if encoder_hidden_states is None else tp.copy(encoder_hidden_states.to(dtype), self.model_group)
        if cache is not None:
            if cache.index != 0:
                raise ValueError("prefill needs an empty cache (index 0)")
            if generator is not None or remat:
                raise ValueError("train mode and remat run without a cache")
            if (enc is None) != (cache.cross_k is None):
                raise ValueError("the cache's cross K/V and the encoder states must come together")
            for layer_idx, layer in enumerate(self.layers):
                x, (k, v), cross_kv = layer.forward_full(x, flash_mask, self_mask, enc, encoder_attention_mask)
                _put(cache.self_k, cache.self_k_scale, layer_idx, slice(0, t), k)
                _put(cache.self_v, cache.self_v_scale, layer_idx, slice(0, t), v)
                if cross_kv is not None:
                    _put(cache.cross_k, cache.cross_k_scale, layer_idx, slice(None), cross_kv[0])
                    _put(cache.cross_v, cache.cross_v_scale, layer_idx, slice(None), cross_kv[1])
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

    @torch.no_grad()
    def decode_params(self, int8: bool = False) -> DecodeParams:
        """The decode loop's weights (JAX ``prepare_decode_params``): each
        layer's self q/k/v kernels fused into one ``(H, 3H)`` projection and,
        with ``int8``, int8 copies of the fused qkv, self ``o``, cross ``q``
        and ``o``, ``fc1``, ``fc2`` and the LM heads with per-output-channel
        scales.  Embedding tables and layer norms stay as they are.  Build it
        once per generation: it copies every decode weight.  Split over a
        model group, every rank builds it at once (the int8 scales of the
        row-split kernels are a collective)."""
        return DecodeParams([layer.decode_weights(int8) for layer in self.layers],
                            DenseWeight.of(self.lm_heads.kernel, int8))

    def decode_step(self, input_ids: torch.Tensor, cache: KVCache, *, params: DecodeParams,
                    attention_mask: torch.Tensor,
                    encoder_attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """One cached step with the decode view ``params``: ``input_ids``
        (B, K, 1) at fused position ``cache.index``; ``attention_mask``
        (B, >= index+1) is the fused mask.  Cross-attention runs when the
        cache holds cross K/V.  Returns (B, 1, H) and advances the cache
        index."""
        x = self.embed_codebooks(input_ids) + self._positions(cache.index, 1)[None]
        for layer_idx, (layer, p) in enumerate(zip(self.layers, params.layers)):
            x = layer.forward_decode(x, cache, layer_idx, attention_mask, encoder_attention_mask, p)
        cache.index += 1
        return self.final_ln(x)

    def logits(self, hidden: torch.Tensor, num_labels: int | None = None,
               heads: DenseWeight | None = None) -> torch.Tensor:
        """Fused K heads: (B, T, H) -> (B, K, T', V), projecting only the last
        ``num_labels`` positions when given.  ``heads`` (the decode view's)
        may be int8: the per-(codebook, vocab) scale folds out of the H
        product.  Split over a model group, each rank projects its vocabulary
        shard and the shards are gathered."""
        if num_labels is not None:
            hidden = hidden[:, -num_labels:]
        if heads is None:
            heads = DenseWeight(self.lm_heads.kernel)
        out = torch.einsum("bth,khv->bktv", tp.copy(hidden, self.model_group), heads.kernel.to(hidden.dtype))
        if heads.scale is not None:
            out = out * heads.scale.to(hidden.dtype)[None, :, None, :]
        return tp.gather(out, -1, self.model_group)

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
            cfg: DecoderConfig, ignore_id: int = -100, count_group=None) -> torch.Tensor:
    """Per-codebook masked cross-entropy averaged over the K codebooks.

    ``logits`` (B, K, T, V), ``labels`` and ``decoder_input_ids`` (B, K, T).
    BOS labels are ignored and positions whose input is EOS are excluded, so
    one EOS per codebook counts; each codebook's mean uses its own valid
    count.  The log-softmax is fp32.

    With ``count_group`` (a data group: each rank holds some rows of the
    global batch) the valid counts are summed over the group, and the value
    is this rank's share of the global batch's loss: the shares sum to it,
    and so do their gradients.  Averaging the ranks' own means would weigh
    a token by its rank's padding."""
    labels = labels.masked_fill(labels == cfg.bos_token_id, ignore_id)
    mask = (decoder_input_ids != cfg.eos_token_id) & (labels != ignore_id)
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    token_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    per_cb_sum = torch.where(mask, -token_ll, torch.zeros_like(token_ll)).sum(dim=(0, 2))
    per_cb_cnt = mask.sum(dim=(0, 2))
    if count_group is not None:
        torch.distributed.all_reduce(per_cb_cnt, group=count_group)
    return (per_cb_sum / per_cb_cnt.clamp(min=1)).mean()
