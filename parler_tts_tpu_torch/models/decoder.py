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
  single-token decode runs over the decode parameter view
  (``decode_params``: fused q/k/v, optionally int8), its self and cross
  attention through the decode attention kernel
  (``ops/decode_attention.py``, K5) over an unquantized cache and through
  plain PyTorch (``_attend``) over an int8 one;
* the forward takes a compute dtype apart from the parameters' (fp32
  parameters, bf16 activations in training) and, in train mode, dropout at
  the JAX sites (embedded sequence, residual branches, FFN activation and,
  when ``attention_dropout > 0``, the attention probabilities on the plain
  score-materialising path), layerdrop and per-layer recomputation
  (``torch.utils.checkpoint``).

Train mode is entered by passing a ``generator`` (the JAX ``train_key``).
Its draws seed one device generator per layer inside the layer, so a
recomputed layer replays its dropout masks.  A captured train step
(``training/step.py``) makes the same draws on the host and passes them as
a ``TrainRandom``: generators made once per signature and seeded before
each replay, and layerdrop as a mask on the device over layers that all
run.  Torch's random bits are not JAX's: masks agree in distribution, not
value.

The KV cache is not the JAX package's: its time-minor ``(L, B, H, D, T)``
buffers, staged flushes and physically grown buckets exist for the TPU's
tiling.  Here the self K/V is one ``(L, B, H, T_max, D)`` pair allocated
once at ``prompt_len + max_length`` and written in place.  A decode step
(``ParlerDecoder.step``) takes its fused position as a device tensor and
reads the cache over a static length, its KV-read bucket's, with the
positions at or past its own masked, as JAX's bucket reads are: one step is
then one set of shapes for a whole bucket, which a CUDA graph can capture.
With ``kv_dtype="int8"`` every K/V row is stored as int8 with a
per-position bf16 scale (JAX ``_store_kv``); the decode folds the scales
out of both products and attends to its own position unquantized, as JAX
does.

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
from parler_tts_tpu_torch.ops.decode_attention import decode_attention
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


class SeededRng(NamedTuple):
    """An eager layer's dropout in train mode: each (re)computation of the
    layer makes its generator anew from ``seed``, so a recomputed layer
    draws its forward's masks.  Split over a model group, the split
    activations draw from a second generator seeded by (``seed``, model
    rank)."""

    seed: int

    def generators(self, device: torch.device, group) -> tuple[torch.Generator, torch.Generator]:
        gen = torch.Generator(device=device).manual_seed(self.seed)
        if group is None:
            return gen, gen
        return gen, torch.Generator(device=device).manual_seed(hash((self.seed, group.index)) % 2**62)


class ReplayedRng:
    """A captured layer's dropout in train mode: generators made once per
    captured signature, which the caller seeds with the layer's seed before
    each run (a graph replays their draws from their state at replay).  The
    layer's computations take them in turn: its forward the first and, with
    remat, its recomputation the second, so both draw the same masks.  The
    caller sets ``calls`` to 0 before each run.  Unsplit layers only."""

    def __init__(self, generators: list[torch.Generator]):
        self.gens, self.calls = generators, 0

    def generators(self, device: torch.device, group) -> tuple[torch.Generator, torch.Generator]:
        if group is not None:
            raise ValueError("a split layer draws from seeded generators")
        gen = self.gens[self.calls % len(self.gens)]
        self.calls += 1
        return gen, gen


def train_draws(generator: torch.Generator, layers: int, layerdrop: float) -> tuple[list[int], list[bool] | None]:
    """Train mode's draws from the step's host ``generator``: a seed for
    each layer's dropout and one for the embedded sequence's, then, with
    ``layerdrop``, whether each layer runs (None: all run)."""
    seeds = torch.randint(0, 2**62, (layers + 1,), generator=generator, device=generator.device).tolist()
    if layerdrop <= 0.0:
        return seeds, None
    return seeds, (torch.rand(layers, generator=generator, device=generator.device) >= layerdrop).tolist()


@dataclasses.dataclass
class TrainRandom:
    """Train mode's randomness for one forward: an rng per layer, one for
    the embedded sequence (``SeededRng`` or ``ReplayedRng``), and which
    layers layerdrop keeps: None (all), a list (the others are skipped) or
    a (layers,) bool tensor on the device (every layer runs and the mask
    picks its output or its input, as JAX does: a captured step's work
    cannot depend on the draw)."""

    layers: list
    embed: SeededRng | ReplayedRng
    keep: list[bool] | torch.Tensor | None = None

    @classmethod
    def drawn(cls, generator: torch.Generator, layers: int, layerdrop: float) -> "TrainRandom":
        """The eager step's, drawn from its host ``generator``."""
        seeds, keep = train_draws(generator, layers, layerdrop)
        return cls([SeededRng(s) for s in seeds[:layers]], SeededRng(seeds[layers]), keep)


@dataclasses.dataclass
class KVCache:
    """Decode cache.  ``self_k``/``self_v`` ``(L, B, H, T_max, D)`` hold the
    keys/values of fused positions ``[0, index)`` and are updated in place;
    ``cross_k``/``cross_v`` ``(L, B, H, S, D)`` are written once at prefill,
    or are None when the decoder runs without cross-attention.  In an int8
    cache the ``*_scale`` buffers ``(L, B, H, T)`` hold each row's bf16
    scale; they are None otherwise.  ``index`` is the prefill's length,
    advanced by ``ParlerDecoder.decode_step``; ``ParlerDecoder.step`` takes
    its position from the caller and leaves ``index`` alone.  The LFM2
    family (``models/lfm2.py``) keeps self K/V for its attention layers only,
    at its K/V heads, and ``conv`` ``(L_conv, B, conv_L_cache - 1, H)``: each
    conv layer's last inputs.  The Nemotron-H family (``models/nemotron_h.py``)
    keeps self and cross K/V for its attention blocks only, ``conv`` ``(L_mamba,
    B, conv_kernel - 1, conv channels)`` and ``ssm`` ``(L_mamba, B, heads, head
    dim, state size)`` in fp32: each Mamba layer's state."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor | None
    cross_v: torch.Tensor | None
    self_k_scale: torch.Tensor | None = None
    self_v_scale: torch.Tensor | None = None
    cross_k_scale: torch.Tensor | None = None
    cross_v_scale: torch.Tensor | None = None
    index: int = 0
    conv: torch.Tensor | None = None
    ssm: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        """Bytes of every buffer the cache holds."""
        return sum(self.nbytes_by_kind().values())

    def nbytes_by_kind(self) -> dict[str, int]:
        """Bytes the cache holds as K/V (self and cross, scales included),
        as convolution state and as SSM state."""
        kv = _nbytes(self.self_k, self.self_v, self.cross_k, self.cross_v, self.self_k_scale, self.self_v_scale,
                     self.cross_k_scale, self.cross_v_scale)
        return {"kv": kv, "conv": _nbytes(self.conv), "ssm": _nbytes(self.ssm)}

    def step_bytes(self, read_len: int) -> dict[str, int]:
        """Bytes of state one decode step moves: the self K/V (scales
        included) read over ``[0, read_len)`` and the cross K/V; the conv
        state read; the SSM state read and written."""
        self_kv = _nbytes(self.self_k, self.self_v, self.self_k_scale, self.self_v_scale)
        cross = _nbytes(self.cross_k, self.cross_v, self.cross_k_scale, self.cross_v_scale)
        return {"kv": cross + self_kv * read_len // self.self_k.shape[3], "conv": _nbytes(self.conv),
                "ssm": 2 * _nbytes(self.ssm)}


def _nbytes(*tensors: torch.Tensor | None) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    if cfg.block_type == "lfm2":
        return _init_lfm2_cache(cfg, batch, max_len, enc_len, dtype=dtype, device=device, kv_dtype=kv_dtype)
    if cfg.block_type == "nemotron_h":
        return _init_nemotron_h_cache(cfg, batch, max_len, enc_len, dtype=dtype, device=device, kv_dtype=kv_dtype)
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


def _init_lfm2_cache(cfg: DecoderConfig, batch: int, max_len: int, enc_len: int, *, dtype: torch.dtype,
                     device: torch.device, kv_dtype: str | None) -> KVCache:
    """The LFM2 family's cache: self K/V of its attention layers at the K/V
    heads, cross K/V of every layer at the query heads, conv state."""
    if kv_dtype is not None:
        raise NotImplementedError("an int8 cache for the LFM2 block family")
    attn, d = cfg.layer_types.count("full_attention"), cfg.head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def cross():
        return zeros(cfg.num_hidden_layers, batch, cfg.num_attention_heads, enc_len, d) if enc_len else None

    return KVCache(zeros(attn, batch, cfg.num_key_value_heads, max_len, d),
                   zeros(attn, batch, cfg.num_key_value_heads, max_len, d), cross(), cross(),
                   conv=zeros(cfg.num_hidden_layers - attn, batch, cfg.conv_L_cache - 1, cfg.hidden_size))


def _init_nemotron_h_cache(cfg: DecoderConfig, batch: int, max_len: int, enc_len: int, *, dtype: torch.dtype,
                           device: torch.device, kv_dtype: str | None) -> KVCache:
    """The Nemotron-H family's cache: self K/V at the K/V heads and cross
    K/V at the query heads of its attention blocks, each Mamba layer's conv
    state in ``dtype`` and its SSM state in fp32."""
    if kv_dtype is not None:
        raise NotImplementedError("an int8 cache for the Nemotron-H block family")
    attn, mamba, d = cfg.layer_types.count("attention"), cfg.layer_types.count("mamba"), cfg.head_dim

    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def cross():
        return zeros(attn, batch, cfg.num_attention_heads, enc_len, d) if enc_len else None

    return KVCache(zeros(attn, batch, cfg.num_key_value_heads, max_len, d),
                   zeros(attn, batch, cfg.num_key_value_heads, max_len, d), cross(), cross(),
                   conv=zeros(mamba, batch, cfg.conv_kernel - 1, cfg.mamba_conv_dim),
                   ssm=zeros(mamba, batch, cfg.mamba_num_heads, cfg.mamba_head_dim, cfg.ssm_state_size,
                             dtype=torch.float32))


def _put(buf: torch.Tensor, scales: torch.Tensor | None, layer: int, pos: slice | torch.Tensor,
         values: torch.Tensor) -> None:
    """Write K or V ``values`` (B, H, t, D) at positions ``pos`` of layer
    ``layer``: a slice (the prefill), or a (1,) index tensor on the device (a
    decode step, written by ``index_copy_``).  As they are, or int8 with
    bf16 scales (rounded to bf16 before they are stored, as JAX does) when
    the cache is int8."""
    s = None
    if scales is not None:
        values, s = quantize_kv(values)
        s = s.to(scales.dtype)
    if isinstance(pos, torch.Tensor):
        buf[layer].index_copy_(2, pos, values)
        if s is not None:
            scales[layer].index_copy_(2, pos, s)
        return
    buf[layer, :, :, pos] = values
    if s is not None:
        scales[layer, :, :, pos] = s


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
            k_scale: torch.Tensor, v_scale: torch.Tensor,
            current: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Single-query attention over an int8 cache's (B, H, S, D) K/V; ``mask``
    (B, S) (an unquantized cache takes ``decode_attention``).  The scales
    ``k_scale``/``v_scale`` (B, H, S) fold out of both products: the key
    scale multiplies the fp32 scores, the value scale the fp32
    probabilities, which are then cast to the compute dtype (JAX
    ``_self_attention_decode`` / ``_cross_attention_decode``).  ``current``
    = (k, v) of the query's own position (B, H, 1, D) adds that position
    unquantized, as one more key after the cached ones."""
    dtype = q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * k_scale.float()[:, :, None, :]
    scores = scores.masked_fill(~mask[:, None, None, :].bool(), NEG_INF)
    if current is not None:
        scores = torch.cat([scores, (q.float() * current[0].float()).sum(-1, keepdim=True)], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    p_cached = probs[..., : k.shape[2]] * v_scale.float()[:, :, None, :]
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

    def forward_full(self, x, flash_mask, self_mask, enc, enc_mask, rng: SeededRng | ReplayedRng | None = None):
        """Full-sequence layer.  Returns (x, self K/V, cross K/V or None when
        ``enc`` is None).  ``rng`` (train mode) gives this layer's dropout
        generators: one for the replicated activations, one for the split
        ones (the same unless the layer is split).  ``enc`` must come
        through ``tp.copy`` when the layer is split (``ParlerDecoder``
        does that once for every layer)."""
        group = self.model_group
        gen = split_gen = None
        if rng is not None:
            gen, split_gen = rng.generators(x.device, group)
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

    def forward_decode(self, x, cache: KVCache, layer: int, position: torch.Tensor, kv_mask, enc_mask,
                       p: DecodeLayer):
        """One cached token at fused ``position`` ((1,) on the device) with
        the decode weights ``p``, reading the self K/V over ``kv_mask``'s
        static length (B, R).  An unquantized cache is written first and read
        with ``kv_mask`` covering ``[0, position]``; an int8 cache is read
        with it covering ``[0, position)``, the new position attended
        unquantized, then written."""
        n, r = self.self_attn.num_heads, kv_mask.shape[1]
        q, k, v = (split_heads(t, n) for t in p.qkv(self.ln_self(x)).chunk(3, dim=-1))
        q = q * self.self_attn.scale
        if cache.self_k_scale is None:
            _put(cache.self_k, None, layer, position, k)
            _put(cache.self_v, None, layer, position, v)
            out = decode_attention(q, cache.self_k[layer, :, :, :r], cache.self_v[layer, :, :, :r], kv_mask)
        else:
            out = _attend(q, cache.self_k[layer, :, :, :r], cache.self_v[layer, :, :, :r], kv_mask,
                          k_scale=cache.self_k_scale[layer, :, :, :r], v_scale=cache.self_v_scale[layer, :, :, :r],
                          current=(k, v))
            _put(cache.self_k, cache.self_k_scale, layer, position, k)
            _put(cache.self_v, cache.self_v_scale, layer, position, v)
        group = self.model_group
        x = x + tp.reduce(p.o(merge_heads(out)), group)

        if cache.cross_k is not None:
            ca = self.cross_attn
            cq = split_heads(p.cross_q(self.ln_cross(x)), ca.num_heads) * ca.scale
            if cache.cross_k_scale is None:
                out = decode_attention(cq, cache.cross_k[layer], cache.cross_v[layer], enc_mask)
            else:
                out = _attend(cq, cache.cross_k[layer], cache.cross_v[layer], enc_mask,
                              k_scale=cache.cross_k_scale[layer], v_scale=cache.cross_v_scale[layer])
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

    def check_positions(self, end: int) -> None:
        """Raise unless fused positions ``[0, end)`` have embeddings."""
        if end > self.positions.shape[0]:
            raise ValueError(f"positions up to {end} exceed max_position_embeddings={self.positions.shape[0]}")

    def _positions(self, start: int, length: int, dtype: torch.dtype | None = None) -> torch.Tensor:
        self.check_positions(start + length)
        return self.positions[start : start + length].to(dtype or self.dtype)

    def forward(self, input_ids: torch.Tensor, *, encoder_hidden_states: torch.Tensor | None = None,
                encoder_attention_mask: torch.Tensor | None = None,
                prompt_hidden_states: torch.Tensor | None = None,
                attention_mask: torch.Tensor | None = None,
                cache: KVCache | None = None,
                dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None,
                train_random: TrainRandom | None = None,
                remat: bool = False,
                prompt_positions: torch.Tensor | None = None) -> torch.Tensor:
        """Full-sequence forward over the fused (prompt + codes) sequence.

        ``input_ids`` (B, K, T); ``attention_mask`` (B, >= T_fused) covers the
        fused sequence, 1 = valid (None = all valid).  Without
        ``encoder_hidden_states`` no layer runs cross-attention.  With a
        ``cache`` at index 0 this is the prefill: every layer's self K/V and
        cross K/V are written to it (int8 when the cache is; the layers
        themselves attend over unquantized K/V) and its index advances to
        ``T_fused``.  ``dtype`` is the compute dtype (None = the
        parameters').  Without a cache, ``generator`` turns on train mode
        (dropout and layerdrop; see the module docstring), drawing its
        ``TrainRandom`` from it, or ``train_random`` gives it drawn (a
        captured step's); ``remat`` recomputes each layer in the backward.
        ``prompt_positions`` (B, P) gives the prompt's positions when its
        tokens were moved (``generate``'s prefill moves each row's prompt
        against its BOS frame and keeps where each token stood).
        Returns the final-normed hidden states (B, T_fused, H)."""
        dtype = dtype or self.dtype
        x = self.embed_codebooks(input_ids, dtype)
        if prompt_hidden_states is not None:
            x = torch.cat([prompt_hidden_states.to(dtype), x], dim=1)
        b, t, _ = x.shape
        if prompt_positions is None:
            x = x + self._positions(0, t, dtype)[None]
        else:
            self.check_positions(t)
            p = prompt_positions.shape[1]
            index = torch.cat([prompt_positions, torch.arange(p, t, device=x.device).expand(b, t - p)], dim=1)
            x = x + self.positions[index].to(dtype)

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
            if generator is not None or train_random is not None or remat:
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
        if generator is not None:
            train_random = TrainRandom.drawn(generator, n, self.cfg.layerdrop)
        rngs, keep = [None] * n, None
        if train_random is not None:
            x = dropout(x, self.cfg.dropout, train_random.embed.generators(x.device, None)[0])
            rngs, keep = train_random.layers, train_random.keep
        for i, (layer, rng) in enumerate(zip(self.layers, rngs)):
            if isinstance(keep, list) and not keep[i]:  # layerdrop's per-layer Bernoulli skip
                continue
            args = (x, flash_mask, self_mask, enc, encoder_attention_mask, rng)
            if remat:  # the layer's rng replays its masks: no default-generator state to keep
                out = checkpoint(_layer_out, layer, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                out = _layer_out(layer, *args)
            x = torch.where(keep[i], out, x) if torch.is_tensor(keep) else out
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

    def step(self, input_ids: torch.Tensor, cache: KVCache, position: torch.Tensor, read_len: int, *,
             params: DecodeParams, attention_mask: torch.Tensor,
             encoder_attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """One cached step with the decode view ``params``: ``input_ids`` (B,
        K, 1) at fused ``position``, a 0-d integer tensor on the decoder's
        device below ``read_len`` and below ``max_position_embeddings`` (the
        caller checks both on the host, once).  The self K/V is read over the
        static ``[0, read_len)`` with the positions past ``position`` masked
        (and ``position`` itself in an int8 cache, which attends it
        unquantized), so every position of a KV-read bucket runs the same
        shapes and nothing here reads the device from the host.
        ``attention_mask`` (B, >= read_len) is the fused mask.
        Cross-attention runs when the cache holds cross K/V.  Writes K/V at
        ``position`` and returns (B, 1, H); ``cache.index`` is left as it
        is."""
        position = position.view(1)
        x = self.embed_codebooks(input_ids) + self.positions.index_select(0, position).to(self.dtype)[None]
        keys = torch.arange(read_len, device=position.device)
        seen = keys < position if cache.self_k_scale is not None else keys <= position
        kv_mask = attention_mask[:, :read_len].bool() & seen
        for layer_idx, (layer, p) in enumerate(zip(self.layers, params.layers)):
            x = layer.forward_decode(x, cache, layer_idx, position, kv_mask, encoder_attention_mask, p)
        return self.final_ln(x)

    def decode_step(self, input_ids: torch.Tensor, cache: KVCache, *, params: DecodeParams,
                    attention_mask: torch.Tensor,
                    encoder_attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``step`` at fused position ``cache.index``, read over ``[0,
        index]``: ``attention_mask`` (B, >= index+1) is the fused mask.
        Returns (B, 1, H) and advances the cache index."""
        self.check_positions(cache.index + 1)
        position = torch.tensor(cache.index, device=input_ids.device)
        hidden = self.step(input_ids, cache, position, cache.index + 1, params=params,
                           attention_mask=attention_mask, encoder_attention_mask=encoder_attention_mask)
        cache.index += 1
        return hidden

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
