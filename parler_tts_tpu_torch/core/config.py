"""Typed configuration for the PyTorch port of Parler-TTS.

The port's own copy of the JAX package's frozen dataclasses
(``parler_tts_tpu/core/config.py``): the same fields, defaults and JSON
round-trip, so both packages read the same ``config.json`` /
``generation_config.json`` that ``parler_tts_tpu.core.checkpoint.save_model``
writes.  Unknown keys are ignored on load.  The composite's
``audio_encoder`` is either codec family, told apart by ``codec_type``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _fromdict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class T5EncoderConfig:
    """Flan-T5 encoder hyper-parameters (defaults = flan-t5-base)."""

    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dense_act_fn: str = "gelu_new"  # flan-t5 uses gated-gelu
    is_gated_act: bool = True
    dropout_rate: float = 0.1

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    to_dict = _asdict
    from_dict = classmethod(_fromdict)


@dataclass(frozen=True)
class DACConfig:
    """Descript Audio Codec (44.1 kHz / 8 kbps) hyper-parameters."""

    codec_type: str = "dac"
    num_codebooks: int = 9
    model_bitrate: int = 8  # kbps
    codebook_size: int = 1024
    codebook_dim: int = 8
    latent_dim: int = 1024
    frame_rate: int = 86
    sampling_rate: int = 44100
    encoder_hidden_size: int = 64
    downsampling_ratios: tuple[int, ...] = (2, 4, 8, 8)
    decoder_hidden_size: int = 1536
    upsampling_ratios: tuple[int, ...] = (8, 8, 4, 2)

    def __post_init__(self):
        object.__setattr__(self, "downsampling_ratios", tuple(self.downsampling_ratios))
        object.__setattr__(self, "upsampling_ratios", tuple(self.upsampling_ratios))

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.downsampling_ratios:
            out *= r
        return out

    to_dict = _asdict
    from_dict = classmethod(_fromdict)


@dataclass(frozen=True)
class EncodecConfig:
    """Meta EnCodec hyper-parameters (defaults = ``facebook/encodec_24khz``),
    with the field semantics of HF ``transformers.EncodecConfig``.
    ``num_codebooks`` is how many codebook streams the composite's decoder
    models (None = every quantizer); the codec's RVQ decode sums however many
    it is given."""

    codec_type: str = "encodec"
    target_bandwidths: tuple[float, ...] = (1.5, 3.0, 6.0, 12.0, 24.0)
    sampling_rate: int = 24000
    audio_channels: int = 1
    normalize: bool = False
    chunk_length_s: float | None = None
    overlap: float | None = None
    hidden_size: int = 128
    num_filters: int = 32
    num_residual_layers: int = 1
    upsampling_ratios: tuple[int, ...] = (8, 5, 4, 2)
    norm_type: str = "weight_norm"  # or "time_group_norm" (48 kHz model)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "reflect"
    compress: int = 2
    num_lstm_layers: int = 2
    trim_right_ratio: float = 1.0
    codebook_size: int = 1024
    codebook_dim: int | None = None  # None -> hidden_size
    use_conv_shortcut: bool = True
    num_codebooks: int | None = None  # None -> num_quantizers

    def __post_init__(self):
        object.__setattr__(self, "target_bandwidths", tuple(self.target_bandwidths))
        object.__setattr__(self, "upsampling_ratios", tuple(self.upsampling_ratios))
        if self.codebook_dim is None:
            object.__setattr__(self, "codebook_dim", self.hidden_size)
        if self.num_codebooks is None:
            object.__setattr__(self, "num_codebooks", self.num_quantizers)
        if self.norm_type not in ("weight_norm", "time_group_norm"):
            raise ValueError(f"norm_type must be weight_norm|time_group_norm, got {self.norm_type}")

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsampling_ratios)

    @property
    def frame_rate(self) -> int:
        return -(-self.sampling_rate // self.hop_length)  # ceil

    @property
    def codebook_nbits(self) -> int:
        return max(1, (self.codebook_size - 1).bit_length())

    @property
    def num_quantizers(self) -> int:
        """Codebooks the codec carries (HF ``EncodecConfig.num_quantizers``),
        a float floor division as HF's: 32 at 24 kHz."""
        return int(1000 * self.target_bandwidths[-1] // (self.frame_rate * self.codebook_nbits))

    @property
    def chunk_length(self) -> int | None:
        return None if self.chunk_length_s is None else int(self.chunk_length_s * self.sampling_rate)

    @property
    def chunk_stride(self) -> int | None:
        if self.chunk_length_s is None or self.overlap is None:
            return None
        return max(1, int((1.0 - self.overlap) * self.chunk_length))

    to_dict = _asdict
    from_dict = classmethod(_fromdict)


def _codec_from_dict(d: dict) -> DACConfig | EncodecConfig:
    return (EncodecConfig if d.get("codec_type") == "encodec" else DACConfig).from_dict(d)


@dataclass(frozen=True)
class DecoderConfig:
    """The MusicGen-style codec-token decoder LM (defaults = Mini v0.1)."""

    vocab_size: int = 1088  # codebook 1024 + 64 specials
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    ffn_dim: int = 4096
    num_codebooks: int = 9
    max_position_embeddings: int = 4096
    activation_function: str = "gelu"
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    layerdrop: float = 0.0
    scale_embedding: bool = False
    use_cache: bool = True
    audio_channels: int = 1
    initializer_factor: float = 0.02
    pad_token_id: int = 1024
    bos_token_id: int = 1025
    eos_token_id: int = 1024
    tie_word_embeddings: bool = False
    # The block family: "musicgen" (the fields above), "lfm2" (LFM2's
    # gated short convolutions and GQA attention with RoPE, in
    # ``layer_types`` order, a dense SwiGLU in the first ``num_dense_layers``
    # and sigmoid-routed experts after them, RMSNorm; ``models/lfm2.py``) or
    # "nemotron_h" (Nemotron-H's Mamba-2, NoPE GQA and shared-expert MoE
    # blocks, one mixer each; ``models/nemotron_h.py``).  The fields below
    # are the two families' and leave a MusicGen decoder's JSON as it was.
    block_type: str = "musicgen"
    # LFM2: "conv" or "full_attention" per layer; Nemotron-H: "mamba", "moe"
    # or "attention" per block
    layer_types: tuple[str, ...] | None = None
    num_key_value_heads: int | None = None
    conv_L_cache: int = 3
    conv_bias: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_dense_layers: int = 0
    intermediate_size: int = 0
    use_expert_bias: bool = False
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    # Nemotron-H's fields (absent from an LFM2 decoder's JSON too).  The
    # experts' router spans ``num_experts``; a card holds ``experts_held``
    # of them (0: all), from index ``first_expert`` on (expert parallelism).
    attention_head_dim: int = 0  # 0: hidden_size // num_attention_heads
    mamba_num_heads: int = 0
    mamba_head_dim: int = 0
    ssm_state_size: int = 0
    mamba_n_groups: int = 1
    conv_kernel: int = 4
    use_conv_bias: bool = False
    chunk_size: int = 128
    mlp_hidden_act: str = "relu2"
    moe_shared_expert_intermediate_size: int = 0
    experts_held: int = 0
    first_expert: int = 0

    def __post_init__(self):
        if self.block_type not in FAMILIES:
            raise ValueError(f"block_type must be {'|'.join(FAMILIES)}, got {self.block_type!r}")
        if self.block_type == "musicgen":
            return
        types = tuple(self.layer_types or ())
        object.__setattr__(self, "layer_types", types)
        kinds = FAMILIES[self.block_type]
        if len(types) != self.num_hidden_layers or set(types) - set(kinds):
            raise ValueError(f"layer_types must give {'|'.join(kinds)} for each of the {self.num_hidden_layers} "
                             f"layers, got {types}")
        kv = self.num_key_value_heads or self.num_attention_heads
        object.__setattr__(self, "num_key_value_heads", kv)
        if self.num_attention_heads % kv:
            raise ValueError(f"{self.num_attention_heads} query heads do not group over {kv} K/V heads")
        if self.conv_bias:
            raise NotImplementedError("LFM2 short convolutions with a bias")
        if self.num_experts and not 0 < self.num_experts_per_tok <= self.num_experts:
            raise ValueError(f"num_experts_per_tok {self.num_experts_per_tok} of {self.num_experts} experts")
        if self.block_type == "nemotron_h":
            self._check_nemotron_h()

    def _check_nemotron_h(self) -> None:
        if self.mlp_hidden_act != "relu2":
            raise NotImplementedError(f"Nemotron-H experts with {self.mlp_hidden_act!r} (relu2 is built)")
        if self.mamba_num_heads % self.mamba_n_groups:
            raise ValueError(f"{self.mamba_num_heads} Mamba heads do not group over {self.mamba_n_groups} groups")
        held = self.experts_held or self.num_experts
        object.__setattr__(self, "experts_held", held)
        if not (0 < held and 0 <= self.first_expert and self.first_expert + held <= self.num_experts):
            raise ValueError(f"experts [{self.first_expert}, {self.first_expert + held}) are not among "
                             f"{self.num_experts}")

    @property
    def head_dim(self) -> int:
        if self.attention_head_dim:
            return self.attention_head_dim
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must be a multiple of num_attention_heads")
        return self.hidden_size // self.num_attention_heads

    @property
    def mamba_inner(self) -> int:
        """Nemotron-H: the Mamba mixer's inner width, heads x head dim."""
        return self.mamba_num_heads * self.mamba_head_dim

    @property
    def mamba_conv_dim(self) -> int:
        """Nemotron-H: the convolution's channels, x then B and C of every group."""
        return self.mamba_inner + 2 * self.mamba_n_groups * self.ssm_state_size

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        dropped = {"musicgen": FAMILY_FIELDS, "lfm2": NEMOTRON_H_FIELDS}.get(self.block_type, ())
        for name in dropped:
            del d[name]
        return d

    from_dict = classmethod(_fromdict)


#: each block family's kinds of layer (``layer_types``)
FAMILIES = {"musicgen": (), "lfm2": ("conv", "full_attention"), "nemotron_h": ("mamba", "moe", "attention")}
_DECODER_FIELDS = [f.name for f in dataclasses.fields(DecoderConfig)]
#: the block families' fields of ``DecoderConfig``, absent from a MusicGen one's JSON
FAMILY_FIELDS = tuple(_DECODER_FIELDS[_DECODER_FIELDS.index("block_type"):])
#: Nemotron-H's own fields, absent from an LFM2 one's JSON
NEMOTRON_H_FIELDS = tuple(_DECODER_FIELDS[_DECODER_FIELDS.index("attention_head_dim"):])


@dataclass(frozen=True)
class ParlerTTSConfig:
    """Composite model config (text encoder + audio codec + decoder).

    ``vocab_size`` is the prompt tokenizer's vocabulary, the size of the
    ``embed_prompts`` table."""

    vocab_size: int = 32128
    text_encoder: T5EncoderConfig = field(default_factory=T5EncoderConfig)
    audio_encoder: DACConfig | EncodecConfig = field(default_factory=DACConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)

    def __post_init__(self):
        if isinstance(self.text_encoder, dict):
            object.__setattr__(self, "text_encoder", T5EncoderConfig.from_dict(self.text_encoder))
        if isinstance(self.audio_encoder, dict):
            object.__setattr__(self, "audio_encoder", _codec_from_dict(self.audio_encoder))
        if isinstance(self.decoder, dict):
            object.__setattr__(self, "decoder", DecoderConfig.from_dict(self.decoder))

    @property
    def sampling_rate(self) -> int:
        return self.audio_encoder.sampling_rate

    @property
    def frame_rate(self) -> int:
        return self.audio_encoder.frame_rate

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "decoder": self.decoder.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "ParlerTTSConfig":
        return cls(
            vocab_size=d.get("vocab_size", 32128),
            text_encoder=d.get("text_encoder", T5EncoderConfig()),
            audio_encoder=d.get("audio_encoder", DACConfig()),
            decoder=d.get("decoder", DecoderConfig()),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ParlerTTSConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclass(frozen=True)
class GenerationConfig:
    """Decode-time defaults.  ``kv_cache_dtype="int8"`` stores the decode
    KV cache as int8 with per-position scales; ``int8_weights`` runs the
    decode steps' matmuls and LM heads on int8 weights with per-channel
    scales (the prefill keeps the model's own weights).
    ``kv_read_buckets`` is the most KV-read buckets of the decode loop
    (``generation/generate._kv_read_limits``; <= 1: one, the whole
    length): each step reads the cache over its bucket's length, not over
    ``max_length``."""

    max_length: int = 2580  # 30 s x 86 Hz
    do_sample: bool = True
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0
    guidance_scale: float = 1.0  # 1.0 = CFG off
    decoder_start_token_id: int = 1025
    pad_token_id: int = 1024
    bos_token_id: int = 1025
    eos_token_id: int = 1024
    kv_cache_dtype: str | None = None
    int8_weights: bool = False
    kv_read_buckets: int = 8

    to_dict = _asdict
    from_dict = classmethod(_fromdict)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "GenerationConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def mini_600m_config() -> ParlerTTSConfig:
    """The Parler-TTS Mini v0.1 assembly: flan-t5-base, a 24-layer 1024-wide
    decoder with 16 heads over 9 codebooks, DAC 44.1 kHz."""
    return ParlerTTSConfig(
        vocab_size=32128,
        text_encoder=T5EncoderConfig(),
        audio_encoder=DACConfig(),
        decoder=DecoderConfig(
            vocab_size=1088,
            max_position_embeddings=4096,
            num_hidden_layers=24,
            ffn_dim=4096,
            num_attention_heads=16,
            hidden_size=1024,
            num_codebooks=9,
            pad_token_id=1024,
            eos_token_id=1024,
            bos_token_id=1025,
        ),
    )


def large_2b_config() -> ParlerTTSConfig:
    """A large-class assembly (about 2B decoder parameters: 36 layers, 2048
    wide, 32 heads, ffn 8192) with a flan-t5-large-shaped text encoder."""
    return ParlerTTSConfig(
        vocab_size=32128,
        text_encoder=T5EncoderConfig(d_model=1024, d_kv=64, d_ff=2816, num_layers=24, num_heads=16),
        audio_encoder=DACConfig(),
        decoder=DecoderConfig(
            vocab_size=1088,
            max_position_embeddings=4096,
            num_hidden_layers=36,
            ffn_dim=8192,
            num_attention_heads=32,
            hidden_size=2048,
            num_codebooks=9,
            pad_token_id=1024,
            eos_token_id=1024,
            bos_token_id=1025,
        ),
    )


def dummy_config(num_codebooks: int = 9) -> ParlerTTSConfig:
    """Tiny smoke-test assembly (4-layer 512-wide decoder, 2-layer T5)."""
    return ParlerTTSConfig(
        vocab_size=32128,
        text_encoder=T5EncoderConfig(
            vocab_size=32128, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4
        ),
        audio_encoder=DACConfig(),
        decoder=DecoderConfig(
            vocab_size=1088,
            max_position_embeddings=1024,
            num_hidden_layers=4,
            ffn_dim=512,
            num_attention_heads=8,
            hidden_size=512,
            num_codebooks=num_codebooks,
            pad_token_id=1024,
            eos_token_id=1024,
            bos_token_id=1025,
        ),
    )


#: LFM2-8B-A1B's operator order (its published ``layer_types``)
LFM2_8B_A1B_LAYER_TYPES = tuple(
    "full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv" for i in range(24))


def lfm2_8b_a1b_config() -> ParlerTTSConfig:
    """LFM2-8B-A1B's decoder stack (24 × 2048: 18 gated short convolutions,
    6 GQA attention layers of 32 query and 8 K/V heads, 2 dense SwiGLU
    layers then 32 experts of width 1,792 with 4 a token) as the codec
    decoder over EnCodec 24 kHz's first 8 codebooks, flan-t5-base as the
    text encoder and LFM2's 65,536-entry vocabulary as the prompt table.
    Parler's parts replace the text LM's embedding and head, and every block
    gains a cross-attention sublayer (``models/lfm2.py``)."""
    return ParlerTTSConfig(
        vocab_size=65536,
        text_encoder=T5EncoderConfig(),
        audio_encoder=EncodecConfig(num_codebooks=8),
        decoder=DecoderConfig(
            vocab_size=1088,
            hidden_size=2048,
            num_hidden_layers=24,
            num_attention_heads=32,
            num_codebooks=8,
            max_position_embeddings=128000,
            pad_token_id=1024,
            eos_token_id=1024,
            bos_token_id=1025,
            block_type="lfm2",
            layer_types=LFM2_8B_A1B_LAYER_TYPES,
            num_key_value_heads=8,
            conv_L_cache=3,
            num_experts=32,
            num_experts_per_tok=4,
            moe_intermediate_size=1792,
            num_dense_layers=2,
            intermediate_size=7168,
            use_expert_bias=True,
            norm_topk_prob=True,
            routed_scaling_factor=1.0,
            rope_theta=1e6,
            norm_eps=1e-5,
        ),
    )


#: Nemotron-3-Nano-30B-A3B's ``hybrid_override_pattern``: M Mamba-2, E MoE, * attention
NEMOTRON_3_NANO_PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"


def nemotron_h_layer_types(pattern: str) -> tuple[str, ...]:
    """A ``hybrid_override_pattern`` as ``layer_types``."""
    return tuple({"M": "mamba", "E": "moe", "*": "attention"}[c] for c in pattern)


def nemotron_3_nano_30b_a3b_config(experts_held: int = 16, first_expert: int = 0) -> ParlerTTSConfig:
    """Nemotron-3-Nano-30B-A3B's decoder stack (52 blocks at 2688: 23
    Mamba-2 mixers of 64 heads x 64 over a 128-wide state in 8 groups, 23
    MoE layers routing each token to 6 of 128 relu2 experts of width 1856
    plus a shared one of 3712, 6 NoPE GQA layers of 32 query and 2 K/V
    heads of 128) as the codec decoder over EnCodec 24 kHz's first 8
    codebooks, flan-t5-base as the text encoder and Nemotron's 131,072-entry
    vocabulary as the prompt table.  One card's share of an 8-card
    expert-parallel node: ``experts_held`` of the 128 experts from
    ``first_expert`` on.  Parler's parts replace the text LM's embedding and
    head, and each attention block gains a cross-attention sublayer
    (``models/nemotron_h.py``)."""
    return ParlerTTSConfig(
        vocab_size=131072,
        text_encoder=T5EncoderConfig(),
        audio_encoder=EncodecConfig(num_codebooks=8),
        decoder=DecoderConfig(
            vocab_size=1088,
            hidden_size=2688,
            num_hidden_layers=52,
            num_attention_heads=32,
            num_codebooks=8,
            max_position_embeddings=262144,
            pad_token_id=1024,
            eos_token_id=1024,
            bos_token_id=1025,
            block_type="nemotron_h",
            layer_types=nemotron_h_layer_types(NEMOTRON_3_NANO_PATTERN),
            num_key_value_heads=2,
            num_experts=128,
            num_experts_per_tok=6,
            moe_intermediate_size=1856,
            use_expert_bias=True,
            norm_topk_prob=True,
            routed_scaling_factor=2.5,
            norm_eps=1e-5,
            attention_head_dim=128,
            mamba_num_heads=64,
            mamba_head_dim=64,
            ssm_state_size=128,
            mamba_n_groups=8,
            conv_kernel=4,
            use_conv_bias=True,
            chunk_size=128,
            mlp_hidden_act="relu2",
            moe_shared_expert_intermediate_size=3712,
            experts_held=experts_held,
            first_expert=first_expert,
        ),
    )
