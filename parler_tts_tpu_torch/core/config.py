"""Typed configuration for the PyTorch port of Parler-TTS.

The port's own copy of the JAX package's frozen dataclasses
(``parler_tts_tpu/core/config.py``): the same fields, defaults and JSON
round-trip, so both packages read the same ``config.json`` /
``generation_config.json`` that ``parler_tts_tpu.core.checkpoint.save_model``
writes.  Unknown keys are ignored on load.

The EnCodec codec family is not ported yet: a config whose
``audio_encoder.codec_type`` is ``"encodec"`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
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


def _codec_from_dict(d: dict) -> DACConfig:
    if d.get("codec_type") == "encodec":
        raise NotImplementedError(
            "the EnCodec codec family is not ported yet (ROADMAP.md queue 1, "
            "'Codec encode side + EnCodec'); only DAC configs load in parler_tts_tpu_torch"
        )
    return DACConfig.from_dict(d)


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

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must be a multiple of num_attention_heads")
        return self.hidden_size // self.num_attention_heads

    to_dict = _asdict
    from_dict = classmethod(_fromdict)


@dataclass(frozen=True)
class ParlerTTSConfig:
    """Composite model config (text encoder + audio codec + decoder).

    ``vocab_size`` is the prompt tokenizer's vocabulary, the size of the
    ``embed_prompts`` table."""

    vocab_size: int = 32128
    text_encoder: T5EncoderConfig = field(default_factory=T5EncoderConfig)
    audio_encoder: DACConfig = field(default_factory=DACConfig)
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
        return dataclasses.asdict(self)

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
    """Decode-time defaults.  ``kv_cache_dtype="int8"`` and
    ``int8_weights`` are read from the JSON so that such a config is refused
    by ``generate`` rather than silently run in the compute dtype."""

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
