"""Load a reference (HF Parler-TTS) checkpoint directory into the port.

Port of ``parler_tts_tpu/core/from_reference.py``.  A reference checkpoint
directory (``save_pretrained`` of ``ParlerTTSForConditionalGeneration``,
e.g. ``parler-tts/parler_tts_mini_v0.1``) holds a nested ``config.json``
(``text_encoder`` / ``audio_encoder`` / ``decoder`` sub-configs), the weights
(``model.safetensors`` or ``pytorch_model.bin``, either possibly sharded
behind an index) and ``generation_config.json``.  ``from_reference_pretrained``
maps all of it onto the port's configs and a ``ParlerTTSModel``.

Safetensors files are read by ``read_safetensors`` below (an 8-byte
little-endian header length, a JSON header, then raw little-endian tensor
bytes), which needs no ``safetensors`` package: the file is memory-mapped
copy-on-write and each tensor is a view of it, so a load holds the weights
once on the host before ``load_state_dict`` copies them to the device.
"""

from __future__ import annotations

import json
import mmap
import os
import sys

import torch

from parler_tts_tpu_torch.core.config import (
    DACConfig,
    DecoderConfig,
    EncodecConfig,
    GenerationConfig,
    ParlerTTSConfig,
    T5EncoderConfig,
)
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.models.parler import ParlerTTSModel, import_composite

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}, each a view of the
    file mapped copy-on-write (writing to a tensor never reaches the file).
    ``__metadata__`` in the header is skipped."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors holds little-endian bytes; this host is big-endian")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        if count != torch.Size(info["shape"]).numel() or base + end > len(data):
            raise ValueError(f"{path}: tensor {name} has {end - start} bytes for shape {info['shape']} "
                             f"of {info['dtype']}, or lies past the end of the file")
        flat = (torch.frombuffer(data, dtype=dtype, offset=base + start, count=count) if count
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def load_reference_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """The weights of a reference directory: the files an index
    (``model.safetensors.index.json`` or ``pytorch_model.bin.index.json``)
    names in its ``weight_map``, else ``model.safetensors``, else
    ``pytorch_model.bin``."""
    idx_st = os.path.join(model_dir, "model.safetensors.index.json")
    idx_pt = os.path.join(model_dir, "pytorch_model.bin.index.json")
    files: list[str] = []
    if os.path.exists(idx_st) or os.path.exists(idx_pt):
        with open(idx_st if os.path.exists(idx_st) else idx_pt) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = [c for c in ("model.safetensors", "pytorch_model.bin")
                 if os.path.exists(os.path.join(model_dir, c))][:1]
    if not files:
        raise FileNotFoundError(f"no weights found in {model_dir}")
    sd: dict[str, torch.Tensor] = {}
    for fname in files:
        path = os.path.join(model_dir, fname)
        if fname.endswith(".safetensors"):
            sd.update(read_safetensors(path))
        else:
            sd.update(torch.load(path, map_location="cpu", weights_only=True, mmap=True))
    return sd


def _codec_config_from_reference(ae: dict, de: dict) -> DACConfig | EncodecConfig:
    """The nested ``audio_encoder`` sub-config -> a DAC or EnCodec config.
    The reference assembles its composite through the HF Auto registry, so
    the codec is its DAC wrapper (``model_type`` ``"dac"``), an HF
    ``DacModel`` (``n_codebooks``, ``hidden_size`` for the latent width) or
    an HF ``EncodecModel`` (``model_type`` ``"encodec"``)."""
    if ae.get("model_type") == "encodec" or ae.get("codec_type") == "encodec":
        return EncodecConfig(
            target_bandwidths=tuple(ae.get("target_bandwidths", (1.5, 3.0, 6.0, 12.0, 24.0))),
            sampling_rate=ae.get("sampling_rate", 24000),
            audio_channels=ae.get("audio_channels", 1),
            normalize=ae.get("normalize", False),
            chunk_length_s=ae.get("chunk_length_s"),
            overlap=ae.get("overlap"),
            hidden_size=ae.get("hidden_size", 128),
            num_filters=ae.get("num_filters", 32),
            num_residual_layers=ae.get("num_residual_layers", 1),
            upsampling_ratios=tuple(ae.get("upsampling_ratios", (8, 5, 4, 2))),
            norm_type=ae.get("norm_type", "weight_norm"),
            kernel_size=ae.get("kernel_size", 7),
            last_kernel_size=ae.get("last_kernel_size", 7),
            residual_kernel_size=ae.get("residual_kernel_size", 3),
            dilation_growth_rate=ae.get("dilation_growth_rate", 2),
            use_causal_conv=ae.get("use_causal_conv", True),
            pad_mode=ae.get("pad_mode", "reflect"),
            compress=ae.get("compress", 2),
            num_lstm_layers=ae.get("num_lstm_layers", 2),
            trim_right_ratio=ae.get("trim_right_ratio", 1.0),
            codebook_size=ae.get("codebook_size", 1024),
            codebook_dim=ae.get("codebook_dim"),
            use_conv_shortcut=ae.get("use_conv_shortcut", True),
            # the composite models as many streams as its decoder emits
            num_codebooks=ae.get("num_codebooks", de.get("num_codebooks")),
        )
    return DACConfig(
        num_codebooks=ae.get("num_codebooks", ae.get("n_codebooks", 9)),
        model_bitrate=ae.get("model_bitrate", 8),
        codebook_size=ae.get("codebook_size", 1024),
        codebook_dim=ae.get("codebook_dim", 8),
        latent_dim=ae.get("latent_dim", ae.get("hidden_size", 1024)),
        frame_rate=ae.get("frame_rate", 86),
        sampling_rate=ae.get("sampling_rate", 44100),
        encoder_hidden_size=ae.get("encoder_hidden_size", 64),
        downsampling_ratios=tuple(ae.get("downsampling_ratios", (2, 4, 8, 8))),
        decoder_hidden_size=ae.get("decoder_hidden_size", 1536),
        upsampling_ratios=tuple(ae.get("upsampling_ratios", (8, 8, 4, 2))),
    )


def config_from_reference(config_json: dict) -> ParlerTTSConfig:
    """The reference's nested ``config.json`` -> the composite config."""
    te, ae, de = config_json["text_encoder"], config_json["audio_encoder"], config_json["decoder"]
    gated = te.get("feed_forward_proj", "gated-gelu").startswith("gated")
    return ParlerTTSConfig(
        vocab_size=config_json.get("vocab_size", 32128),
        text_encoder=T5EncoderConfig(
            vocab_size=te.get("vocab_size", 32128),
            d_model=te.get("d_model", 768),
            d_kv=te.get("d_kv", 64),
            d_ff=te.get("d_ff", 2048),
            num_layers=te.get("num_layers", 12),
            num_heads=te.get("num_heads", 12),
            relative_attention_num_buckets=te.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=te.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=te.get("layer_norm_epsilon", 1e-6),
            dense_act_fn=te.get("dense_act_fn", "gelu_new" if gated else "relu"),
            is_gated_act=te.get("is_gated_act", gated),
            dropout_rate=te.get("dropout_rate", 0.1),
        ),
        audio_encoder=_codec_config_from_reference(ae, de),
        decoder=DecoderConfig(
            vocab_size=de.get("vocab_size", 1088),
            hidden_size=de.get("hidden_size", 1024),
            num_hidden_layers=de.get("num_hidden_layers", 24),
            num_attention_heads=de.get("num_attention_heads", 16),
            ffn_dim=de.get("ffn_dim", 4096),
            num_codebooks=de.get("num_codebooks", 9),
            max_position_embeddings=de.get("max_position_embeddings", 4096),
            activation_function=de.get("activation_function", "gelu"),
            scale_embedding=de.get("scale_embedding", False),
            pad_token_id=de.get("pad_token_id", 1024),
            bos_token_id=de.get("bos_token_id", 1025),
            eos_token_id=de.get("eos_token_id", 1024),
        ),
    )


def generation_config_from_reference(gen_json: dict, cfg: ParlerTTSConfig) -> GenerationConfig:
    """The reference's ``generation_config.json`` -> the port's.  An omitted
    ``top_k`` stays 0 (disabled): HF applies top-k only when ``generate`` is
    called with it, and the Mini checkpoint samples without it.  A null
    ``guidance_scale`` means no guidance."""
    return GenerationConfig(
        max_length=gen_json.get("max_length", 2580),
        do_sample=gen_json.get("do_sample", True),
        temperature=gen_json.get("temperature", 1.0),
        top_k=gen_json.get("top_k", 0),
        top_p=gen_json.get("top_p", 1.0),
        guidance_scale=gen_json.get("guidance_scale") or 1.0,
        decoder_start_token_id=gen_json.get("decoder_start_token_id", cfg.decoder.bos_token_id),
        pad_token_id=gen_json.get("pad_token_id", cfg.decoder.pad_token_id),
        bos_token_id=gen_json.get("bos_token_id", cfg.decoder.bos_token_id),
        eos_token_id=gen_json.get("eos_token_id", cfg.decoder.eos_token_id),
    )


def from_reference_pretrained(model_dir: str, *, device: str | torch.device = "cuda",
                              dtype: torch.dtype | None = None
                              ) -> tuple[ParlerTTSModel, ParlerTTSConfig, GenerationConfig]:
    """A reference checkpoint directory -> (model on ``device`` in ``dtype``
    (None = fp32), eval mode and frozen; its config; its generation config),
    as ``core/checkpoint.load_model`` returns an artifact.  Every parameter
    must come from the checkpoint: a missing or extra one raises."""
    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_reference(json.load(f))
    gen_path = os.path.join(model_dir, "generation_config.json")
    gen = GenerationConfig()
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            gen = generation_config_from_reference(json.load(f), cfg)
    state = import_composite(load_reference_state_dict(model_dir), cfg)
    with torch.device(device):
        model = ParlerTTSModel(cfg)
    if dtype is not None:
        model = model.to(dtype)
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False), cfg, gen
