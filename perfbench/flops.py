"""Operations and bytes of the counted work, from shapes, and the chip's
peaks they are held against.

Model FLOPs count the multiply-adds of matrix products and convolutions (2
per multiply-add) that the inputs need: real tokens only, never padding,
and causal attention over the valid (query, key) pairs alone, each query
with the valid keys at or before it.  Elementwise work, norms and softmax
are not counted.  A kernel's roofline bound is the larger of its operations
over the peak rate and its bytes over the memory bandwidth, counting each
input byte read once and each output byte written once.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def bound_seconds(ops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return max(ops / peak_flops, nbytes / PEAK_HBM_BYTES_PER_S)


def share(bound_s: float, measured_s: float) -> float | None:
    """Percent of the roofline a measured time reaches; None without a time."""
    if measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s


def causal_pairs(valid: list[int]) -> int:
    """Valid (query, key) pairs of a causal attention over a row whose
    positions are valid (1) or padding (0): each valid query with the valid
    keys at or before it."""
    pairs = seen = 0
    for v in valid:
        seen += v
        pairs += seen if v else 0
    return pairs


def attention_fwd(bh: int, tq: int, tk: int, d: int, pairs: int, elem_bytes: int = 2) -> tuple[float, float]:
    """Flash attention forward over ``bh`` heads: q k^T and p v on ``pairs``
    valid pairs (summed over heads), reading q, k, v and writing the output
    and its fp32 log-sum-exp."""
    return 4.0 * d * pairs, elem_bytes * d * bh * (2 * tq + 2 * tk) + 4.0 * bh * tq


def t5(cfg: dict, length: int) -> float:
    """The T5 encoder over one row of ``length`` real tokens."""
    d, inner, dff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    ffn_mats = 3 if cfg["is_gated_act"] else 2
    per_layer = 2 * length * (4 * d * inner + ffn_mats * d * dff) + 4 * inner * length * length
    return float(cfg["num_layers"] * per_layer)


def _decoder_dims(cfg: dict) -> tuple[int, int, int, int, int, int]:
    dc = cfg["decoder"]
    return (dc["num_hidden_layers"], dc["hidden_size"], dc["ffn_dim"], dc["vocab_size"], dc["num_codebooks"],
            cfg["text_encoder"]["d_model"])


def decoder_prefill(cfg: dict, fused: int, enc: int) -> float:
    """The decoder's prefill over ``fused`` real positions (prompt and BOS
    frame) with ``enc`` real encoder tokens: every layer's projections,
    causal self-attention, cross-attention and its K/V, the encoder
    projection, and the LM heads at the last position."""
    layers, h, f, v, k, d_model = _decoder_dims(cfg)
    per_layer = (2 * fused * (6 * h * h + 2 * h * f) + 4 * enc * h * h + 4 * h * (fused * (fused + 1) // 2)
                 + 4 * h * fused * enc)
    proj = 2 * d_model * h * enc if d_model != h else 0
    return float(layers * per_layer + proj + 2 * h * v * k)


def decode_steps(cfg: dict, first_ctx: int, steps: int, enc: int) -> float:
    """``steps`` cached decode steps of one row, the first attending to
    ``first_ctx`` valid keys (itself included), each later one to one more."""
    layers, h, f, v, k, _ = _decoder_dims(cfg)
    ctx_sum = steps * first_ctx + steps * (steps - 1) // 2
    per_step = layers * (2 * (6 * h * h + 2 * h * f) + 4 * h * enc) + 2 * h * v * k
    return float(steps * per_step + layers * 4 * h * ctx_sum)


def dac_decode(codec: dict, frames: int, codebooks: int) -> float:
    """DAC's decode of ``frames`` frames: the quantizer's out-projections,
    conv_in, per stride the transposed conv and three residual units, and
    conv_out."""
    latent, c = codec["latent_dim"], codec["decoder_hidden_size"]
    total = 2 * codebooks * codec["codebook_dim"] * latent * frames + 2 * latent * c * 7 * frames
    t = frames
    for s in codec["upsampling_ratios"]:
        total += 2 * c * (c // 2) * 2 * s * t
        c, t = c // 2, t * s
        total += 3 * (2 * c * c * 7 * t + 2 * c * c * t)
    return float(total + 2 * c * 7 * t)


def encodec_decode(codec: dict, frames: int) -> float:
    """EnCodec's SEANet decode of ``frames`` frames: conv_in, the LSTM
    stack, per ratio the transposed conv and its resnet blocks, conv_out."""
    nf, ratios = codec["num_filters"], codec["upsampling_ratios"]
    c = 2 ** len(ratios) * nf
    t = frames
    total = 2 * codec["hidden_size"] * c * codec["kernel_size"] * t + codec["num_lstm_layers"] * 16 * c * c * t
    for r in ratios:
        total += 2 * c * (c // 2) * 2 * r * t
        c, t = c // 2, t * r
        hidden = c // codec["compress"]
        block = 2 * c * hidden * codec["residual_kernel_size"] * t + 2 * hidden * c * t
        if codec["use_conv_shortcut"]:
            block += 2 * c * c * t
        total += codec["num_residual_layers"] * block
    return float(total + 2 * c * codec.get("audio_channels", 1) * codec["last_kernel_size"] * t)


def vocode(cfg: dict, frames: int) -> float:
    codec = cfg["audio_encoder"]
    if codec.get("codec_type") == "encodec":
        return encodec_decode(codec, frames)
    return dac_decode(codec, frames, cfg["decoder"]["num_codebooks"])


def tts_row(cfg: dict, desc_len: int, prompt_len: int, max_length: int) -> float:
    """One row of a ``tts`` call that decodes to ``max_length`` steps:
    T5, the prefill over the prompt and the BOS frame, the ``max_length - 2``
    decode steps whose logits are used, and the vocode of its frames."""
    k = cfg["decoder"]["num_codebooks"]
    return (t5(cfg["text_encoder"], desc_len) + decoder_prefill(cfg, prompt_len + 1, desc_len)
            + decode_steps(cfg, prompt_len + 2, max_length - 2, desc_len) + vocode(cfg, max_length - k))
