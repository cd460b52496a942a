"""Model FLOPs and roofline bounds of the LFM2 decoder (``models/lfm2.py``)
under Parler's text conditioning, counted as ``perfbench/flops.py`` counts
(2 per multiply-add of matrix products and convolutions, real tokens only,
causal pairs over valid keys; norms, RoPE, routing's sigmoid and top-k and
elementwise work not counted), reusing its T5, vocoder and attention
functions.  The experts count the routed (token, expert) pairs only: each
of a token's ``num_experts_per_tok`` experts, three matrices of
``hidden x moe_intermediate_size``.
"""

from __future__ import annotations

from perfbench import flops


def _dims(cfg: dict) -> dict:
    d = cfg["decoder"]
    return {"h": d["hidden_size"], "heads": d["num_attention_heads"], "kv": d["num_key_value_heads"],
            "dim": d["hidden_size"] // d["num_attention_heads"], "taps": d["conv_L_cache"],
            "dense": d["intermediate_size"], "expert": d["moe_intermediate_size"], "e": d["num_experts"],
            "k": d["num_experts_per_tok"], "kinds": d["layer_types"], "n_dense": d["num_dense_layers"],
            "v": d["vocab_size"], "books": d["num_codebooks"], "d_model": cfg["text_encoder"]["d_model"]}


def _token_layers(c: dict, tokens: int) -> float:
    """Every layer's projections, convolutions and feed-forwards over
    ``tokens`` tokens (attention products and cross K/V apart)."""
    h, total = c["h"], 0.0
    for i, kind in enumerate(c["kinds"]):
        if kind == "conv":
            total += 2 * tokens * (3 * h * h + h * h) + 2 * c["taps"] * h * tokens
        else:
            total += 2 * tokens * (2 * h * h + 2 * h * c["kv"] * c["dim"])
        total += 2 * tokens * 2 * h * h  # cross q and o
        if i < c["n_dense"]:
            total += 6 * tokens * h * c["dense"]
        else:
            total += 2 * tokens * h * c["e"] + 6 * tokens * c["k"] * h * c["expert"]
    return total


def _attention_layers(c: dict) -> int:
    return sum(kind == "full_attention" for kind in c["kinds"])


def decoder_prefill(cfg: dict, fused: int, enc: int) -> float:
    """The prefill over ``fused`` real positions with ``enc`` real encoder
    tokens: the layers, causal self-attention in the attention layers,
    cross-attention and its K/V in every layer, the encoder projection, the
    LM heads at the last position."""
    c = _dims(cfg)
    h, layers = c["h"], len(c["kinds"])
    attn = _attention_layers(c) * 4 * c["heads"] * c["dim"] * (fused * (fused + 1) // 2)
    cross = layers * (4 * enc * h * h + 4 * h * fused * enc)
    proj = 2 * c["d_model"] * h * enc if c["d_model"] != h else 0
    return float(_token_layers(c, fused) + attn + cross + proj + 2 * h * c["v"] * c["books"])


def decode_steps(cfg: dict, first_ctx: int, steps: int, enc: int) -> float:
    """``steps`` cached steps of one row, the first attending to
    ``first_ctx`` valid keys (itself included), each later one to one more."""
    c = _dims(cfg)
    h, layers = c["h"], len(c["kinds"])
    ctx_sum = steps * first_ctx + steps * (steps - 1) // 2
    per_step = _token_layers(c, 1) + layers * 4 * h * enc + 2 * h * c["v"] * c["books"]
    return float(steps * per_step + _attention_layers(c) * 4 * c["heads"] * c["dim"] * ctx_sum)


def tts_row(cfg: dict, desc_len: int, prompt_len: int, max_length: int) -> float:
    """One row of a ``tts`` call decoding ``max_length`` steps, as
    ``flops.tts_row``: T5, prefill, the used steps, the vocode."""
    k = cfg["decoder"]["num_codebooks"]
    return (flops.t5(cfg["text_encoder"], desc_len) + decoder_prefill(cfg, prompt_len + 1, desc_len)
            + decode_steps(cfg, prompt_len + 2, max_length - 2, desc_len) + flops.vocode(cfg, max_length - k))


def attn_fwd_bound(cfg: dict, fused_masks: list[list[int]]) -> float:
    """Seconds K1 needs at least in one prefill: causal self-attention over
    each row's valid fused positions (``fused_masks``, 1 = valid), every
    attention layer's query heads (K/V given repeated to them)."""
    c = _dims(cfg)
    t = len(fused_masks[0])
    pairs = c["heads"] * sum(flops.causal_pairs(row) for row in fused_masks)
    ops, nbytes = flops.attention_fwd(c["heads"] * len(fused_masks), t, t, c["dim"], pairs)
    return _attention_layers(c) * flops.bound_seconds(ops, nbytes)


def experts_bound(cfg: dict, experts_touched: float, assignments: float, elem_bytes: int = 2) -> float:
    """Seconds the expert matmuls need at least: each touched expert's three
    matrices read once (``experts_touched`` summed over MoE calls) against
    ``6 * hidden * moe_intermediate_size`` operations per routed pair."""
    c = _dims(cfg)
    per_expert = 3 * c["h"] * c["expert"]
    return flops.bound_seconds(assignments * 2 * per_expert, experts_touched * per_expert * elem_bytes)
