"""Model FLOPs and roofline bounds of the Nemotron-H decoder
(``models/nemotron_h.py``) under Parler's text conditioning, on one card of
an expert-parallel deployment, counted as ``perfbench/flops.py`` counts (2
per multiply-add of matrix products and convolutions, real tokens only,
causal pairs over valid keys; norms, softplus, the gate, routing's sigmoid
and top-k and elementwise work not counted), reusing its T5, vocoder and
attention functions.

* A Mamba layer counts its projections, the convolution's taps and the
  state's two products a token, ``dt x (x) B`` into the state and ``S C``
  out of it (2 * heads * head dim * N each), in the prefill as in a step.
* An expert layer counts the router, the shared expert, and of the routed
  pairs this card's share: ``num_experts_per_tok * experts_held /
  num_experts`` pairs a token (its experts' expected share of the routing),
  two matrices of hidden x ``moe_intermediate_size`` each.
* An attention block counts its projections, its attention and its
  cross-attention sublayer.

K8's bound (``ssm_step_bound``) is the state read and written once, plus
the step's inputs (x, B, C, dt) read once and y written once, at 3.35 TB/s.
"""

from __future__ import annotations

from perfbench import flops


def _dims(cfg: dict) -> dict:
    d = cfg["decoder"]
    heads, p, n, g = d["mamba_num_heads"], d["mamba_head_dim"], d["ssm_state_size"], d["mamba_n_groups"]
    inner = heads * p
    held = d["experts_held"] or d["num_experts"]
    return {"h": d["hidden_size"], "heads": d["num_attention_heads"], "kv": d["num_key_value_heads"],
            "dim": d["attention_head_dim"], "m_heads": heads, "m_dim": p, "n": n, "g": g, "inner": inner,
            "conv": inner + 2 * g * n, "taps": d["conv_kernel"], "e": d["num_experts"],
            "pairs": d["num_experts_per_tok"] * held / d["num_experts"], "expert": d["moe_intermediate_size"],
            "shared": d["moe_shared_expert_intermediate_size"], "kinds": d["layer_types"],
            "v": d["vocab_size"], "books": d["num_codebooks"], "d_model": cfg["text_encoder"]["d_model"]}


def _token_layers(c: dict, tokens: int) -> float:
    """Every block's work over ``tokens`` tokens (attention products and
    cross K/V apart)."""
    h, total = c["h"], 0.0
    for kind in c["kinds"]:
        if kind == "mamba":
            total += 2 * tokens * h * (c["inner"] + c["conv"] + c["m_heads"]) + 2 * tokens * c["taps"] * c["conv"]
            total += 4 * tokens * c["m_heads"] * c["m_dim"] * c["n"] + 2 * tokens * c["inner"] * h
        elif kind == "moe":
            total += 2 * tokens * h * c["e"] + 4 * tokens * h * c["shared"] + 4 * tokens * c["pairs"] * h * c["expert"]
        else:
            q = c["heads"] * c["dim"]
            total += 2 * tokens * h * (2 * q + 2 * c["kv"] * c["dim"])  # q, o; k, v
            total += 2 * tokens * 2 * h * q  # cross q and o
    return total


def _attention_layers(c: dict) -> int:
    return sum(kind == "attention" for kind in c["kinds"])


def decoder_prefill(cfg: dict, fused: int, enc: int) -> float:
    """The prefill over ``fused`` real positions with ``enc`` real encoder
    tokens: every block, causal self-attention and cross-attention with its
    K/V in the attention blocks, the encoder projection, the LM heads at the
    last position."""
    c = _dims(cfg)
    h, q, attn = c["h"], c["heads"] * c["dim"], _attention_layers(c)
    self_attn = attn * 4 * q * (fused * (fused + 1) // 2)
    cross = attn * (4 * enc * h * q + 4 * q * fused * enc)
    proj = 2 * c["d_model"] * h * enc if c["d_model"] != h else 0
    return float(_token_layers(c, fused) + self_attn + cross + proj + 2 * h * c["v"] * c["books"])


def decode_steps(cfg: dict, first_ctx: int, steps: int, enc: int) -> float:
    """``steps`` cached steps of one row, the first attending to
    ``first_ctx`` valid keys (itself included), each later one to one more."""
    c = _dims(cfg)
    q, attn = c["heads"] * c["dim"], _attention_layers(c)
    ctx_sum = steps * first_ctx + steps * (steps - 1) // 2
    per_step = _token_layers(c, 1) + attn * 4 * q * enc + 2 * c["h"] * c["v"] * c["books"]
    return float(steps * per_step + attn * 4 * q * ctx_sum)


def tts_row(cfg: dict, desc_len: int, prompt_len: int, max_length: int) -> float:
    """One row of a ``tts`` call decoding ``max_length`` steps, as
    ``flops.tts_row``: T5, prefill, the used steps, the vocode."""
    k = cfg["decoder"]["num_codebooks"]
    return (flops.t5(cfg["text_encoder"], desc_len) + decoder_prefill(cfg, prompt_len + 1, desc_len)
            + decode_steps(cfg, prompt_len + 2, max_length - 2, desc_len) + flops.vocode(cfg, max_length - k))


def attn_fwd_bound(cfg: dict, fused_masks: list[list[int]]) -> float:
    """Seconds K1 needs at least in one prefill: causal self-attention over
    each row's valid fused positions (``fused_masks``, 1 = valid), every
    attention block's query heads (K/V given repeated to them) at head dim
    ``attention_head_dim``."""
    c = _dims(cfg)
    t = len(fused_masks[0])
    pairs = c["heads"] * sum(flops.causal_pairs(row) for row in fused_masks)
    ops, nbytes = flops.attention_fwd(c["heads"] * len(fused_masks), t, t, c["dim"], pairs)
    return _attention_layers(c) * flops.bound_seconds(ops, nbytes)


def ssm_step_bound(cfg: dict, state_bytes: float, positions: float, launches_steps: float,
                   elem_bytes: int = 2) -> float:
    """Seconds K8 needs at least over ``launches_steps`` decode steps (every
    Mamba layer's launch in each): the program's ``decode.ssm_state_bytes``
    over its ``decode.positions`` kept steps gives the state a step reads
    and writes; to it the rows' inputs x, B, C and dt read once and y written
    once (``elem_bytes`` each) at every layer."""
    if not positions or not state_bytes:
        return 0.0
    c = _dims(cfg)
    per_step = state_bytes / positions
    per_row_layer = c["m_heads"] * c["m_dim"] * c["n"] * 4 * 2  # the fp32 state, read and written
    io_per_row_layer = (2 * c["inner"] + 2 * c["g"] * c["n"] + c["m_heads"]) * elem_bytes
    return flops.bound_seconds(0.0, launches_steps * per_step * (1 + io_per_row_layer / per_row_layer))
