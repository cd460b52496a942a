"""LFM2-8B-A1B's decoder stack as Parler-TTS's codec decoder, in plain
float32 PyTorch: the full teacher-forced forward, no cache, no kernels.

The blocks follow the published LFM2 / LFM2-MoE description
(huggingface.co/LiquidAI/LFM2-8B-A1B config.json and the ``lfm2_moe``
modelling code), each ``x + op(RMSNorm(x))`` in ``layer_types`` order:

* ``conv``: ``in_proj`` H -> 3H split into B, C, x; a depthwise causal
  convolution of ``conv_L_cache`` taps over B*x, no bias; C times it;
  ``out_proj``;
* ``full_attention``: q, k, v projections (``num_key_value_heads`` K/V
  heads, each serving a group of query heads), RMSNorm of q and of k over
  each head, RoPE (rotate-half, ``rope_theta``), causal softmax attention
  scaled by head_dim^-1/2, ``o``;
* the feed-forward after it: SwiGLU ``w2(silu(x w1) * x w3)`` of width
  ``intermediate_size`` in the first ``num_dense_layers`` layers, then
  ``num_experts`` SwiGLU experts of width ``moe_intermediate_size``:
  ``s = sigmoid(x router)``, the top ``num_experts_per_tok`` of ``s +
  expert_bias``, weights the picked ``s`` over (their sum + 1e-6) times
  ``routed_scaling_factor``, each token's experts computed one by one;
* a final RMSNorm, eps ``norm_eps``.

Departures from the published text LM, which make it Parler's codec
decoder (as the configuration file lists them under ``assumed``):

* the token embedding and its tied head are replaced by the sum of the K
  codebook tables, the prompt table in front of them, and K LM heads;
* each block gains Parler's cross-attention sublayer to the projected text
  states between the operator and the feed-forward: RMSNorm, multi-head
  attention of ``num_attention_heads`` bias-free heads, ``o``;
* RoPE positions count over the fused prompt + audio sequence, the
  prompt's left padding included (RoPE sees only distances, so the padding
  does not move a row's result);
* padded prompt positions are masked as keys and zeroed as the
  convolution's input (the published code zeroes the hidden states at
  padded positions before the operator), so nothing reads them.

Weights by the program's state-dict names (``perfbench/weights.py``):
fused kernels ``in_proj`` (B | C | x), ``w13`` (gate | up), expert stacks
``w13`` (E, H, 2F) and ``w2`` (E, F, H), the convolution's ``kernel``
(taps, H).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import Weights, attend, heads, unheads
from perfbench.reference.t5 import rms


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of (B, H, T, D) at positions 0..T-1."""
    t, d = x.shape[2], x.shape[3]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = (torch.cat([f, f], -1).to(x.dtype) for f in (ang.cos(), ang.sin()))
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rotated * sin


def swiglu(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    gate, up = (x @ w13).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ w2


def experts(lw: Weights, d: dict, x: torch.Tensor) -> torch.Tensor:
    """The sparse feed-forward of (B, T, H), token by token's experts."""
    flat = x.reshape(-1, x.shape[-1])
    s = torch.sigmoid(flat @ lw("feed_forward.router.kernel"))
    choice = s + lw("feed_forward.expert_bias") if d["use_expert_bias"] else s
    picked = torch.topk(choice, d["num_experts_per_tok"], dim=-1).indices
    weight = torch.gather(s, 1, picked)
    if d["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-6)
    weight = weight * d["routed_scaling_factor"]
    w13, w2 = lw("feed_forward.w13"), lw("feed_forward.w2")
    out = torch.zeros_like(flat)
    for e in range(d["num_experts"]):
        token, slot = torch.nonzero(picked == e, as_tuple=True)
        if token.numel():
            out.index_add_(0, token, swiglu(flat[token], w13[e], w2[e]) * weight[token, slot, None])
    return out.view(x.shape)


def logits(w: Weights, cfg: dict, enc: torch.Tensor, enc_mask: torch.Tensor, prompt_ids: torch.Tensor,
           prompt_mask: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits (B, K, T, V) at the T decoder positions of the
    fused sequence ``[prompt (P) | codebook tokens (T)]``, as
    ``reference/decoder.logits``."""
    d = cfg["decoder"]
    n, kv, hdim, eps = d["num_attention_heads"], d["num_key_value_heads"], d["hidden_size"], d["norm_eps"]
    scale = (hdim // n) ** -0.5
    dw = w.sub("decoder.")
    tables = dw("embed_tokens.embedding")
    x = tables[torch.arange(inputs.shape[1], device=inputs.device)[None, :, None], inputs.long()].sum(1)
    x = torch.cat([w("embed_prompts.embedding")[prompt_ids], x], dim=1)
    b, t, _ = x.shape
    valid = torch.cat([prompt_mask.bool(), torch.ones(b, inputs.shape[2], dtype=torch.bool, device=x.device)], 1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    self_allowed = causal[None, None] & valid[:, None, None, :]
    cross_allowed = enc_mask.bool()[:, None, None, :]
    taps = d["conv_L_cache"]

    for i, kind in enumerate(d["layer_types"]):
        lw = dw.sub(f"layers.{i}.")
        h = rms(x, lw("operator_norm.scale"), eps)
        if kind == "conv":
            bgate, cgate, xx = (h @ lw("conv.in_proj.kernel")).chunk(3, dim=-1)
            bx = (bgate * xx) * valid[..., None]
            kernel = lw("conv.conv.kernel")  # (taps, H)
            conv = F.conv1d(bx.transpose(1, 2), kernel.T[:, None, :], padding=taps - 1, groups=hdim)[..., :t]
            x = x + (cgate * conv.transpose(1, 2)) @ lw("conv.out_proj.kernel")
        else:
            q = rms(heads(h @ lw("self_attn.q.kernel"), n), lw("self_attn.q_norm.scale"), eps)
            k = rms(heads(h @ lw("self_attn.k.kernel"), kv), lw("self_attn.k_norm.scale"), eps)
            v = heads(h @ lw("self_attn.v.kernel"), kv)
            q, k = rope(q, d["rope_theta"]), rope(k, d["rope_theta"])
            k, v = k.repeat_interleave(n // kv, 1), v.repeat_interleave(n // kv, 1)
            x = x + unheads(attend(q * scale, k, v, self_allowed)) @ lw("self_attn.o.kernel")
        h = rms(x, lw("cross_norm.scale"), eps)
        q = heads(h @ lw("cross_attn.q.kernel"), n) * scale
        k, v = (heads(enc @ lw(f"cross_attn.{c}.kernel"), n) for c in "kv")
        x = x + unheads(attend(q, k, v, cross_allowed)) @ lw("cross_attn.o.kernel")
        h = rms(x, lw("ffn_norm.scale"), eps)
        if i < d["num_dense_layers"]:
            x = x + swiglu(h, lw("feed_forward.w13.kernel"), lw("feed_forward.w2.kernel"))
        else:
            x = x + experts(lw, d, h)
    x = rms(x, dw("final_norm.scale"), eps)[:, prompt_ids.shape[1]:]
    return torch.einsum("bth,khv->bktv", x, dw("lm_heads.kernel"))
