"""Nemotron-3-Nano-30B-A3B's decoder stack as Parler-TTS's codec decoder, in
plain float32 PyTorch: the full teacher-forced forward, no cache, no kernels,
no chunked scan.

The blocks follow the published NemotronH description
(huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json and
the ``nemotron_h`` modelling code), each ``x + mixer(RMSNorm(x))`` in
``layer_types`` order:

* ``mamba`` (Mamba-2): ``in_proj`` H -> z (heads x head dim), xBC (the same
  plus B and C, G groups of N each) and dt (heads); a depthwise causal
  convolution over xBC written as its ``conv_kernel`` taps, with its bias,
  then SiLU; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the state
  run step by step, ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x) B_t`` from
  zero, ``y_t = S_t C_t + D x_t``, head h reading group h // (heads / G);
  ``y * silu(z)`` RMS-normed over each group of heads x head dim / G
  channels, times its scale; ``out_proj``;
* ``attention``: q, k, v (``num_key_value_heads`` K/V heads, each serving a
  group of query heads) at ``attention_head_dim``, no positional encoding,
  a full causal softmax scaled by head_dim^-1/2, ``o``;
* ``moe``: ``s = sigmoid(x router)``, the top ``num_experts_per_tok`` of
  ``s + expert_bias``, weights the picked ``s`` over (their sum + 1e-20)
  times ``routed_scaling_factor``; each routed expert ``down(relu(up x)^2)``
  computed one by one, plus the shared expert of the same form on every
  token;
* a final RMSNorm, eps ``norm_eps``.

Departures from the published text LM, which make it Parler's codec decoder
on one card of an expert-parallel deployment (as the configuration file
lists them under ``assumed`` and ``reduced``):

* the token embedding and its head are replaced by the sum of the K
  codebook tables, the prompt table in front of them, and K LM heads;
* each attention block gains Parler's cross-attention sublayer to the
  projected text states after its self-attention: RMSNorm, multi-head
  attention of ``num_attention_heads`` bias-free heads at
  ``attention_head_dim``, ``o``, a residual;
* the expert layer holds the experts ``[first_expert, first_expert +
  experts_held)`` of the router's ``num_experts``: pairs routed to the others
  add nothing (the card's part of the result);
* padded prompt positions are masked as keys and zeroed as the
  convolution's input and output (as the published code zeroes padded
  hidden states), so the state does not move through them.

Weights by the program's state-dict names (``perfbench/weights.py``): fused
``in_proj`` (z | xBC | dt), the convolution's ``kernel`` (taps, channels),
expert stacks ``up`` (E, H, F) and ``down`` (E, F, H).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import Weights, attend, heads, unheads
from perfbench.reference.t5 import rms


def ssm_step(state, dt, a, x, bm, cm, dskip):
    """One step of the recurrence: state (B, heads, P, N), dt (B, heads)
    after the softplus, a (heads,), x (B, heads, P), bm and cm (B, heads, N)
    -> (the new state, y (B, heads, P))."""
    state = torch.exp(dt * a)[..., None, None] * state + (dt[..., None] * x)[..., None] * bm[:, :, None, :]
    return state, (state * cm[:, :, None, :]).sum(-1) + dskip[:, None] * x


def mamba(lw: Weights, d: dict, h: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 mixer over (B, T, H) normed input, ``valid`` (B, T)."""
    b, t, _ = h.shape
    nh, p, n, g = d["mamba_num_heads"], d["mamba_head_dim"], d["ssm_state_size"], d["mamba_n_groups"]
    inner = nh * p
    z, xbc, dt = torch.split(h @ lw("in_proj.kernel"), [inner, inner + 2 * g * n, nh], dim=-1)
    keep = valid[..., None].to(h.dtype)
    xbc = xbc * keep
    kernel = lw("conv.kernel")  # (taps, channels): tap j reads position t - (taps - 1) + j
    taps = kernel.shape[0]
    conv = torch.zeros_like(xbc)
    for j in range(taps):
        shift = taps - 1 - j
        conv[:, shift:] += xbc[:, :t - shift] * kernel[j]
    if d["use_conv_bias"]:
        conv = conv + lw("conv.bias")
    x, bm, cm = torch.split(F.silu(conv) * keep, [inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt + lw("dt_bias"))
    a = -torch.exp(lw("A_log"))
    dskip = lw("D")
    x = x.reshape(b, t, nh, p)
    bm = bm.reshape(b, t, g, n).repeat_interleave(nh // g, dim=2)
    cm = cm.reshape(b, t, g, n).repeat_interleave(nh // g, dim=2)
    state = torch.zeros(b, nh, p, n, dtype=h.dtype, device=h.device)
    ys = []
    for s in range(t):
        state, y = ssm_step(state, dt[:, s], a, x[:, s], bm[:, s], cm[:, s], dskip)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, t, inner)
    gated = (y * F.silu(z)).reshape(b, t, g, inner // g)
    gated = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True) + d["norm_eps"])
    return (gated.reshape(b, t, inner) * lw("norm.scale")) @ lw("out_proj.kernel")


def relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).square()


def experts(lw: Weights, d: dict, x: torch.Tensor) -> torch.Tensor:
    """The MoE layer over (B, T, H): the held routed experts, token by
    token's, and the shared expert."""
    flat = x.reshape(-1, x.shape[-1])
    s = torch.sigmoid(flat @ lw("router.kernel"))
    choice = s + lw("expert_bias") if d["use_expert_bias"] else s
    picked = torch.topk(choice, d["num_experts_per_tok"], dim=-1).indices
    weight = torch.gather(s, 1, picked)
    if d["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * d["routed_scaling_factor"]
    up, down = lw("up"), lw("down")
    first = d["first_expert"]
    out = torch.zeros_like(flat)
    for e in range(up.shape[0]):
        token, slot = torch.nonzero(picked == first + e, as_tuple=True)
        if token.numel():
            out.index_add_(0, token, relu2(flat[token] @ up[e]) @ down[e] * weight[token, slot, None])
    shared = relu2(flat @ lw("shared_up.kernel")) @ lw("shared_down.kernel")
    return (out + shared).view(x.shape)


def logits(w: Weights, cfg: dict, enc: torch.Tensor, enc_mask: torch.Tensor, prompt_ids: torch.Tensor,
           prompt_mask: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits (B, K, T, V) at the T decoder positions of the
    fused sequence ``[prompt (P) | codebook tokens (T)]``, as
    ``reference/decoder.logits``."""
    d = cfg["decoder"]
    n, kv, dim, eps = d["num_attention_heads"], d["num_key_value_heads"], d["attention_head_dim"], d["norm_eps"]
    scale = dim ** -0.5
    dw = w.sub("decoder.")
    tables = dw("embed_tokens.embedding")
    x = tables[torch.arange(inputs.shape[1], device=inputs.device)[None, :, None], inputs.long()].sum(1)
    x = torch.cat([w("embed_prompts.embedding")[prompt_ids], x], dim=1)
    b, t, _ = x.shape
    valid = torch.cat([prompt_mask.bool(), torch.ones(b, inputs.shape[2], dtype=torch.bool, device=x.device)], 1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    self_allowed = causal[None, None] & valid[:, None, None, :]
    cross_allowed = enc_mask.bool()[:, None, None, :]

    for i, kind in enumerate(d["layer_types"]):
        lw = dw.sub(f"layers.{i}.")
        h = rms(x, lw("norm.scale"), eps)
        if kind == "mamba":
            x = x + mamba(lw.sub("mixer."), d, h, valid)
        elif kind == "moe":
            x = x + experts(lw.sub("mixer."), d, h)
        else:
            q = heads(h @ lw("mixer.q.kernel"), n)
            k = heads(h @ lw("mixer.k.kernel"), kv).repeat_interleave(n // kv, 1)
            v = heads(h @ lw("mixer.v.kernel"), kv).repeat_interleave(n // kv, 1)
            x = x + unheads(attend(q * scale, k, v, self_allowed)) @ lw("mixer.o.kernel")
            h = rms(x, lw("cross_norm.scale"), eps)
            q = heads(h @ lw("cross_attn.q.kernel"), n) * scale
            k, v = (heads(enc @ lw(f"cross_attn.{c}.kernel"), n) for c in "kv")
            x = x + unheads(attend(q, k, v, cross_allowed)) @ lw("cross_attn.o.kernel")
    x = rms(x, dw("final_norm.scale"), eps)[:, prompt_ids.shape[1]:]
    return torch.einsum("bth,khv->bktv", x, dw("lm_heads.kernel"))
