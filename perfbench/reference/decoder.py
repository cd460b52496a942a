"""The Parler-TTS decoder (MusicGen-style, as in the published Parler-TTS
code): the prompt's embeddings in front of the sum of the K codebook
embeddings, sinusoidal positions over the fused sequence, pre-LayerNorm
layers of causal self-attention, cross-attention to the projected text
encoder states and a GELU FFN, no biases, and one LM head per codebook.
The delay pattern shifts codebook k right by k steps."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import Weights, attend, heads, unheads


def sinusoids(n: int, dim: int, device) -> torch.Tensor:
    """(n, dim) table, ``[cos | sin]``, frequencies ``10000^(-i / (dim/2 - 1))``."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=device) * -(math.log(10000.0) / (half - 1)))
    angles = torch.arange(n, dtype=torch.float32, device=device)[:, None] * freq[None]
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=1)


def delay_pattern(k: int, length: int, device) -> torch.Tensor:
    """(K, length) bool: True where codebook k's token at step t is the
    model's choice, False where the pattern forces BOS (t <= k) or PAD (the
    last K - 1 - k steps)."""
    t = torch.arange(length, device=device)[None]
    kk = torch.arange(k, device=device)[:, None]
    return (t > kk) & (t < length - (k - 1) + kk)


def undelay(tokens: torch.Tensor) -> torch.Tensor:
    """(B, K, T) delayed tokens with their BOS column -> (B, K, T - K)
    aligned frames: codebook k's frame f is its token at step f + 1 + k."""
    b, k, t = tokens.shape
    frames = t - k
    idx = torch.arange(frames, device=tokens.device)[None] + 1 + torch.arange(k, device=tokens.device)[:, None]
    return torch.gather(tokens, 2, idx[None].expand(b, -1, -1))


def text_states(w: Weights, t5_out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The encoder states the decoder attends to: projected to its width
    when the widths differ, padding zeroed."""
    h = t5_out
    if "enc_to_dec_proj.kernel" in w.raw:
        h = h @ w("enc_to_dec_proj.kernel") + w("enc_to_dec_proj.bias")
    return h * mask[..., None].to(h.dtype)


def logits(w: Weights, cfg: dict, enc: torch.Tensor, enc_mask: torch.Tensor, prompt_ids: torch.Tensor,
           prompt_mask: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits (B, K, T, V) at the T decoder positions of the
    fused sequence ``[prompt (P) | codebook tokens (T)]``; ``inputs`` (B, K,
    T) are the delayed tokens fed in, the logits at step t predict step t+1."""
    d = cfg["decoder"]
    n, hdim = d["num_attention_heads"], d["hidden_size"]
    scale = (hdim // n) ** -0.5
    dw = w.sub("decoder.")
    tables = dw("embed_tokens.embedding")  # (K, V + 1, H)
    x = tables[torch.arange(inputs.shape[1], device=inputs.device)[None, :, None], inputs.long()].sum(1)
    x = torch.cat([w("embed_prompts.embedding")[prompt_ids], x], dim=1)
    b, t, _ = x.shape
    x = x + sinusoids(t, hdim, x.device).to(x.dtype)[None]
    valid = torch.cat([prompt_mask.bool(), torch.ones(b, inputs.shape[2], dtype=torch.bool, device=x.device)], 1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    self_allowed = causal[None, None] & valid[:, None, None, :]
    cross_allowed = enc_mask.bool()[:, None, None, :]

    def ln(x, p):
        return F.layer_norm(x, x.shape[-1:], dw(p + ".scale"), dw(p + ".bias"), 1e-5)

    for i in range(d["num_hidden_layers"]):
        p = f"layers.{i}."
        h = ln(x, p + "ln_self")
        q, k, v = (heads(h @ dw(f"{p}self_attn.{c}.kernel"), n) for c in "qkv")
        x = x + unheads(attend(q * scale, k, v, self_allowed)) @ dw(p + "self_attn.o.kernel")
        h = ln(x, p + "ln_cross")
        q = heads(h @ dw(p + "cross_attn.q.kernel"), n) * scale
        k, v = (heads(enc @ dw(f"{p}cross_attn.{c}.kernel"), n) for c in "kv")
        x = x + unheads(attend(q, k, v, cross_allowed)) @ dw(p + "cross_attn.o.kernel")
        h = ln(x, p + "ln_ffn")
        x = x + F.gelu(h @ dw(p + "fc1.kernel")) @ dw(p + "fc2.kernel")
    x = ln(x, "final_ln")[:, prompt_ids.shape[1]:]
    return torch.einsum("bth,khv->bktv", x, dw("lm_heads.kernel"))


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's best
    at its step: ``ref_logits`` (B, K, T-1, V) predict steps 1..T-1 of
    ``tokens`` (B, K, T); ``chosen`` (K, T) marks the model's steps.  0 at
    forced steps."""
    nxt = tokens[:, :, 1:].long()
    gap = ref_logits.amax(-1) - torch.gather(ref_logits, -1, nxt[..., None])[..., 0]
    return gap * chosen[None, :, 1:]


def topk_excess(ref_logits: torch.Tensor, tokens: torch.Tensor, chosen: torch.Tensor, k: int,
                temperature: float) -> torch.Tensor:
    """How far each sampled token's reference logit lies below the
    reference's k-th best at its step, in the sampler's units (logits over
    the temperature): 0 for a token inside the reference's top k, and at
    forced steps.  Shapes as ``token_gaps``."""
    scaled = ref_logits / temperature
    kth = torch.topk(scaled, k, dim=-1).values[..., -1]
    picked = torch.gather(scaled, -1, tokens[:, :, 1:].long()[..., None])[..., 0]
    return (kth - picked).clamp_min(0) * chosen[None, :, 1:]

