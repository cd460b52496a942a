"""Flash-attention forward (K1): the prefill's causal self-attention.

Port of ``parler_tts_tpu/ops/pallas/flash_attention.py`` (forward only).  On
CUDA tensors the wrapper launches the hand-written Hopper kernel
``csrc/flash_attention_fwd.cu``; on CPU tensors it runs
:func:`flash_attention_plain`, the same function in plain PyTorch with
materialised scores.  There is no other path: a CUDA tensor the kernel does
not take (dtype, head dim, layout) raises.

Semantics, those of the TPU kernel:

* key padding is given as per-row bounds ``[kv_start, kv_end)``, converted
  from a contiguous ``(B, Tk)`` mask (prompts are left-padded, descriptions
  right-padded); a mask whose valid positions are not one run is read as the
  run from its first valid position with the same count;
* masked scores are -1e9 (finite) and masked probabilities are zeroed, so a
  query row with no valid key gives ``out = 0`` and
  ``lse = -1e9 + log(1e-30)`` (the score-materialising path of the JAX
  decoder gives such rows uniform attention instead; they are padding rows
  whose outputs no valid row reads);
* softmax statistics and accumulation are fp32; ``out`` has the input dtype.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e9

#: kernel launches since the counter was last reset (the plain version and
#: the CPU path do not count)
LAUNCHES = 0

_HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kv_bounds(kv_mask: torch.Tensor | None, batch: int, heads: int, tk: int,
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, Tk) contiguous validity mask -> per-(batch*head) int32 bounds
    ``start = argmax(mask)``, ``end = start + sum(mask)`` (None = all valid)."""
    if kv_mask is None:
        start = torch.zeros(batch, dtype=torch.int32, device=device)
        end = torch.full((batch,), tk, dtype=torch.int32, device=device)
    else:
        m = kv_mask.to(device=device, dtype=torch.int32)
        start = torch.argmax(m, dim=1).to(torch.int32)
        end = start + m.sum(dim=1, dtype=torch.int32)
    return start.repeat_interleave(heads), end.repeat_interleave(heads)


def flash_attention_plain(q, k, v, kv_start, kv_end, *, scale: float, causal: bool = True,
                          q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, with materialised fp32 scores.

    q (BH, Tq, D), k/v (BH, Tk, D), kv_start/kv_end (BH,) -> out (BH, Tq, D)
    in q's dtype, lse (BH, Tq, 1) fp32."""
    tq, tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    k_pos = torch.arange(tk, device=q.device)[None, None, :]
    valid = (k_pos >= kv_start[:, None, None]) & (k_pos < kv_end.clamp(max=tk)[:, None, None])
    if causal:
        q_pos = q_offset + torch.arange(tq, device=q.device)[None, :, None]
        valid = valid & (k_pos <= q_pos)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()) / l
    return out.to(q.dtype), m + torch.log(l)


def _kernel():
    """The kernel's C entry point with its ctypes signature (built at first
    use)."""
    from parler_tts_tpu_torch.ops.cuda_build import library

    fn = library("flash_attention_fwd").flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _flash_attention_cuda(q, k, v, kv_start, kv_end, *, scale, causal, q_offset):
    global LAUNCHES

    bh, tq, d = q.shape
    tk = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes fp32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim {_HEAD_DIMS}, got {d}")
    if k.shape != (bh, tk, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be (BH, Tk, D) matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_start", kv_start), ("kv_end", kv_end)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs contiguous {name}")
    if kv_start.dtype != torch.int32 or kv_end.dtype != torch.int32 or kv_start.shape != (bh,) \
            or kv_end.shape != (bh,):
        raise ValueError("kv_start/kv_end must be (BH,) int32")

    out = torch.empty_like(q)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_start.data_ptr(),
                 kv_end.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, tq, tk, d,
                 _DTYPES[q.dtype], float(scale), int(bool(causal)), int(q_offset), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, lse


def flash_attention(q, k, v, kv_start, kv_end, *, scale: float = 1.0, causal: bool = True,
                    q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """q (BH, Tq, D), k/v (BH, Tk, D), int32 bounds (BH,) -> (out (BH, Tq, D),
    lse (BH, Tq, 1) fp32).  Keys outside ``[kv_start, kv_end)`` and, when
    ``causal``, keys after ``q_offset + row`` are masked."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_start, kv_end, scale=scale, causal=causal,
                                     q_offset=q_offset)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, kv_start, kv_end, scale=scale, causal=causal,
                                     q_offset=q_offset)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")


def flash_attention_bhtd_lse(q, k, v, kv_mask=None, *, scale: float, causal: bool = True,
                             q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, T, D) form with a (B, Tk) contiguous ``kv_mask`` ->
    (out (B, H, Tq, D), lse (B, H, Tq) fp32)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    start, end = kv_bounds(kv_mask, b, h, tk, q.device)
    out, lse = flash_attention(
        q.reshape(b * h, tq, d).contiguous(), k.reshape(b * h, tk, d).contiguous(),
        v.reshape(b * h, tk, d).contiguous(), start, end,
        scale=scale, causal=causal, q_offset=q_offset,
    )
    return out.reshape(b, h, tq, d), lse.reshape(b, h, tq)


def flash_attention_bhtd(q, k, v, kv_mask=None, *, scale: float, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """(B, H, T, D) attention with a (B, Tk) contiguous key mask -> out
    (B, H, Tq, D); the signature of the JAX ``flash_attention_bhtd``."""
    return flash_attention_bhtd_lse(q, k, v, kv_mask, scale=scale, causal=causal,
                                    q_offset=q_offset)[0]
