"""Flash attention, forward (K1) and backward (K2, K3, K4): the decoder's
causal self-attention in the prefill and in training.

Port of ``parler_tts_tpu/ops/pallas/flash_attention.py``.  Each of the four
TPU kernels has a wrapper here.  On CUDA tensors the wrapper launches the
hand-written Hopper kernel (``csrc/flash_attention_fwd.cu`` for K1,
``csrc/flash_attention_bwd.cu`` for K2-K4); on CPU tensors it runs the
kernel's plain PyTorch version with materialised scores.  There is no other
path: a CUDA tensor the kernel does not take (dtype, head dim, layout)
raises.

* K1 ``flash_attention_fwd``: ``out`` and ``lse``;
* K2 ``flash_attention_dq``: ``dq``, query-major;
* K3 ``flash_attention_dkv``: ``dk`` and ``dv``, key-major;
* K4 ``flash_attention_dqkv``: all three in one pass.

In bf16 all four run on the tensor cores (``mma.sync`` bf16 -> fp32, tiles
staged by ``cp.async``; p, and ds in the backward, are rounded to bf16
between the two products; the building blocks are in
``csrc/sm90_mma.cuh``); in fp32 they use fp32 FMAs on CUDA cores, which
hold the fp32 checks' 1e-4 tolerance that TF32 tensor cores would not.  Each
source's header describes its designs.

:class:`FlashAttention` is the autograd function around them, the
counterpart of the JAX ``custom_vjp``: forward saves q, k, v, the bounds,
``out`` and ``lse``; backward computes ``delta = rowsum(do * out)`` in fp32
and takes K4 where the JAX package takes its fused kernel (both sequences
fit one 1024 tile, unless ``PARLER_FLASH_NO_FUSED_BWD`` is set to a value
other than "0"), else K2 and K3.  The bounds get no gradient.

Semantics, those of the TPU kernels:

* key padding is given as per-row bounds ``[kv_start, kv_end)``, converted
  from a contiguous ``(B, Tk)`` mask (prompts are left-padded, descriptions
  right-padded); a mask whose valid positions are not one run is read as the
  run from its first valid position with the same count;
* masked scores are -1e9 (finite) and masked probabilities are zeroed, so a
  query row with no valid key gives ``out = 0`` and
  ``lse = -1e9 + log(1e-30)`` and contributes nothing to any gradient (the
  score-materialising path of the JAX decoder gives such rows uniform
  attention instead; they are padding rows whose outputs no valid row reads);
* softmax statistics, accumulation and gradient sums are fp32; outputs have
  the input dtype.
"""

from __future__ import annotations

import ctypes
import os

import torch

NEG_INF = -1e9

#: kernel launches since the counter was last reset, one counter per kernel
#: (the plain versions and the CPU path do not count): K1, K2, K3, K4
LAUNCHES = 0
LAUNCHES_DQ = 0
LAUNCHES_DKV = 0
LAUNCHES_DQKV = 0

FUSED_MAX_LEN = 1024  # the JAX package's default tile: one tile pair -> fused backward

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


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 sums, fp64 for fp64 inputs (gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _valid(tq, tk, kv_start, kv_end, causal, q_offset, device) -> torch.Tensor:
    """(BH, Tq, Tk) bool: key inside the row bounds and, when causal, not
    after the query's position."""
    k_pos = torch.arange(tk, device=device)[None, None, :]
    valid = (k_pos >= kv_start[:, None, None]) & (k_pos < kv_end.clamp(max=tk)[:, None, None])
    if causal:
        q_pos = q_offset + torch.arange(tq, device=device)[None, :, None]
        valid = valid & (k_pos <= q_pos)
    return valid


def flash_attention_plain(q, k, v, kv_start, kv_end, *, scale: float, causal: bool = True,
                          q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch, with materialised fp32 scores.

    q (BH, Tq, D), k/v (BH, Tk, D), kv_start/kv_end (BH,) -> out (BH, Tq, D)
    in q's dtype, lse (BH, Tq, 1) fp32."""
    acc = _acc_dtype(q)
    valid = _valid(q.shape[1], k.shape[1], kv_start, kv_end, causal, q_offset, q.device)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bqk,bkd->bqd", p, v.to(acc)) / l
    return out.to(q.dtype), m + torch.log(l)


def _backward_plain(q, k, v, do, lse, delta, kv_start, kv_end, *, scale, causal, q_offset):
    """The backward kernels' shared arithmetic with materialised scores:
    ``p = exp(s - lse)`` on valid pairs (0 elsewhere) and
    ``ds = p * (dp - delta) * scale`` with ``dp = do . v``; fp32."""
    acc = _acc_dtype(q)
    valid = _valid(q.shape[1], k.shape[1], kv_start, kv_end, causal, q_offset, q.device)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) * scale
    p = torch.where(valid, torch.exp(s - lse.to(acc)), torch.zeros_like(s))
    dp = torch.einsum("bqd,bkd->bqk", do.to(acc), v.to(acc))
    ds = p * (dp - delta.to(acc)) * scale
    return p, ds


def flash_dq_plain(q, k, v, do, lse, delta, kv_start, kv_end, *, scale: float, causal: bool = True,
                   q_offset: int = 0) -> torch.Tensor:
    """K2's function: ``dq = ds . k`` in q's dtype."""
    _, ds = _backward_plain(q, k, v, do, lse, delta, kv_start, kv_end, scale=scale, causal=causal,
                            q_offset=q_offset)
    return torch.einsum("bqk,bkd->bqd", ds, k.to(ds.dtype)).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, kv_start, kv_end, *, scale: float, causal: bool = True,
                    q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's function: ``dk = ds^T . q``, ``dv = p^T . do``."""
    p, ds = _backward_plain(q, k, v, do, lse, delta, kv_start, kv_end, scale=scale, causal=causal,
                            q_offset=q_offset)
    dk = torch.einsum("bqk,bqd->bkd", ds, q.to(ds.dtype))
    dv = torch.einsum("bqk,bqd->bkd", p, do.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dqkv_plain(q, k, v, do, lse, delta, kv_start, kv_end, *, scale: float, causal: bool = True,
                     q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's function: dq, dk and dv from one score computation."""
    p, ds = _backward_plain(q, k, v, do, lse, delta, kv_start, kv_end, scale=scale, causal=causal,
                            q_offset=q_offset)
    dq = torch.einsum("bqk,bkd->bqd", ds, k.to(ds.dtype))
    dk = torch.einsum("bqk,bqd->bkd", ds, q.to(ds.dtype))
    dv = torch.einsum("bqk,bqd->bkd", p, do.to(p.dtype))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- the CUDA kernels -------------------------------------------------------

_SIGNATURES = {  # C entry point -> (library, pointer arguments)
    "flash_attention_fwd": ("flash_attention_fwd", 7),
    "flash_attention_dq": ("flash_attention_bwd", 9),
    "flash_attention_dkv": ("flash_attention_bwd", 10),
    "flash_attention_dqkv": ("flash_attention_bwd", 11),
}


def _kernel(name: str):
    """A kernel's C entry point with its ctypes signature (built at first
    use): the pointers, then bh, tq, tk, d, is_bf16, scale, causal,
    q_offset and the stream."""
    from parler_tts_tpu_torch.ops.cuda_build import library

    lib, n_ptr = _SIGNATURES[name]
    fn = getattr(library(lib), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _check(name, q, k, v, kv_start, kv_end, *rows):
    """Raise on what the kernels do not take.  ``rows`` are (name, tensor,
    shape, dtype) of further inputs."""
    bh, _, d = q.shape
    tk = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes fp32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head dim {_HEAD_DIMS}, got {d}")
    if k.shape != (bh, tk, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be (BH, Tk, D) matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    if kv_start.dtype != torch.int32 or kv_end.dtype != torch.int32 or kv_start.shape != (bh,) \
            or kv_end.shape != (bh,):
        raise ValueError("kv_start/kv_end must be (BH,) int32")
    for arg, t, shape, dtype in rows:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{arg} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    named = [("q", q), ("k", k), ("v", v), ("kv_start", kv_start), ("kv_end", kv_end)]
    for arg, t in named + [(r[0], r[1]) for r in rows]:
        if t.device != q.device:
            raise ValueError(f"{arg} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous {arg}")


def _launch(name, tensors, q, tk, scale, causal, q_offset) -> None:
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(name)(*(t.data_ptr() for t in tensors), bh, tq, tk, d, _DTYPES[q.dtype],
                            float(scale), int(bool(causal)), int(q_offset), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _dispatch(plain, cuda, **kw):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    device = kw["q"].device
    if device.type == "cpu":
        return plain(**kw)
    if device.type == "cuda":
        return cuda(**kw)
    raise ValueError(f"flash attention runs on cuda or cpu tensors, got {device}")


def _fwd_cuda(q, k, v, kv_start, kv_end, *, scale, causal, q_offset):
    global LAUNCHES
    _check("flash_attention_fwd", q, k, v, kv_start, kv_end)
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[1], 1), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", (q, k, v, kv_start, kv_end, out, lse), q, k.shape[1], scale,
            causal, q_offset)
    LAUNCHES += 1
    return out, lse


def _bwd_rows(q, do, lse, delta):
    bh, tq, d = q.shape
    return (("do", do, (bh, tq, d), q.dtype), ("lse", lse, (bh, tq, 1), torch.float32),
            ("delta", delta, (bh, tq, 1), torch.float32))


def _dq_cuda(q, k, v, do, lse, delta, kv_start, kv_end, *, scale, causal, q_offset):
    global LAUNCHES_DQ
    _check("flash_attention_dq", q, k, v, kv_start, kv_end, *_bwd_rows(q, do, lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_attention_dq", (q, k, v, do, lse, delta, kv_start, kv_end, dq), q, k.shape[1],
            scale, causal, q_offset)
    LAUNCHES_DQ += 1
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, kv_start, kv_end, *, scale, causal, q_offset):
    global LAUNCHES_DKV
    _check("flash_attention_dkv", q, k, v, kv_start, kv_end, *_bwd_rows(q, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_dkv", (q, k, v, do, lse, delta, kv_start, kv_end, dk, dv), q,
            k.shape[1], scale, causal, q_offset)
    LAUNCHES_DKV += 1
    return dk, dv


def _dqkv_cuda(q, k, v, do, lse, delta, kv_start, kv_end, *, scale, causal, q_offset):
    global LAUNCHES_DQKV
    _check("flash_attention_dqkv", q, k, v, kv_start, kv_end, *_bwd_rows(q, do, lse, delta))
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)  # fp32 atomicAdd target
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_dqkv", (q, k, v, do, lse, delta, kv_start, kv_end, dq, dk, dv), q,
            k.shape[1], scale, causal, q_offset)
    LAUNCHES_DQKV += 1
    return dq.to(q.dtype), dk, dv


def flash_attention_fwd(q, k, v, kv_start, kv_end, *, scale: float = 1.0, causal: bool = True,
                        q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K1.  q (BH, Tq, D), k/v (BH, Tk, D), int32 bounds (BH,) -> (out (BH,
    Tq, D), lse (BH, Tq, 1) fp32).  Keys outside ``[kv_start, kv_end)`` and,
    when ``causal``, keys after ``q_offset + row`` are masked."""
    return _dispatch(flash_attention_plain, _fwd_cuda, q=q, k=k, v=v, kv_start=kv_start,
                     kv_end=kv_end, scale=scale, causal=causal, q_offset=q_offset)


def flash_attention_dq(q, k, v, do, lse, delta, kv_start, kv_end, *, scale: float = 1.0,
                       causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """K2.  ``do`` (BH, Tq, D) in q's dtype, ``lse`` and ``delta`` (BH, Tq, 1)
    fp32 -> dq (BH, Tq, D)."""
    return _dispatch(flash_dq_plain, _dq_cuda, q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                     kv_start=kv_start, kv_end=kv_end, scale=scale, causal=causal, q_offset=q_offset)


def flash_attention_dkv(q, k, v, do, lse, delta, kv_start, kv_end, *, scale: float = 1.0,
                        causal: bool = True, q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K3.  As K2 -> (dk, dv) (BH, Tk, D)."""
    return _dispatch(flash_dkv_plain, _dkv_cuda, q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                     kv_start=kv_start, kv_end=kv_end, scale=scale, causal=causal, q_offset=q_offset)


def flash_attention_dqkv(q, k, v, do, lse, delta, kv_start, kv_end, *, scale: float = 1.0,
                         causal: bool = True, q_offset: int = 0):
    """K4.  As K2 -> (dq, dk, dv)."""
    return _dispatch(flash_dqkv_plain, _dqkv_cuda, q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                     kv_start=kv_start, kv_end=kv_end, scale=scale, causal=causal, q_offset=q_offset)


def fused_backward(tq: int, tk: int) -> bool:
    """Whether the backward takes K4: both sequences fit one tile, as in the
    JAX ``_vjp_bwd`` (``nq == nk == 1``), and ``PARLER_FLASH_NO_FUSED_BWD``
    is unset or "0" (read at every call)."""
    fits = max(8, -(-tq // 8) * 8) <= FUSED_MAX_LEN and max(8, -(-tk // 8) * 8) <= FUSED_MAX_LEN
    return fits and os.environ.get("PARLER_FLASH_NO_FUSED_BWD", "0") == "0"


def flash_attention_bwd(q, k, v, kv_start, kv_end, out, lse, do, *, scale: float, causal: bool,
                        q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention`: ``delta = rowsum(do * out)``
    in fp32, then K4, or K2 and K3 (see :func:`fused_backward`)."""
    do = do.contiguous()
    acc = _acc_dtype(q)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1, keepdim=True)
    kw = dict(scale=scale, causal=causal, q_offset=q_offset)
    args = (q, k, v, do, lse, delta, kv_start, kv_end)
    if fused_backward(q.shape[1], k.shape[1]):
        return flash_attention_dqkv(*args, **kw)
    dk, dv = flash_attention_dkv(*args, **kw)
    return flash_attention_dq(*args, **kw), dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable K1: ``apply(q, k, v, kv_start, kv_end, scale, causal,
    q_offset) -> (out, lse)``; ``lse`` is not differentiable, the bounds
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start, kv_end, scale, causal, q_offset):
        out, lse = flash_attention_fwd(q, k, v, kv_start, kv_end, scale=scale, causal=causal,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, kv_start, kv_end, out, lse)
        ctx.args = (scale, causal, q_offset)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_start, kv_end, out, lse = ctx.saved_tensors
        scale, causal, q_offset = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_start, kv_end, out, lse, dout, scale=scale,
                                         causal=causal, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kv_start, kv_end, *, scale: float = 1.0, causal: bool = True,
                    q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable attention over q (BH, Tq, D), k/v (BH, Tk, D) and int32
    bounds (BH,) -> (out (BH, Tq, D), lse (BH, Tq, 1) fp32); forward K1,
    backward K4 or K2 + K3."""
    return FlashAttention.apply(q, k, v, kv_start, kv_end, scale, causal, q_offset)


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
