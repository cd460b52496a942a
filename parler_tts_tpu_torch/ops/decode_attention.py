"""Single-query attention over a KV cache: the decode step's self and cross
attention (K5).

The JAX package has no Pallas kernel here: XLA fuses the decode step's two
batched dots over the cache (``parler_tts_tpu/models/decoder.py``
``_self_attention_decode`` / ``_cross_attention_decode``;
``ops/runtime_flags.py`` says why).  The port's counterpart of that fusion is
the hand-written ``csrc/decode_attention.cu``, which reads the bf16 cache
slice in place, once, and keeps the scores on chip.  As for the
flash-attention kernels, the wrapper :func:`decode_attention` runs the plain
PyTorch version on CPU tensors and the kernel on CUDA tensors, and raises on
a CUDA tensor the kernel does not take; there is no other path.

Semantics, those of the plain version (the JAX decode arithmetic): fp32
scores of the pre-scaled q against k, keys whose ``kv_mask`` entry is 0 set
to -1e9 (so a row with no valid key attends uniformly), an fp32 softmax, the
probabilities rounded to the compute dtype, and p.v summed in fp32 and
returned in the compute dtype.  The mask is per key: in decode it has holes
(bucket padding, prompt padding, then the decoded positions).

Grouped-query attention: k/v may hold fewer heads than q, each K/V head
shared by ``group = H_q / H_kv`` consecutive query heads (query head h
reads K/V head h // group, as ``repeat_interleave`` would lay them out).
The kernel then gives one block to a (b, K/V head) and its group's queries,
so K and V cross HBM once for the group; a group of 1 is the MHA kernel.

The kernel cuts each (b, h) row's keys into ``splits`` runs only when the
rows alone would leave the card's SMs idle (:func:`decode_split`: a stream's
or a small server batch's few rows); each run takes its own softmax and a
second small kernel weighs the runs by their share of the row's softmax
mass.  Each call counts as one launch of ``decode_attention``
(``core/graphs.count``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from parler_tts_tpu_torch.core import graphs
from parler_tts_tpu_torch.ops.cuda_build import DTYPES, HEAD_DIMS, WIDE_HEAD_DIM, dispatch
from parler_tts_tpu_torch.ops.nn import NEG_INF

#: the split route aims at this many blocks per SM
BLOCKS_PER_SM = 4
#: keys per split at most: their fp32 scores fit 16 KB of shared memory
MAX_CHUNK = 4096
#: keys per split at least, when the rows leave SMs idle
MIN_CHUNK = 64

_MASK_BYTES = (1, 2, 4, 8)
#: query heads per K/V head the kernel takes
GROUPS = (1, 4, 16)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_mask: torch.Tensor) -> torch.Tensor:
    """q (B, H, 1, D) pre-scaled, k/v (B, H_kv, R, D) with H_kv dividing H,
    ``kv_mask`` (B, R), nonzero = valid -> (B, H, 1, D) in q's dtype, with
    materialised fp32 scores."""
    dtype = q.dtype
    b, h, _, d = q.shape
    qg = q.reshape(b, k.shape[1], h // k.shape[1], d)  # (B, H_kv, group, D)
    scores = torch.matmul(qg.float(), k.float().transpose(-1, -2))
    scores = scores.masked_fill(~kv_mask[:, None, None, :].bool(), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(dtype), v.to(dtype)).reshape(b, h, 1, d)


def decode_split(bh: int, r: int, sms: int, group: int = 1) -> tuple[int, int]:
    """(splits, keys per split) for ``bh`` blocks' rows of ``r`` keys on a
    card of ``sms`` SMs: one split when the rows give every SM
    ``BLOCKS_PER_SM`` blocks, else enough splits of at least ``MIN_CHUNK``
    keys to do so; never more than ``MAX_CHUNK // group`` keys a split (a
    block keeps its group's scores), and no empty split."""
    splits = max(min(-(-BLOCKS_PER_SM * sms // bh), -(-r // MIN_CHUNK)), -(-r // (MAX_CHUNK // group)), 1)
    chunk = -(-r // splits)
    return -(-r // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel():
    """The C entry point with its ctypes signature (built at first use)."""
    from parler_tts_tpu_torch.ops.cuda_build import library

    fn = library("decode_attention").decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 9
                       + [ctypes.c_void_p])
    return fn


def _check(q, k, v, kv_mask) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"decode attention takes one query (B, H, 1, D), got {tuple(q.shape)}")
    b, h, _, d = q.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention kernel takes fp32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS + (WIDE_HEAD_DIM,):
        raise ValueError(f"decode attention kernel takes head dim {HEAD_DIMS + (WIDE_HEAD_DIM,)}, got {d}")
    if (k.dim() != 4 or k.shape[0] != b or k.shape[1] == 0 or h % k.shape[1] or h // k.shape[1] not in GROUPS
            or k.shape[3] != d or v.shape != k.shape or k.shape[2] == 0):
        raise ValueError(f"k/v must be (B, H_kv, R > 0, D) matching q {tuple(q.shape)}, H / H_kv in {GROUPS}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(kv_mask.shape) != (b, k.shape[2]):
        raise ValueError(f"kv_mask must be (B, R) = {(b, k.shape[2])}, got {tuple(kv_mask.shape)}")
    if kv_mask.is_floating_point() or kv_mask.is_complex() or kv_mask.element_size() not in _MASK_BYTES:
        raise TypeError(f"kv_mask must be bool or integer, got {kv_mask.dtype}")
    vec = 16 // q.element_size()
    for name, t, strides in (("q", q, (0, 1)), ("k", k, (0, 1, 2)), ("v", v, (0, 1, 2))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or any(t.stride(i) % vec for i in strides) or t.data_ptr() % 16:
            raise ValueError(f"decode attention kernel needs {name} with unit stride over D and its rows "
                             f"on 16-byte boundaries, got strides {t.stride()}")
    if kv_mask.device != q.device or kv_mask.stride(1) != 1:
        raise ValueError("kv_mask must be on q's device with unit stride over R")


def _decode_cuda(q, k, v, kv_mask):
    _check(q, k, v, kv_mask)
    b, h, _, d = q.shape
    hk, r = k.shape[1], k.shape[2]
    group = h // hk
    splits, chunk = decode_split(b * hk, r, _sms(q.device.index if q.device.index is not None
                                                 else torch.cuda.current_device()), group)
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if splits > 1:  # the graph's pool under capture
        part_o = torch.empty((b * h * splits, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b * h * splits, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(), out.data_ptr(),
                        None if part_o is None else part_o.data_ptr(),
                        None if part_ml is None else part_ml.data_ptr(),
                        b, hk, group, r, d, DTYPES[q.dtype], splits, chunk, kv_mask.element_size(),
                        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
                        v.stride(2), kv_mask.stride(0), stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    graphs.count("decode_attention")
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor) -> torch.Tensor:
    """K5.  q (B, H, 1, D) pre-scaled, k/v (B, H_kv, R, D) (a cache slice, read
    in place through its strides; H / H_kv in ``GROUPS``), ``kv_mask`` (B, R),
    nonzero = valid -> out
    (B, H, 1, D) in q's dtype: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    return dispatch(decode_attention_plain, _decode_cuda, q=q, k=k, v=v, kv_mask=kv_mask)
