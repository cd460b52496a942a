"""The Mamba-2 state-space layer's decode step (K8) and its prefill scan.

No TPU kernel or JAX counterpart: the Nemotron-H block family
(``models/nemotron_h.py``) exists only in the port.

:func:`ssm_step` is one decode step of every head of a layer, in place on the
layer's fp32 state ``(B, H, P, N)``: ``dt = softplus(dt_raw + dt_bias)``,
``S = exp(dt * -exp(A_log)) * S + (dt * x) (x) B``, ``y = S . C + D * x``,
head h reading group ``h // (H / G)`` of B and C.  On CPU tensors it runs
:func:`ssm_step_plain`, the recurrence in plain PyTorch; on CUDA tensors
``csrc/ssm_step.cu``, which reads and writes the state once (the source's
header gives its design).  Each launch counts as ``ssm_step``
(``core/graphs.count``).

:func:`ssd_scan` is the prefill's: the same recurrence over a whole
sequence from a zero state, computed by chunks of ``chunk`` positions (the
published Mamba-2 SSD form: a masked quadratic product inside each chunk,
the states carried between chunks), returning the outputs and the state
after the last position, all in fp32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parler_tts_tpu_torch.core import graphs
from parler_tts_tpu_torch.ops.cuda_build import DTYPES

STATE_SIZES = (64, 128)


def discretize(dt, dt_bias, a_log):
    """(softplus(dt + dt_bias), A = -exp(A_log)) in fp32; softplus as torch's
    (x past 20 is x)."""
    return F.softplus(dt.float() + dt_bias.float()), -torch.exp(a_log.float())


def ssm_step_plain(state: torch.Tensor, x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
                   dt_bias: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """state (B, H, P, N) fp32, updated in place; x (B, H*P), b/c (B, G*N),
    dt (B, H) -> y (B, H*P) in x's dtype."""
    bsz, heads, p, n = state.shape
    dt, a = discretize(dt, dt_bias, a_log)
    rep = heads // (b.shape[1] // n)
    xs = x.float().view(bsz, heads, p)
    bs = b.float().view(bsz, -1, n).repeat_interleave(rep, 1)
    cs = c.float().view(bsz, -1, n).repeat_interleave(rep, 1)
    state.mul_(torch.exp(dt * a)[..., None, None]).add_((dt[..., None] * xs)[..., None] * bs[:, :, None, :])
    y = (state * cs[:, :, None, :]).sum(-1) + d.float()[:, None] * xs
    return y.to(x.dtype).view(bsz, heads * p)


def _kernel():
    """The C entry point with its ctypes signature (built at first use)."""
    from parler_tts_tpu_torch.ops.cuda_build import library

    fn = library("ssm_step").ssm_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    return fn


def _check(state, x, b, c, dt, dt_bias, a_log, d) -> None:
    bsz, heads, p, n = state.shape
    if state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError(f"the SSM state must be contiguous fp32, got {state.dtype} strides {state.stride()}")
    if n not in STATE_SIZES:
        raise ValueError(f"the SSM step kernel takes state sizes {STATE_SIZES}, got {n}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (b, c, dt, dt_bias, a_log, d)):
        raise TypeError(f"the SSM step kernel takes fp32 or bf16 inputs of one dtype, got "
                        f"{[t.dtype for t in (x, b, c, dt, dt_bias, a_log, d)]}")
    groups = b.shape[1] // n
    if (x.shape != (bsz, heads * p) or b.shape != c.shape or b.shape[0] != bsz or groups * n != b.shape[1]
            or heads % groups or dt.shape != (bsz, heads) or b.stride() != c.stride()
            or any(t.shape != (heads,) or not t.is_contiguous() for t in (dt_bias, a_log, d))):
        raise ValueError(f"SSM step shapes: state {tuple(state.shape)}, x {tuple(x.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}, dt {tuple(dt.shape)}")
    for name, t in (("x", x), ("b", b), ("c", c), ("dt", dt)):
        if t.stride(1) != 1:
            raise ValueError(f"the SSM step kernel reads {name} with unit stride inside a row")
    for t in (x, b, c, dt, dt_bias, a_log, d):
        if t.device != state.device:
            raise ValueError(f"every input must be on the state's device {state.device}")


def _step_cuda(state, x, b, c, dt, dt_bias, a_log, d) -> torch.Tensor:
    _check(state, x, b, c, dt, dt_bias, a_log, d)
    bsz, heads, p, n = state.shape
    y = torch.empty((bsz, heads * p), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(state.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
                        dt_bias.data_ptr(), a_log.data_ptr(), d.data_ptr(), y.data_ptr(), bsz, heads, p, n,
                        b.shape[1] // n, DTYPES[x.dtype], x.stride(0), b.stride(0), dt.stride(0), stream)
    if err:
        raise RuntimeError(f"ssm_step launch failed: CUDA error {err}")
    graphs.count("ssm_step")
    return y


def ssm_step(state: torch.Tensor, x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
             dt_bias: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K8.  state (B, H, P, N) fp32, updated in place; x (B, H*P), b and c
    (B, G*N), dt (B, H) (rows read through their strides), dt_bias, a_log and
    d (H,) -> y (B, H*P) in x's dtype: the plain version on CPU tensors, the
    kernel on CUDA tensors."""
    fn = _step_cuda if state.is_cuda else ssm_step_plain
    return fn(state, x, b, c, dt, dt_bias, a_log, d)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L): entry (i, j) the sum of a over (j, i], -inf
    above the diagonal (summed, not differenced, as the published SSD)."""
    length = a.shape[-1]
    below = torch.ones(length, length, dtype=torch.bool, device=a.device).tril(-1)
    seg = torch.cumsum(a[..., :, None].expand(*a.shape, length).masked_fill(~below, 0.0), dim=-2)
    return seg.masked_fill(~below.logical_or(torch.eye(length, dtype=torch.bool, device=a.device)), float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, H, P), dt (B, T, H) (after the softplus), a (H,) (A, < 0), b
    and c (B, T, G, N), all fp32, from a zero state -> (y (B, T, H, P)
    without the D skip, the final state (B, H, P, N)).  T is padded to a
    multiple of ``chunk`` with dt = 0, which leaves the state as it is."""
    bsz, t, heads, p = x.shape
    groups, n = b.shape[2], b.shape[3]
    rep = heads // groups
    pad = -t % chunk
    if pad:
        x, dt, b, c = (F.pad(v, (0,) * (2 * (v.dim() - 2)) + (0, pad)) for v in (x, dt, b, c))
    nc = (t + pad) // chunk
    # chunks (B, nc, L, ...); heads as (G, rep)
    xd = (x * dt[..., None]).view(bsz, nc, chunk, groups, rep, p)
    da = (dt * a).view(bsz, nc, chunk, groups, rep).permute(0, 3, 4, 1, 2)  # (B, G, R, nc, L)
    b = b.view(bsz, nc, chunk, groups, n)
    c = c.view(bsz, nc, chunk, groups, n)
    cum = torch.cumsum(da, dim=-1)
    # inside each chunk: y_l = sum_{s <= l} (C_l . B_s) exp(sum da over (s, l]) xd_s
    decay = torch.exp(_segsum(da))  # (B, G, R, nc, L, S)
    cb = torch.einsum("bclgn,bcsgn->bgcls", c, b)  # (B, G, nc, L, S)
    y = torch.einsum("bgrcls,bcsgrp->bclgrp", cb[:, :, None] * decay, xd)
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(cum[..., -1:] - cum).permute(0, 3, 4, 1, 2)  # (B, nc, L, G, R)
    states = torch.einsum("bclgn,bclgrp->bcgrpn", b, xd * to_end[..., None])
    # the states between chunks: S_c = exp(sum of chunk c's da) S_{c-1} + states_c
    carried = [torch.zeros_like(states[:, 0])]
    chunk_decay = torch.exp(cum[..., -1])  # (B, G, R, nc)
    for i in range(nc):
        carried.append(chunk_decay[..., i, None, None] * carried[-1] + states[:, i])
    entering = torch.stack(carried[:-1], dim=1)  # (B, nc, G, R, P, N), the state before each chunk
    y = y + torch.einsum("bclgn,bcgrpn->bclgrp", c, entering) * torch.exp(cum).permute(0, 3, 4, 1, 2)[..., None]
    return y.reshape(bsz, nc * chunk, heads, p)[:, :t], carried[-1].reshape(bsz, heads, p, n)
