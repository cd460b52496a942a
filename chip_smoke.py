#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``parler_tts_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and power
   limit; build the hand-written CUDA kernels from ``parler_tts_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together);
2. kernels: each kernel (K1 the flash-attention forward; K2, K3, K4 its
   backward) against its plain PyTorch version on the card, at the main
   paths' shapes (tts and both training shapes) and at the CPU tests' odd
   shapes, in bf16 and fp32, with the tolerances stated below (also tile by
   tile, and K1's ``lse`` bit for bit on rows with no valid key); the
   backward's two routes (K4, and K2 + K3 forced by
   ``PARLER_FLASH_NO_FUSED_BWD=1``) against each other in fp32 and bf16;
   the build fails unless ``ptxas`` reports each bf16 tensor-core K1, K2,
   K3 and K4 at head dims 32 and 64 with no spills;
   device times (CUDA-graph replay) of each kernel, its plain version and the
   one PyTorch call computing the same function (timed as a yardstick only,
   never called by the port);
3. reference: a small config (``dummy_config``) at fp32 on the card (kernel
   path) and on the CPU (plain path): greedy generation must give the same
   tokens and waveforms, and one training step the same loss, gradient norm
   and gradients;
4. inference path: ``ParlerTTSPipeline.tts`` at full Parler-TTS Mini v0.1
   width (random weights from a seed, bf16), three calls of four requests
   whose prompt buckets give prefill lengths 17, 65 and 257; each call must
   launch K1 once per decoder layer.  Then one more call with each phase
   synchronised and timed, and a short call under torch.profiler for the
   device's busy time;
5. training path: ``make_train_step`` on Mini at full width and depth, fp32
   parameters with bf16 compute, the Mini recipe (AdamW lr 9.5e-4, beta
   (0.9, 0.99), wd 0.01, clip 1.0, dropout 0.1, one warmup update): 5 steps
   on one batch of 3 x 10 s (fused T = 903) launching K1 and K4 24 times per
   step, an eval step, one step under torch.profiler, then 2 steps at 1 x
   30 s (fused T = 2623) launching K2 and K3 24 times per step.  Losses must
   be finite and the last of the 5 below the first.

Output: a JSON line per phase, then the kernels line, then ``nvidia-smi``'s
``name, power.limit``, then the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # non-tensor fp32
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # on `out`; fp32 sums in another order, bf16 one output ulp
# and, scale-free, the Frobenius error over each 64-row tile of `out` relative
# to that tile (tile_rel_err): a long causal walk averages up to 2,600 values,
# so its outputs are about as small as TOL; a K1 that skips one 64-key tile of
# a walk at T = 2623 is off by far more than this in that tile (PERF.md)
OUT_TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_TOL = 1e-3
# backward kernels, relative to the largest |gradient| (at least 1): fp32 sums
# in another order (and K4's dq by atomics, whose order varies), bf16 one
# output ulp at the largest magnitude
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
# and, scale-free, the error's Frobenius norm over each 64-row tile of a
# gradient relative to that tile of the reference.  BWD_TOL alone lets through
# an error as large as the small gradients of long walks: a K3 that skips one
# 64-row tile of a walk in the second half of T = 2623 is off by 37 % in that
# tile and still inside it.  A correct K2 or K3 is off by at most 4e-3 in bf16
# (rounding of the outputs and of p and ds) and 1.4e-6 in fp32 (PERF.md).
BWD_TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_TILE = 64
# small config trained on the card and on the CPU, fp32: loss and grad norm
# relative, each gradient relative to its largest element (sums in another
# order, K4's dq by atomics)
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-4}
BWD_OPS_PER_PAIR = {"flash_attention_dq": 6, "flash_attention_dkv": 8, "flash_attention_dqkv": 10}  # x D
BWD_OUTPUTS = {"flash_attention_dq": 1, "flash_attention_dkv": 2, "flash_attention_dqkv": 3}
REPLACES = {
    "flash_attention_fwd": "parler_tts_tpu/ops/pallas/flash_attention.py:69",
    "flash_attention_dq": "parler_tts_tpu/ops/pallas/flash_attention.py:199",
    "flash_attention_dkv": "parler_tts_tpu/ops/pallas/flash_attention.py:154",
    "flash_attention_dqkv": "parler_tts_tpu/ops/pallas/flash_attention.py:239",
}
# bf16 K1, K2, K3, K4 on the tensor cores
MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel", "flash_dqkv_mma_kernel")
COUNTERS = {"flash_attention_fwd": "LAUNCHES", "flash_attention_dq": "LAUNCHES_DQ",
            "flash_attention_dkv": "LAUNCHES_DKV", "flash_attention_dqkv": "LAUNCHES_DQKV"}

DESCRIPTIONS = [
    "a female speaker with a low pitched voice speaks very fast",
    "a male speaker delivers a slightly expressive and animated speech with a moderate speed",
    "very clear audio",
    "a calm narrator with a deep voice reads slowly in a quiet room with almost no noise",
]
WORDS = ("hey how are you doing today the weather is fine and we will walk to the river "
         "before dinner then read a book").split()


def _prompts(n_words: int) -> list[str]:
    """Four prompts of different lengths, the longest ``n_words`` words."""
    lengths = (n_words, max(1, n_words // 3), max(1, n_words // 2), max(1, 2 * n_words // 3))
    return [" ".join(WORDS[(i + j) % len(WORDS)] for j in range(n)) for i, n in enumerate(lengths)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    replayed ``replays`` times between two events (host launch overhead
    excluded; inputs stay in L2, as they do for the prefill's attention)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def kernel_ms(fn, calls: int = 5) -> float:
    """Device time of one ``fn()`` as the sum of its kernels' durations under
    torch.profiler, over ``calls`` calls after a warm-up call: for work that
    is not captured in a graph (an autograd backward), where events around
    eager calls would also count the host's gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    return total_us / 1e3 / calls


def counts(fa) -> dict[str, int]:
    return {name: getattr(fa, attr) for name, attr in COUNTERS.items()}


def reset_counts(fa) -> None:
    for attr in COUNTERS.values():
        setattr(fa, attr, 0)


def valid_pairs(kv_mask: torch.Tensor, heads: int, t: int, causal: bool) -> int:
    """(query, key) pairs that this mask (and causality) leaves valid."""
    m = kv_mask.int().cpu()
    start = m.argmax(dim=1)
    end = start + m.sum(dim=1)
    rows = torch.arange(t)[None, :]
    hi = torch.minimum(end[:, None], rows + 1) if causal else end[:, None].expand(-1, t)
    return heads * int((hi - start[:, None]).clamp(min=0).sum())


def bound(nbytes: int, flops: int, peak: float):
    """Least time in ms, and what sets it."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound(kv_mask: torch.Tensor, heads: int, t: int, d: int, elem: int, causal: bool, peak: float):
    """Least time for this call: q, k, v read once, out and lse written once,
    against 4*D operations per (query, valid key) pair that this mask leaves."""
    bh = kv_mask.shape[0] * heads
    nbytes = 4 * bh * t * d * elem + bh * t * 4 + 2 * bh * 4
    return bound(nbytes, 4 * d * valid_pairs(kv_mask, heads, t, causal), peak)


def bwd_bound(name: str, kv_mask: torch.Tensor, heads: int, t: int, d: int, elem: int, causal: bool):
    """Least time of a backward kernel: q, k, v, do, lse, delta and the
    bounds read once, its gradients written once, against 6*D (K2), 8*D
    (K3) or 10*D (K4) operations per valid pair at the bf16 tensor-core
    peak."""
    bh = kv_mask.shape[0] * heads
    nbytes = (4 + BWD_OUTPUTS[name]) * bh * t * d * elem + 2 * bh * t * 4 + 2 * bh * 4
    return bound(nbytes, BWD_OPS_PER_PAIR[name] * d * valid_pairs(kv_mask, heads, t, causal), H100_BF16_FLOPS)


def check_k1(fa, q, k, v, start, end, out, lse, kw: dict, meta: dict) -> float:
    """K1's ``out`` and ``lse`` (BH, T, D) against its plain version on the
    same inputs: ``TOL``, ``OUT_TILE_TOL`` tile by tile, ``LSE_TOL``, and
    ``lse`` bit for bit on rows with no valid key (the backward kernels
    read it).  Emits a ``k1_check`` line; returns the max abs error."""
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, start, end, **kw)
    dtype = q.dtype
    out, lse = out.reshape(ref_out.shape), lse.reshape(ref_lse.shape)
    err = (out.float() - ref_out.float()).abs().max().item()
    tile_err = tile_rel_err(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    empty = ref_lse < -1e8  # rows with no valid key
    empty_exact = bool(torch.equal(lse[empty], ref_lse[empty]))
    ok = (math.isfinite(err) and err <= TOL[dtype] and tile_err <= OUT_TILE_TOL[dtype] and lse_err <= LSE_TOL
          and empty_exact)
    emit({"phase": "k1_check", **meta, "dtype": str(dtype).removeprefix("torch."), "max_abs_err_out": err,
          "tol_out": TOL[dtype], "max_tile_rel_err_out": tile_err, "tile_tol_out": OUT_TILE_TOL[dtype],
          "max_abs_err_lse": lse_err, "tol_lse": LSE_TOL, "rows_without_key": int(empty.sum()),
          "their_lse_bit_exact": empty_exact, "ok": ok})
    if not ok:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain version at {meta} {dtype}")
    return err


def check_kernels(fa) -> dict:
    """Phase 2: K1 against its plain version, then its times at the main
    path's shapes (bf16, BH = 4*16, causal, one left-padded row)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [((4, 16, t, 64), pad, True, "main path") for t, pad in ((17, 5), (65, 20), (257, 70))]
    cases += [((1, 2, 40, 32), 5, True, "odd shape"), ((2, 2, 300, 64), 0, False, "odd shape")]
    worst = 0.0
    per_shape = []
    for (b, h, t, d), pad, causal, kind in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
            kv_mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
            kv_mask[0, :pad] = 0
            out, lse = fa.flash_attention_bhtd_lse(q, k, v, kv_mask, scale=0.125, causal=causal)
            torch.cuda.synchronize()
            start, end = fa.kv_bounds(kv_mask, b, h, t, q.device)
            q3, k3, v3 = (x.reshape(b * h, t, d) for x in (q, k, v))
            err = check_k1(fa, q3, k3, v3, start, end, out, lse, dict(scale=0.125, causal=causal),
                           {"shape": [b, h, t, d], "pad": pad, "causal": causal, "kind": kind})
            if kind != "main path" or dtype != torch.bfloat16:
                continue
            worst = max(worst, err)
            valid = kv_mask.bool()[:, None, None, :]
            sdpa_mask = valid & torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
            row = {
                "shape": [b, h, t, d], "pad": pad,
                "ms": graph_ms(lambda: fa.flash_attention_fwd(q3, k3, v3, start, end, scale=0.125, causal=True)),
                "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q3, k3, v3, start, end, scale=0.125,
                                                                      causal=True)),
                "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                                              scale=0.125)),
            }
            row["bound_ms"], row["bound_by"] = k1_bound(kv_mask, h, t, d, 2, True, H100_BF16_FLOPS)
            row["fp32_core_bound_ms"] = k1_bound(kv_mask, h, t, d, 2, True, H100_FP32_FLOPS)[0]
            per_shape.append(row)
            emit({"phase": "k1_time", **row})
    return {"max_abs_err": worst, "per_shape": per_shape}


def tile_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ||got - ref|| / ||ref|| (Frobenius) over the 64-row
    tiles of a (BH, T, D) output or gradient; a tile whose reference is zero
    must be zero (inf otherwise)."""
    bh, t, d = ref.shape
    pad = (0, 0, 0, -t % BWD_TILE)
    diff = torch.nn.functional.pad(got.float() - ref.float(), pad).reshape(bh, -1, BWD_TILE * d)
    norm = torch.nn.functional.pad(ref.float(), pad).reshape(bh, -1, BWD_TILE * d).norm(dim=-1)
    err = diff.norm(dim=-1)
    if bool((err[norm == 0] > 0).any()) or not bool(torch.isfinite(err).all()):
        return math.inf
    return (err[norm > 0] / norm[norm > 0]).max().item() if bool((norm > 0).any()) else 0.0


BWD_NAMES = ("flash_attention_dq", "flash_attention_dkv", "flash_attention_dqkv")
# the training shape whose path launches each backward kernel: its row heads the kernels line
MAIN_SHAPE = {"flash_attention_dq": "main path 30 s", "flash_attention_dkv": "main path 30 s",
              "flash_attention_dqkv": "main path 10 s"}


def check_backward(fa) -> dict:
    """Phase 2, backward: K1, then K2, K3 and K4 against their plain
    versions at the training shapes (BH = 3*16, T = 903; BH = 16, T = 2623;
    causal, one left-padded row), the CPU tests' odd shapes and a Tq < Tk
    case with ``q_offset`` > 0 (one batch row with no valid pair), in bf16
    and fp32;
    the two routes against each other; then, in bf16, the times of K4 at the
    10 s shape and of K2 and K3 at the 30 s shape (the kernels each path
    takes) and at the 10 s shape, their plain versions and SDPA's backward
    with the same mask."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # (b, h, tq, d), tk, q_offset, left padding of each batch row, causal, kind; the
    # Tq < Tk case pads batch row 0 past every query row's causal limit (no valid pair)
    cases = [((3, 16, 903, 64), 903, 0, (20,), True, "main path 10 s"),
             ((1, 16, 2623, 64), 2623, 0, (12,), True, "main path 30 s"),
             ((1, 2, 40, 32), 40, 0, (5,), True, "odd shape"), ((2, 2, 300, 64), 300, 0, (0,), False, "odd shape"),
             ((3, 2, 200, 64), 456, 200, (420, 37, 0), True, "odd shape, Tq < Tk")]
    # each path's kernels, and at 10 s also the split route it was not given
    timed = {"main path 10 s": ("flash_attention_dqkv", "flash_attention_dq", "flash_attention_dkv"),
             "main path 30 s": ("flash_attention_dq", "flash_attention_dkv")}
    plain = {"flash_attention_dq": fa.flash_dq_plain, "flash_attention_dkv": fa.flash_dkv_plain,
             "flash_attention_dqkv": fa.flash_dqkv_plain}
    result = {name: {"max_abs_err": 0.0, "per_shape": []} for name in BWD_NAMES}
    result["flash_attention_fwd"] = {"per_shape": []}  # K1 at the training shapes
    for (b, h, t, d), tk, q_offset, pads, causal, kind in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, do = (torch.randn((b * h, t, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((b * h, tk, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
            kv_mask = torch.ones((b, tk), dtype=torch.int32, device="cuda")
            for row, pad in enumerate(pads):
                kv_mask[row, :pad] = 0
            start, end = fa.kv_bounds(kv_mask, b, h, tk, q.device)
            kw = dict(scale=0.125, causal=causal, q_offset=q_offset)
            out, lse = fa.flash_attention_fwd(q, k, v, start, end, **kw)
            check_k1(fa, q, k, v, start, end, out, lse, kw, {"shape": [b, h, t, d], "tk": tk, "q_offset": q_offset,
                                                            "pads": list(pads), "causal": causal, "kind": kind})
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            args = (q, k, v, do, lse, delta, start, end)
            pad = pads[0]
            ref = fa.flash_dqkv_plain(*args, **kw)
            got = {"flash_attention_dq": (fa.flash_attention_dq(*args, **kw),),
                   "flash_attention_dkv": fa.flash_attention_dkv(*args, **kw),
                   "flash_attention_dqkv": fa.flash_attention_dqkv(*args, **kw)}
            torch.cuda.synchronize()
            refs = {"flash_attention_dq": ref[:1], "flash_attention_dkv": ref[1:], "flash_attention_dqkv": ref}
            for name in BWD_NAMES:
                err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got[name], refs[name]))
                scale = max(1.0, max(r.float().abs().max().item() for r in refs[name]))
                tile_err = max(tile_rel_err(g, r) for g, r in zip(got[name], refs[name]))
                ok = math.isfinite(err) and err <= BWD_TOL[dtype] * scale and tile_err <= BWD_TILE_TOL[dtype]
                emit({"phase": "bwd_check", "kernel": name, "shape": [b, h, t, d], "tk": tk, "q_offset": q_offset,
                      "pads": list(pads), "causal": causal, "dtype": str(dtype).removeprefix("torch."),
                      "kind": kind, "max_abs_err": err, "tol": BWD_TOL[dtype] * scale,
                      "max_tile_rel_err": tile_err, "tile_tol": BWD_TILE_TOL[dtype], "ok": ok})
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain version at {(b, h, t, d)} {dtype}")
                if kind.startswith("main") and dtype == torch.bfloat16:
                    result[name]["max_abs_err"] = max(result[name]["max_abs_err"], err)
            if kind not in timed or dtype != torch.bfloat16:
                continue
            q4, k4, v4 = (x.reshape(b, h, t, d).detach().requires_grad_() for x in (q, k, v))
            sdpa_mask = kv_mask.bool()[:, None, None, :] & torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
            sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=sdpa_mask, scale=0.125)
            do4 = do.reshape(b, h, t, d)
            library_ms = kernel_ms(lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), do4, retain_graph=True))
            del sdpa_out
            k1 = {"kernel": "flash_attention_fwd", "shape": [b, h, t, d], "pad": pad,
                  "ms": graph_ms(lambda: fa.flash_attention_fwd(q, k, v, start, end, **kw)),
                  "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q, k, v, start, end, **kw), calls=3,
                                       replays=3),
                  "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                      q4.detach(), k4.detach(), v4.detach(), attn_mask=sdpa_mask, scale=0.125))}
            k1["bound_ms"], k1["bound_by"] = k1_bound(kv_mask, h, t, d, 2, causal, H100_BF16_FLOPS)
            result["flash_attention_fwd"]["per_shape"].append(k1)
            emit({"phase": "k1_time", **k1})
            for name in timed[kind]:
                kernel = getattr(fa, name)
                row = {"kernel": name, "shape": [b, h, t, d], "pad": pad, "path": kind == MAIN_SHAPE[name],
                       "ms": graph_ms(lambda: kernel(*args, **kw)),
                       "plain_ms": graph_ms(lambda: plain[name](*args, **kw), calls=3, replays=3),
                       "library_ms": library_ms,
                       "library_call": "scaled_dot_product_attention backward (dq, dk and dv together)"}
                row["bound_ms"], row["bound_by"] = bwd_bound(name, kv_mask, h, t, d, 2, causal)
                result[name]["per_shape"].append(row)
                emit({"phase": "bwd_time", **row})
    check_routes(fa)
    return result


def check_routes(fa) -> None:
    """The autograd function's two routes, K4 and (``PARLER_FLASH_NO_FUSED_BWD=1``)
    K2 + K3, on one input of 256 positions with a left-padded row, in fp32 and
    in bf16 (the tensor-core K2 + K3 against K4), within ``BWD_TOL`` and
    ``BWD_TILE_TOL``."""
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        q, k, v = (torch.randn((2, 3, 256, 64), generator=gen, device="cuda").to(dtype).requires_grad_()
                   for _ in range(3))
        kv_mask = torch.ones((2, 256), dtype=torch.int32, device="cuda")
        kv_mask[0, :70] = 0
        grads, launched = {}, {}
        saved = os.environ.get("PARLER_FLASH_NO_FUSED_BWD")
        try:
            for env in ("0", "1"):
                os.environ["PARLER_FLASH_NO_FUSED_BWD"] = env
                before = counts(fa)
                out = fa.flash_attention_bhtd(q, k, v, kv_mask, scale=0.125)
                grads[env] = torch.autograd.grad(out.float().sin().sum(), (q, k, v))
                after = counts(fa)
                launched[env] = {name: after[name] - before[name] for name in BWD_NAMES}
        finally:
            if saved is None:
                os.environ.pop("PARLER_FLASH_NO_FUSED_BWD")
            else:
                os.environ["PARLER_FLASH_NO_FUSED_BWD"] = saved
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads["0"], grads["1"]))
        scale = max(1.0, max(g.float().abs().max().item() for g in grads["0"]))
        tile_err = max(tile_rel_err(b.reshape(-1, *b.shape[2:]), a.reshape(-1, *a.shape[2:]))
                       for a, b in zip(grads["0"], grads["1"]))
        ok = (launched["0"] == {"flash_attention_dq": 0, "flash_attention_dkv": 0, "flash_attention_dqkv": 1}
              and launched["1"] == {"flash_attention_dq": 1, "flash_attention_dkv": 1, "flash_attention_dqkv": 0}
              and math.isfinite(err) and err <= BWD_TOL[dtype] * scale and tile_err <= BWD_TILE_TOL[dtype])
        emit({"phase": "bwd_routes", "dtype": str(dtype).removeprefix("torch."), "launched": launched,
              "max_abs_err_fused_vs_split": err, "tol": BWD_TOL[dtype] * scale,
              "max_tile_rel_err_fused_vs_split": tile_err, "tile_tol": BWD_TILE_TOL[dtype], "ok": ok})
        if not ok:
            raise AssertionError(f"the backward's fused and split routes disagree in {dtype}")


def check_reference(cfg_mod, parler, generate_mod) -> None:
    """Phase 3: dummy_config (4-layer 512-wide decoder, head dim 64, the full
    DAC) greedy at fp32: the card (kernel path) against the CPU (plain path)."""
    cfg = cfg_mod.dummy_config()
    cpu_model = parler.init(SEED, cfg, device="cpu")
    zero_special_heads(cpu_model)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gen = cfg_mod.GenerationConfig(max_length=30, do_sample=False)
    rng = torch.Generator().manual_seed(SEED)
    batch = dict(
        input_ids=torch.randint(3, 1000, (2, 11), generator=rng),
        attention_mask=torch.tensor([[1] * 11, [1] * 7 + [0] * 4]),
        prompt_input_ids=torch.randint(3, 1000, (2, 9), generator=rng),
        prompt_attention_mask=torch.tensor([[0] * 3 + [1] * 6, [1] * 9]),
    )
    ref = generate_mod.generate(cpu_model, gen, device="cpu", **batch)
    out = generate_mod.generate(gpu_model, gen, device="cuda", **batch)
    same_tokens = bool((out.tokens.cpu() == ref.tokens).all())
    audio_err = (out.audio.cpu() - ref.audio).abs().max().item()
    ok = same_tokens and audio_err <= 1e-3 and bool(torch.isfinite(out.audio).all())
    emit({"phase": "reference", "config": "dummy_config fp32", "same_tokens": same_tokens,
          "code_lengths": out.code_lengths.tolist(), "max_abs_err_audio": audio_err, "tol_audio": 1e-3,
          "ok": ok})
    if not ok:
        raise AssertionError("the card and the CPU disagree on the small config")


def check_train_reference(cfg_mod, parler, fa, step_mod, run_mod, data_mod, from_jax) -> None:
    """Phase 3, training: dummy_config at fp32 with dropout 0, one batch of
    two rows (left-padded prompts, ragged labels): the loss and gradients of
    ``train_forward`` and the loss and gradient norm of one train step on
    the card (K1, K4) and on the CPU (plain versions) must agree."""
    cfg = cfg_mod.dummy_config()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, dropout=0.0))
    cpu_model = parler.init(SEED, cfg, device="cpu")
    parler.set_trainable(cpu_model)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    samples = run_mod.prepare_synthetic(2, cfg, seed=SEED, desc_len=12, prompt_len=10, codes_len=40)
    batch = data_mod.Collator(0, 0, 12, 10, samples[0]["labels"].shape[1])(samples)
    results = {}
    reset_counts(fa)
    for device, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        tensors = {key: torch.from_numpy(value).to(device) for key, value in batch.items()}
        loss, _ = model.train_forward(**tensors, dtype=torch.float32)
        loss.backward()
        grads = from_jax.to_jax_tree(model, grads=True)
        state = step_mod.create_state(model, learning_rate=1e-3, warmup_steps=1)
        metrics = step_mod.make_train_step(cfg, dtype=torch.float32)(state, batch)
        results[device] = (loss.item(), grads, metrics["loss"].item(), metrics["grad_norm"].item())
    launched = counts(fa)
    (loss_c, grads_c, step_loss_c, norm_c), (loss_g, grads_g, step_loss_g, norm_g) = results["cpu"], results["cuda"]
    flat_c, flat_g = _flat(grads_c), _flat(grads_g)
    grad_err = max(float(abs(flat_g[k] - flat_c[k]).max() / max(abs(flat_c[k]).max(), 1e-12)) for k in flat_c)
    loss_err = max(abs(loss_g - loss_c), abs(step_loss_g - step_loss_c)) / abs(loss_c)
    norm_err = abs(norm_g - norm_c) / norm_c
    layers = cfg.decoder.num_hidden_layers
    ok = (loss_err <= TRAIN_TOL["loss"] and norm_err <= TRAIN_TOL["grad_norm"] and grad_err <= TRAIN_TOL["grad"]
          and launched["flash_attention_fwd"] == 2 * layers and launched["flash_attention_dqkv"] == 2 * layers
          and math.isfinite(loss_g))
    emit({"phase": "train_reference", "config": "dummy_config fp32, dropout 0", "loss_cpu": loss_c,
          "loss_cuda": loss_g, "grad_norm_cpu": norm_c, "grad_norm_cuda": norm_g, "rel_err_loss": loss_err,
          "rel_err_grad_norm": norm_err, "max_rel_err_grad": grad_err, "tol": TRAIN_TOL,
          "gradients": len(flat_c), "launched": launched, "ok": ok})
    if not ok:
        raise AssertionError("the card and the CPU disagree on the small config's train step")


def _flat(tree, prefix="") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


def zero_special_heads(model) -> None:
    """Zero the LM-head columns of the special ids (>= codebook_size).  With
    random weights every id is about equally likely, so a frame would hold a
    special (and end the sample) within a step or two; a trained model emits
    codec ids until it ends the sample.  This keeps the random model's output
    full length so the vocoder and the timings see a real workload."""
    with torch.no_grad():
        model.decoder.lm_heads.kernel[..., model.cfg.audio_encoder.codebook_size:] = 0


def run_main_path(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod, card: str) -> int:
    """Phase 4: tts at full Mini width.  Returns the kernel launches of the
    counted calls."""
    cfg = cfg_mod.mini_600m_config()
    model = parler.init(SEED, cfg, device="cuda", dtype=torch.bfloat16)
    zero_special_heads(model)
    gen = cfg_mod.GenerationConfig(do_sample=True, top_k=50)
    tok = tokenizer_mod.ToyTokenizer(vocab_size=cfg.vocab_size)
    pipe = pipeline_mod.ParlerTTSPipeline(model, cfg, gen, tok, tok, dtype=torch.bfloat16)
    pipe16 = pipeline_mod.ParlerTTSPipeline(model, cfg, gen, tok, tok, dtype=torch.bfloat16, pcm16=True)
    max_seconds = 2.5
    layers = cfg.decoder.num_hidden_layers
    hop = cfg.audio_encoder.hop_length

    calls = []
    reset_counts(fa)
    for i, (n_words, p) in enumerate(((10, pipe), (50, pipe), (200, pipe16))):
        prompts = _prompts(n_words)
        before = fa.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr, wavs = p.tts(DESCRIPTIONS, prompts, seed=SEED + i, max_seconds=max_seconds)
        wall = time.perf_counter() - t0
        launched = fa.LAUNCHES - before
        want = torch.int16 if p.pcm16 else torch.float32
        for w in wavs:
            if w.ndim != 1 or w.size == 0 or w.size % hop or str(w.dtype) != str(want).removeprefix("torch."):
                raise AssertionError(f"bad waveform: shape {w.shape}, dtype {w.dtype}, want 1-D {want}")
            if not torch.isfinite(torch.from_numpy(w.astype("float32"))).all():
                raise AssertionError("waveform holds non-finite values")
        if launched != layers:
            raise AssertionError(f"tts call launched flash_attention_fwd {launched} times, want {layers}")
        prompt_tokens = max(len(tok.encode(x)) for x in prompts)
        calls.append({"requests": len(wavs), "prompt_tokens": prompt_tokens,
                      "prefill_T": pipeline_mod._bucket(prompt_tokens) + 1, "pcm16": p.pcm16,
                      "samples": [int(w.size) for w in wavs], "sampling_rate": sr,
                      "wall_s": wall, "audio_s_per_wall_s": sum(w.size for w in wavs) / sr / wall,
                      "k1_launches": launched})
        emit({"phase": "tts", **calls[-1]})
    launches = counts(fa)
    if any(launches[name] for name in BWD_NAMES):
        raise AssertionError(f"inference launched a backward kernel: {launches}")

    timings = time_phases(model, pipe, _prompts(50), max_seconds)
    emit({"phase": "main_path", "config": "mini_600m_config bf16, random weights (seed 0)",
          "card": card, "max_seconds": max_seconds, **timings,
          "wall_s_per_call": [c["wall_s"] for c in calls],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # a short call: the profiler's event processing costs seconds per 100k kernels
    emit({"phase": "profile", "card": card, "max_seconds": 0.5,
          **profile_call(lambda: pipe.tts(DESCRIPTIONS, _prompts(50), seed=SEED, max_seconds=0.5))})
    return launches


def profile_call(fn) -> dict:
    """One warm call of ``fn`` under torch.profiler: the device's busy time
    (sum of kernel durations) against the call's wall time, which the
    profiler itself lengthens, the kernel count, and the kernels that take
    the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name: dict[str, float] = {}
    count = 0
    for e in prof.events():
        # kernels and copies; not the ranges that annotate them (an
        # optimizer's ``step``), which would count their time twice
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += 1
    if not count:
        return {"device_busy_share": None, "note": "the profiler recorded no device time"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    by_category: dict[str, float] = {}
    for name, us in by_name.items():
        cat = next((c for c, keys in PROFILE_CATEGORIES if any(k in name for k in keys)), "other")
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": sum(by_name.values()) / 1e3,
            "device_busy_share": sum(by_name.values()) / wall_us, "device_events": count,
            "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top]}


# device kernels by what they do, matched on their names (first match wins)
PROFILE_CATEGORIES = (
    ("port attention kernels", ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel", *MMA_KERNELS)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "Kernel2", "gemv")),
    ("optimizer and clipping (foreach)", ("multi_tensor_apply",)),
    ("layer norm", ("layer_norm",)),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
)


def train_step_model_flops(cfg, b, t_lab, desc_len, prompt_len) -> int:
    """Matmul FLOPs of one train step: forward plus twice that backward on
    the trainable path (decoder with full, not causal-discounted, attention
    squares; LM heads; the projection), the frozen T5 forward once; no
    recompute.  The count of ``benchmarks/train_bench.py``."""
    d = cfg.decoder
    h, layers, ffn = d.hidden_size, d.num_hidden_layers, d.ffn_dim
    tf, te = prompt_len + t_lab, desc_len
    layer = (4 * 2 * tf * h * h + 2 * 2 * tf * tf * h + 2 * 2 * tf * h * h + 2 * 2 * te * h * h
             + 2 * 2 * tf * te * h + 2 * 2 * tf * h * ffn)
    heads = d.num_codebooks * 2 * t_lab * h * d.vocab_size
    t5 = cfg.text_encoder
    hm, ff5 = t5.d_model, t5.d_ff
    t5_layer = 4 * 2 * te * hm * hm + 2 * 2 * te * te * hm + 3 * 2 * te * hm * ff5
    proj = 2 * te * hm * h if hm != h else 0
    return b * (3 * (layers * layer + heads + proj) + t5.num_layers * t5_layer)


def mini_batch(cfg, data_mod, *, seconds: int, prompt_lens, desc_lens, seed: int) -> dict:
    """A collated batch of full-length random codes (``seconds`` of audio
    per row), descriptions right-padded to 48 and prompts left-padded to
    32 tokens."""
    rng = np.random.default_rng(seed)
    k, frames = cfg.decoder.num_codebooks, seconds * cfg.frame_rate
    codes = [rng.integers(0, cfg.audio_encoder.codebook_size, (k, frames)) for _ in prompt_lens]
    labels, _ = data_mod.build_labels(codes, bos_token_id=cfg.decoder.bos_token_id,
                                      eos_token_id=cfg.decoder.eos_token_id, max_length=frames + k + 2)
    samples = [{"input_ids": rng.integers(0, cfg.text_encoder.vocab_size, (dl,)),
                "prompt_input_ids": rng.integers(0, cfg.vocab_size, (pl,)), "labels": lab}
               for dl, pl, lab in zip(desc_lens, prompt_lens, labels)]
    return data_mod.Collator(0, 0, 48, 32, frames + k + 2)(samples)


def run_train_path(cfg_mod, parler, fa, step_mod, data_mod, card: str) -> dict:
    """Phase 5: the training path at full Mini width.  Returns the kernel
    launches of the whole phase."""
    cfg = cfg_mod.mini_600m_config()
    layers = cfg.decoder.num_hidden_layers
    model = parler.init(SEED, cfg, device="cuda")  # fp32 parameters
    state = step_mod.create_state(model, learning_rate=9.5e-4, warmup_steps=1, b1=0.9, b2=0.99,
                                  weight_decay=0.01, max_grad_norm=1.0)
    train_step = step_mod.make_train_step(cfg, dtype=torch.bfloat16, dropout_seed=SEED)
    n_params = sum(p.numel() for p in state.optimizer.params)
    reset_counts(fa)
    out = {"config": "mini_600m_config, fp32 parameters, bf16 compute, random weights (seed 0)",
           "card": card, "trainable_params": n_params}
    for seconds, prompt_lens, desc_lens, n_steps, route in (
            (10, (32, 20, 27), (48, 31, 40), 5, "flash_attention_dqkv"),
            (30, (26,), (48,), 2, "flash_attention_dq")):
        batch = mini_batch(cfg, data_mod, seconds=seconds, prompt_lens=prompt_lens, desc_lens=desc_lens,
                           seed=SEED + seconds)
        b, t_lab = batch["labels"].shape[0], batch["labels"].shape[2]
        torch.cuda.reset_peak_memory_stats()
        before = counts(fa)
        steps = []
        for _ in range(n_steps):
            timings = {}
            t0 = time.perf_counter()
            metrics = train_step(state, batch, timings)
            step_ms = 1e3 * (time.perf_counter() - t0)
            steps.append({"step": metrics["step"], "loss": metrics["loss"].item(),
                          "grad_norm": metrics["grad_norm"].item(), "step_ms": step_ms, **timings})
            emit({"phase": "train_step", "seconds": seconds, "batch": b, **steps[-1]})
        after = counts(fa)
        launched = {name: (after[name] - before[name]) / n_steps for name in COUNTERS}
        losses = [s["loss"] for s in steps]
        want = {"flash_attention_fwd": layers, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                "flash_attention_dqkv": 0}
        if route == "flash_attention_dqkv":
            want["flash_attention_dqkv"] = layers
        else:
            want["flash_attention_dq"] = want["flash_attention_dkv"] = layers
        steady = steps[1:]
        step_s = sorted(s["step_ms"] for s in steady)[len(steady) // 2] / 1e3
        flops = train_step_model_flops(cfg, b, t_lab, 48, 32)
        summary = {
            "seconds": seconds, "batch": b, "label_frames": t_lab, "fused_T": 32 + t_lab,
            "losses": losses, "launches_per_step": launched, "median_step_ms": 1e3 * step_s,
            "forward_ms": [s["forward_ms"] for s in steps], "backward_ms": [s["backward_ms"] for s in steps],
            "optimizer_ms": [s["optimizer_ms"] for s in steps],
            "audio_s_per_wall_s": b * seconds / step_s,
            "codec_tokens_per_wall_s": b * t_lab * cfg.decoder.num_codebooks / step_s,
            "model_tflop_per_step": flops / 1e12, "mfu_vs_989_tflops": flops / step_s / H100_BF16_FLOPS,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        emit({"phase": "train", **summary})
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        if launched != want:
            raise AssertionError(f"train steps at {seconds} s launched {launched} per step, want {want}")
        prof = profile_call(lambda: train_step(state, batch))
        emit({"phase": "train_profile", "seconds": seconds, "batch": b, **prof})
        summary["profile"] = prof
        if seconds == 10:
            if not losses[-1] < losses[0]:
                raise AssertionError(f"the loss did not fall over {n_steps} steps: {losses}")
            eval_loss = step_mod.make_eval_step(cfg, dtype=torch.bfloat16)(model, batch)["loss"].item()
            if not math.isfinite(eval_loss):
                raise AssertionError(f"non-finite eval loss {eval_loss}")
            summary["eval_loss"] = eval_loss
        out[f"{seconds}s"] = summary
    out["launches"] = counts(fa)
    emit({"phase": "train_path", **{k: v for k, v in out.items() if not k.endswith("0s")}})
    return out


def time_phases(model, pipe, prompts, max_seconds) -> dict:
    """One more tts call with each phase synchronised and host-timed: T5
    encode, decoder prefill, each decode step, DAC vocode."""
    spans: dict[str, list[float]] = {"encode": [], "prefill": [], "decode_step": [], "vocode": []}
    targets = {"encode": (model, "encode_text"), "prefill": (model.decoder, "forward"),
               "decode_step": (model.decoder, "decode_step"), "vocode": (model.audio_encoder, "decode")}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name].append(1e3 * (time.perf_counter() - t0))
            return result
        return run

    for name, (obj, attr) in targets.items():
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        t0 = time.perf_counter()
        pipe.tts(DESCRIPTIONS, prompts, seed=SEED, max_seconds=max_seconds)
        wall = time.perf_counter() - t0
    finally:
        for obj, attr in targets.values():
            delattr(obj, attr)
    steps = spans["decode_step"]
    return {"encode_ms": sum(spans["encode"]), "prefill_ms": sum(spans["prefill"]),
            "decode_steps": len(steps), "decode_ms_per_step": sum(steps) / len(steps),
            "decode_ms_per_step_median": sorted(steps)[len(steps) // 2],
            "vocode_ms": sum(spans["vocode"]), "synced_wall_s": wall}


def ptxas_report(log: str) -> dict:
    """Registers and spilled bytes of each kernel in ``nvcc -Xptxas=-v``
    output, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
            out.setdefault(name, {"registers": None, "spill_bytes": 0})
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name]["spill_bytes"] = sum(nums[1:3])  # stack frame, spill stores, spill loads
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from parler_tts_tpu_torch import pipeline as pipeline_mod
    from parler_tts_tpu_torch.core import config as cfg_mod
    from parler_tts_tpu_torch.core import from_jax
    from parler_tts_tpu_torch.generation import generate as generate_mod
    from parler_tts_tpu_torch.models import parler
    from parler_tts_tpu_torch.ops import cuda_build
    from parler_tts_tpu_torch.ops import flash_attention as fa
    from parler_tts_tpu_torch.training import data as data_mod
    from parler_tts_tpu_torch.training import run_training as run_mod
    from parler_tts_tpu_torch.training import step as step_mod
    from parler_tts_tpu_torch.utils import toy_tokenizer as tokenizer_mod

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons below are exact-fp32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = cuda_build.build(["flash_attention_fwd", "flash_attention_bwd"])
    kernels_built = ptxas_report("\n".join(logs.values()))
    spills = {name: r for name, r in kernels_built.items() if "mma_kernel" in name and r["spill_bytes"]}
    # each tensor-core instance (the mangled name holds the head dim) must be in the report
    missing = [f"{kernel}<{d}>" for kernel in MMA_KERNELS for d in (32, 64)
               if not any(f"{kernel}ILi{d}E" in name and r["registers"] for name, r in kernels_built.items())]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "flags": " ".join(cuda_build.NVCC_FLAGS),
          "ptxas": kernels_built, "missing_from_ptxas": missing, "ok": not spills and not missing})
    if spills or missing:
        raise AssertionError(f"ptxas reports spills in the tensor-core kernels ({spills}) or misses {missing}")

    k1 = check_kernels(fa)
    bwd = check_backward(fa)
    check_reference(cfg_mod, parler, generate_mod)
    check_train_reference(cfg_mod, parler, fa, step_mod, run_mod, data_mod, from_jax)
    tts_launches = run_main_path(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod, card)
    torch.cuda.empty_cache()
    train = run_train_path(cfg_mod, parler, fa, step_mod, data_mod, card)
    train_launches = train["launches"]

    head = next(r for r in k1["per_shape"] if r["shape"][2] == 257)
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "parler_tts_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": REPLACES["flash_attention_fwd"],
        "launches": tts_launches["flash_attention_fwd"] + train_launches["flash_attention_fwd"],
        "launches_by_path": {"tts": tts_launches["flash_attention_fwd"],
                             "train": train_launches["flash_attention_fwd"]},
        "max_abs_err": k1["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": head["shape"], "per_shape": k1["per_shape"] + bwd["flash_attention_fwd"]["per_shape"],
    }]
    for name in BWD_NAMES:
        row = next(r for r in bwd[name]["per_shape"] if r["path"])
        kernels.append({
            "name": name, "route": "cuda", "source": "parler_tts_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": REPLACES[name], "launches": train_launches[name],
            "launches_by_path": {"tts": tts_launches[name], "train": train_launches[name]},
            "max_abs_err": bwd[name]["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_call": row["library_call"], "shape": row["shape"], "per_shape": bwd[name]["per_shape"],
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
