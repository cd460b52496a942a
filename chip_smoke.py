#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``parler_tts_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and power
   limit; build the hand-written CUDA kernels from ``parler_tts_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together);
2. kernels: each kernel (K1 the flash-attention forward; K2, K3, K4 its
   backward; K5 the decode step's attention, at the benchmark cells' 96
   rows over a strided cache slice, on its split route at 1 and 4 rows,
   and at the LFM2 cell's 192 rows of 8 K/V heads with groups of 4
   queries) against its plain PyTorch version on the card, at the main
   paths' shapes (tts and both training shapes) and at the CPU tests' odd
   shapes, in bf16 and fp32, with the tolerances stated below (also tile by
   tile, and K1's ``lse`` bit for bit on rows with no valid key); the
   backward's two routes (K4, and K2 + K3 forced by
   ``PARLER_FLASH_NO_FUSED_BWD=1``) against each other in fp32 and bf16;
   the build fails unless ``ptxas`` reports each bf16 tensor-core K1, K2,
   K3 and K4 and each K5 kernel at head dims 32 and 64, K6's two instances,
   K7's four and K9's instances at the cells' widths, with no spills;
   device times (CUDA-graph replay) of each kernel, its plain version and the
   one PyTorch call computing the same function (timed as a yardstick only,
   never called by the port); the LFM2 cell's grouped experts against the
   loop over experts at its decode and prefill shapes, and their time; K6,
   the DAC decoder's Snake, against ``snake_fast`` bit for bit at each of the
   decoder's five levels for 4 rows of 10 s (``snake_time`` lines: its ms
   and the plain chain's against the bf16 tensor read and written once;
   ``snake_summary``: per audio second over a decode's 29 Snakes); K7, the
   DAC decoder's stride-1 convolutions, at each of a decode group's 25
   (``dac_conv_time`` lines: every output within one bf16 rounding of the
   fp32 result; its ms against its bound, the plain version's, the parent's
   cuDNN chain with the kernels it ran, and cuDNN channels-last under
   ``cudnn.benchmark`` as a yardstick; ``dac_conv_summary``: per audio
   second over a decode group, and one decode group of Mini's DAC profiled
   with K7 and with the parent's chain in its place); the Nemotron-H cell's
   K8, the Mamba-2 state update, against its plain version at the cell's
   128 rows (``ssm_check``; ``ssm_step_time``: its ms and % of its bound,
   the fp32 state read and written once), K5 at head dim 128 (groups 16
   and 1) and K1 at head dim 128 at the cell's shapes (``k5_time`` and
   ``k1_time`` lines with head dim 128); K9, the LayerNorm and RMSNorm,
   against the plain chains at each shape the cells send (``norm_time``
   lines: at least 99.9 % of the elements equal and the rest within one
   bf16 ulp, its ms and the plain chain's with its kernels, against x read
   and y written once; ``norm_summary``: each family's decode step's norms
   both ways);
3. reference: a small config (``dummy_config``) at fp32 on the card (kernel
   path) and on the CPU (plain path): greedy generation (composite,
   decoder-only continuation, int8 KV cache and weights, and a stream whose
   codes must also be ``generate``'s) must give the same tokens and
   waveforms, and one training step the same loss, gradient norm and
   gradients; the same decoder over ``facebook/encodec_24khz``'s codec
   (composite and ``generate(input_values=...)``: the same tokens, waveforms
   within 1e-4) and a small chunked 48 kHz-style EnCodec (the same codes,
   scales and overlap-added waveform).  Phases 2-3 run with TF32 off; every
   later phase runs under the defaults a user gets (the codecs pin their own
   fp32 convolutions);
4. inference path: ``ParlerTTSPipeline.tts`` at full Parler-TTS Mini v0.1
   width (random weights from a seed, bf16), three calls of four requests
   whose prompt buckets give prefill lengths 17, 65 and 257; each call must
   launch K1 once per decoder layer, K5 twice per layer per decode step
   (replayed or captured), K6 29 times and K7 25 times per DAC decode group
   (the train paths none), and K9 73 times per decode step and 98 per
   prefill (T5's 25, the decoder's 73; a train step T5's 25 alone).  Then
   one more call with each phase synchronised and timed, and a short call under torch.profiler for the device's busy
   time.  On the same model, each path with the counts set
   to 0 just before it and read just after, K1 once per layer per prefill
   and held against its plain version on each prefill's own tensors (a
   replayed prefill adds the K1 launches its graph holds, and its K1 is
   held on an eager prefill of the same inputs, which the replay equals
   bit for bit): decoder-only continuation of two DAC-encoded 2 s waveforms
   and composite ``generate(input_values=...)`` (batch 2, CFG 3.0); the
   int8 KV cache and int8 weights beside bf16 (decode ms/step, KV bytes,
   first-step logits);
   the decode loop replayed from CUDA graphs against the per-step eager
   loop (``decode_graph``: greedy fp32 and bf16, int8 weights and KV, CFG
   3.0 with top-k 50 sampled; the same tokens, ms/step both ways, launches
   per step, capture seconds, peak memory; a ``tts`` call that replays; the
   captured prefill against the eager ``prefill`` at T = 17, 65 and 257,
   int8, CFG 3.0, decoder-only and audio-prompted: the state bit for bit,
   ms both ways, capture seconds); ``stream_generate`` on the captured
   programs (no ``decode_step``) and on the per-step eager loop (batch 4,
   2.5 s, chunks of 86, lookback 48: the codes of both and ``generate``'s
   equal, first chunk and wall both ways, each chunk's vocode ms and the
   device's busy share of one, each fp32 chunk a one-shot vocode of the
   frames so far); ``BatchingEngine`` (warmup of the burst's batch buckets, a burst
   of 6 requests from threads, each batch replayed as a direct ``tts``);
   the demo server ``helpers/gradio_demo/app_torch.py`` over an engine on
   a ``pcm16`` pipeline, bound to 127.0.0.1:0 (a burst of 6 ``POST /api``
   requests, each response the WAV bytes of its batch's direct ``tts``
   replay, and ``GET /stats`` the recorded batches), then ``app_torch.py``
   itself as a subprocess on an artifact of the model, answering ``POST
   /api`` and ``POST /``.
   Reported with ``utils/mel.py`` on the card, not gated: the mel distance
   of the stream from a one-shot vocode of the whole utterance, and of the
   int8 call's waveforms from the bf16 call's (same input ids and seed);
5. EnCodec: Mini's decoder over 8 codebooks of ``facebook/encodec_24khz``'s
   codec (bf16, the same counts and holds): two ``tts`` calls, one timed
   phase by phase, and ``generate(input_values=...)`` on two 2 s waveforms;
   then the EnCodec encode side at fp32 as phase 8 runs the DAC's;
6. reference import: a seeded random Mini written as an HF-format
   checkpoint directory (two safetensors shards, the DAC weight-normed),
   ``from_reference_pretrained`` on the card (every tensor its source's bit
   for bit), one ``tts`` call with the source's tokens, then the converter
   to a port artifact and ``from_pretrained`` with the same tokens; then
   ``helpers/quality_gate_torch.py`` on the directory (each gate's line; it
   must pass), the source's T5 and DAC written as HF-format directories and
   ``init_model_600M_torch.py`` over them (the artifact's T5 and DAC the
   source's bit for bit, its tokenizer bundled), ``from_pretrained`` of
   that artifact and one ``tts``; the directories are deleted;
7. training path: ``make_train_step`` on Mini at full width and depth, fp32
   parameters with bf16 compute, the Mini recipe (AdamW lr 9.5e-4, beta
   (0.9, 0.99), wd 0.01, clip 1.0, dropout 0.1, one warmup update), at
   two shapes, each on both routes from the same initial state: twice
   eagerly and once captured (the default on one card: one CUDA graph per
   signature, replayed).  Per run: an eval step twice, then 5 steps on one
   batch of 3 x 10 s (fused T = 903) launching K1 and K4 24 times per step,
   or 3 steps at 1 x 30 s (fused T = 2623) launching K2 and K3 24 times per
   step, counted through replays; two steps under torch.profiler for the
   host's launches and the device's busy ms per step, one more for the
   device time by category.  Step ms, audio s per wall s, MFU, capture s,
   graph bytes and peak memory per route.  The captured run's losses,
   gradient norms and parameters must be the eager run's bit for bit where
   two eager runs agree bit for bit (K2 and K3 sum in a fixed order), else
   within ``TRAIN_GRAPH_SPREAD`` times their spread (K4's dq sums with fp32
   atomics); its eval losses the eager ones bit for bit; losses finite and
   the last of the 10 s run's below its first;
8. codec encode: the DAC encode side at Mini's codec (fp32) over 8 waveforms
   of 2-10 s through ``tokenize_audio_batches``: frame counts, and one 1 s
   clip's codes against the CPU's (differences only at near-ties, counted;
   also counted, not gated, for the conv stack outside the fp32 pin);
9. training CLI: ``run_training.main`` at full Mini width on
   ``synthetic://48``, 4 steps with checkpoints, rotation and an eval (loss
   and generation passes), then a second ``main`` that resumes from
   ``checkpoint-4-epoch-0`` (trainable parameters bit for bit) and runs
   steps 5 and 6, each run on the captured route (its first step captures,
   the others replay); K1 and K4 24 times per train step, counted through
   replays, and held against their plain versions on the tensors of their
   first call at each of the run's shapes (train step, eval loss batch,
   generation prefill);
10. ``ParlerTTSPipeline.from_pretrained`` over the CLI's ``final/`` artifact:
    one ``tts`` call with finite audio, and the artifact's tensors those of
    the last checkpoint.  The CLI's temporary output directory is deleted;
11. text: the port's ``tokenizer.json`` reader on the tokenizer fixtures of
    ``tests/fixtures/torch_tokenizers`` (the recorded ids, and its ids per
    second on this host); 12 in-memory rows prepared by the CLI's row loop
    at Mini's DAC (two dropped by the filters, a second preparation from
    the codes cache encoding nothing); ``run_training.main`` for 2 steps
    from that cache with the T5-shaped fixture as prompt tokenizer (K1 and
    K4 once per layer per step, held against their plain versions); and
    ``from_pretrained`` over its ``final/`` with no tokenizer argument: a
    ``tts`` of 2 real-text requests whose ids are the recorded ones and
    whose tokens equal ``generate``'s fed those ids;
12. multiprocess: ``run_training.main`` over several processes on this one
    card (the kernels are built before any is started, so every rank loads
    the same build), at Mini width from a seeded artifact with dropout off,
    3 steps on ``synthetic://12``: one rank under
    ``torch.distributed.run`` on NCCL; two gloo ranks on the card with
    data=2 (per-device batch 1); two with model=2, then greedy generation
    over the split artifact whose tokens equal the unsplit model's, and the
    rest of the inference surface over it: int8 weights with the int8 KV
    cache (fp32, batch 2: the unsplit int8 run's tokens, every int8 kernel
    and scale the unsplit view's slice bit for bit, the KV bytes per rank),
    ``stream_generate`` (chunks of 12 frames: codes the split ``generate``'s
    and the unsplit stream's, chunks equal on both ranks) and the
    ``BatchingEngine`` with rank 0 taking a warmup and a burst of 4 requests
    and rank 1 following (each batch a direct split ``tts`` bit for bit),
    K1 once per layer per prefill on each rank, held (phase 2 times K1 at
    these shapes).  Each
    run's losses and gradient norms against the single-process run at batch
    2 (run twice for its own spread) within the stated bound, K1 and K4
    once per layer per step on every rank and held against their plain
    versions at each rank's shapes (BH = 3 * 8 at T = 903 for model=2's 8
    heads too).  With one card, several-card NCCL runs are not checked.

Output: a JSON line per phase, then the kernels line, then ``nvidia-smi``'s
``name, power.limit``, then the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# DAC codes, card against CPU: the CPU's score of the card's code may fall
# below its best by this much (scores of unit vectors lie in [-1, 3]; the
# latents of the two devices differ by fp32 rounding), a near-tie
CODE_TIE_TOL = 1e-4
# a captured decode's first token that differs from the eager loop's must sit at a
# near-tie: its score gap within 2 bf16 ulps of the row's largest score
GRAPH_TIE_TOL = 2.0**-6
# the captured train step against the eager one, from the same state: each
# difference (loss and gradient norm relative, parameters absolute) within
# this many times the spread of two eager runs, which is 0 (bit for bit)
# where every kernel sums in a fixed order; K4 sums dq with fp32 atomics
TRAIN_GRAPH_SPREAD = 8.0
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
# K5, the decode step's attention, and its combine kernel (split route)
DECODE_KERNELS = ("decode_attn_kernel", "decode_attn_combine_kernel")
# K6's instances: 32-bit and 64-bit indices (mangled template arguments)
SNAKE_KERNELS = ("snake_kernelIjE", "snake_kernelIyE")
# the DAC decoder's Snakes per decode group at 86 frames a second, by level: (channels, T per
# frame, Snakes at that level); 29 in all
SNAKE_LEVELS = ((1536, 1, 1), (768, 8, 7), (384, 64, 7), (192, 256, 7), (96, 512, 7))
SNAKES_PER_DECODE = sum(n for _, _, n in SNAKE_LEVELS)
# K7's instances: 7 and 1 taps at 128-row (MI 4) and 96-row (MI 3) channel tiles
DAC_CONV_KERNELS = ("dac_conv7_kernelILi4E", "dac_conv7_kernelILi3E", "dac_conv1_kernelILi4E",
                    "dac_conv1_kernelILi3E")
# the DAC decoder's stride-1 convolutions per decode group at 86 frames a second: (C_in, C_out, taps,
# dilation, T per frame, residual); conv_in, then each level's three residual units (a k7 conv at
# dilation 1, 3, 9 and a k1 conv with the unit's input as residual); 25 in all
DAC_CONV_SHAPES = ((1024, 1536, 7, 1, 1, False),) + tuple(
    (c, c, k, d, per_frame, k == 1) for c, per_frame in ((768, 8), (384, 64), (192, 256), (96, 512))
    for d in (1, 3, 9) for k in (7, 1))
DAC_CONVS_PER_DECODE = len(DAC_CONV_SHAPES)
# K9's instances at the cells' widths (mangled: lanes a row, chunks of 8 a lane, LayerNorm, bf16 weights):
# 1024 LayerNorm (Parler), 768 / 2048 / 2688 / 64 RMSNorm (T5, LFM2, Nemotron-H, LFM2's q and k)
NORM_KERNELS = ("norm_kernelILi32ELi4ELb1E13__nv_bfloat16E", "norm_kernelILi32ELi3ELb0E13__nv_bfloat16E",
                "norm_kernelILi128ELi2ELb0E13__nv_bfloat16E", "norm_kernelILi128ELi3ELb0E13__nv_bfloat16E",
                "norm_kernelILi8ELi1ELb0E13__nv_bfloat16E")
# the norms the cells send K9, by site: (kind, rows, width) at 96 / 192 / 128 rows, T5 at 64 description tokens
NORM_SHAPES = {"parler": ("layer", 96, 1024), "lfm2": ("rms", 192, 2048), "lfm2_q": ("rms", 192 * 32, 64),
               "lfm2_k": ("rms", 192 * 8, 64), "nemotron_h": ("rms", 128, 2688), "t5": ("rms", 96 * 64, 768)}
# each family's norms per decode step by site, and T5's per prefill
NORM_SITES = {"parler": {"parler": 73}, "lfm2": {"lfm2": 73, "lfm2_q": 6, "lfm2_k": 6},
              "nemotron_h": {"nemotron_h": 59}, "t5_prefill": {"t5": 25}}
# the Nemotron-H cell's instances (mangled): K8 at a state of 128 in bf16, K1 at head dim 128, K5 at head
# dim 128 with groups of 16 and of 1
NEMOTRON_H_KERNELS = ("ssm_step_kernelI13__nv_bfloat16Li128EE", "flash_fwd_mma_kernelILi128E",
                      "decode_attn_kernelI13__nv_bfloat16Li128ELi16E", "decode_attn_kernelI13__nv_bfloat16Li128ELi1E")
H100_BF16_FLOPS = 989e12  # dense, SXM data sheet

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


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for fp32 matmuls and cuDNN convolutions inside the block
    (the fp32 comparisons of phases 2-3); the flags are restored after it, so
    the later phases run as a user's program does."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


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


_COUNTS_FROM: dict[str, int] = {}  # the launches at the last reset_counts()


def counts() -> dict[str, int]:
    """Each hand-written kernel's launches since the last ``reset_counts``
    (``core/graphs.launches``), by its name."""
    from parler_tts_tpu_torch.core import graphs

    return {name: n - _COUNTS_FROM.get(name, 0) for name, n in graphs.launches().items()}


def reset_counts() -> None:
    from parler_tts_tpu_torch.core import graphs

    _COUNTS_FROM.update(graphs.launches())


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
    path's shapes (bf16, BH = 4*16, causal, one left-padded row), the text
    phase's, and phase 12's split inference's (one rank's 8 heads; fp32
    where that path runs fp32)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, fp32 = (torch.bfloat16,), (torch.float32,)  # the dtypes timed at a shape
    cases = [((4, 16, t, 64), pad, True, "main path", bf16) for t, pad in ((17, 5), (65, 20), (257, 70))]
    # the training CLI's eval generation prefill: 2 rows (the eval batch), prompts left-padded to 16, + BOS
    cases += [((2, 16, 17, 64), 10, True, "main path CLI eval generation", ())]
    # the text phase's tts prefill: 2 requests, prompts left-padded to the 32 bucket, + BOS
    cases += [((2, 16, 33, 64), 12, True, "main path text tts prefill", bf16)]
    # phase 12's split model, one rank's 8 heads: the fp32 int8 and stream prefills (2 prompts of 8, + BOS);
    # the bf16 engine's warmup (2 rows) and burst (4 rows), prompts left-padded to 16, + BOS
    cases += [((2, 8, 9, 64), 3, True, "main path split int8 and stream prefill", fp32),
              ((2, 8, 17, 64), 10, True, "main path split engine warmup", bf16),
              ((4, 8, 17, 64), 10, True, "main path split engine burst", bf16)]
    cases += [((1, 2, 40, 32), 5, True, "odd shape", ()), ((2, 2, 300, 64), 0, False, "odd shape", ())]
    worst = 0.0
    per_shape = []
    for (b, h, t, d), pad, causal, kind, timed in cases:
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
            if dtype not in timed:
                continue
            worst = max(worst, err)
            valid = kv_mask.bool()[:, None, None, :]
            sdpa_mask = valid & torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
            row = {
                "kind": kind, "shape": [b, h, t, d], "pad": pad, "dtype": str(dtype).removeprefix("torch."),
                "ms": graph_ms(lambda: fa.flash_attention_fwd(q3, k3, v3, start, end, scale=0.125, causal=True)),
                "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q3, k3, v3, start, end, scale=0.125,
                                                                      causal=True)),
                "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                                              scale=0.125)),
            }
            if dtype == torch.bfloat16:
                row["bound_ms"], row["bound_by"] = k1_bound(kv_mask, h, t, d, 2, True, H100_BF16_FLOPS)
                row["fp32_core_bound_ms"] = k1_bound(kv_mask, h, t, d, 2, True, H100_FP32_FLOPS)[0]
            else:  # the fp32 CUDA-core kernel
                row["bound_ms"], row["bound_by"] = k1_bound(kv_mask, h, t, d, 4, True, H100_FP32_FLOPS)
            per_shape.append(row)
            emit({"phase": "k1_time", **row})
    return {"max_abs_err": worst, "per_shape": per_shape}


def decode_inputs(b: int, h: int, r: int, dtype, *, cross: bool, gen, group: int = 1, d: int = 64) -> tuple:
    """q (B, H * group, 1, d) pre-scaled; k/v (H K/V heads) as the decode
    step reads them: layer 1 of (2, B, H, r + 61, d) self buffers over r
    keys, or a contiguous (B, H, r, d) cross layer; a bool mask (B, r) with
    holes (left bucket padding, a short prompt's right padding, keys not yet
    decoded)."""
    q = (torch.randn((b, h * group, 1, d), generator=gen, device="cuda") * d**-0.5).to(dtype)
    length = r if cross else r + 61
    kbuf, vbuf = (torch.randn((2, b, h, length, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    mask = torch.ones((b, r), dtype=torch.bool, device="cuda")
    mask[0, : r // 5] = False
    mask[:, r // 3 : r // 3 + 9] = False
    mask[min(1, b - 1), r - r // 7 :] = False
    return q, kbuf[1, :, :, :r], vbuf[1, :, :, :r], mask


def check_decode_kernel(da) -> dict:
    """Phase 2: K5 against its plain version (``TOL`` on ``out``,
    ``OUT_TILE_TOL`` on each (b, h) row), then device times (CUDA-graph
    replay; inputs of 90-370 MB do not stay in L2) of the kernel, its plain
    version and SDPA with the same mask, against K and V read once at
    3.35 TB/s: at the benchmark cells' 96 x 16 rows over the mean and last
    KV-read buckets (558 and 934 of mini's) and the first (128), cross
    attention over 64 encoder positions, and the split route at 1 and 4
    rows (a stream, the smoke's batch), there also held to one split; and
    the LFM2 cell's grouped queries (192 rows x 8 K/V heads of 4 queries over
    its first, middle and last fused lengths 128, 448 and 822; its cross
    attention, 32 heads over 64, group 1).  ``shape`` is (B, query heads,
    keys, D)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (rows, K/V heads, group, keys, cross, kind, bf16)
    cases = [(96, 16, 1, r, False, "cells' self attention", True) for r in (128, 558, 934)]
    cases += [(96, 16, 1, 64, True, "cells' cross attention", True)]
    cases += [(b, 16, 1, r, False, "split route", True) for b in (1, 4) for r in (934, 4096)]
    cases += [(192, 8, 4, r, False, "LFM2 self attention", True) for r in (128, 448, 822)]
    cases += [(192, 32, 1, 64, True, "LFM2 cross attention", True)]
    cases += [(96, 16, 1, 558, False, "cells' self attention", False)]  # fp32, checked only
    rows, worst = [], 0.0
    for b, h, group, r, cross, kind, bf16 in cases:
        dtype = torch.bfloat16 if bf16 else torch.float32
        q, k, v, mask = decode_inputs(b, h, r, dtype, cross=cross, gen=gen, group=group)
        out = da.decode_attention(q, k, v, mask)
        ref = da.decode_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        row_err = tile_rel_err(out.reshape(b * h * group, 1, 64), ref.reshape(b * h * group, 1, 64))
        splits, chunk = da.decode_split(b * h, r, sms, group)
        meta = {"kind": kind, "shape": [b, h * group, r, 64], "kv_heads": h, "group": group,
                "dtype": str(dtype).removeprefix("torch."), "splits": splits, "keys_per_split": chunk}
        ok = math.isfinite(err) and err <= TOL[dtype] and row_err <= OUT_TILE_TOL[dtype]
        emit({"phase": "k5_check", **meta, "max_abs_err": err, "tol": TOL[dtype], "max_row_rel_err": row_err,
              "row_tol": OUT_TILE_TOL[dtype], "ok": ok})
        if not ok:
            raise AssertionError(f"decode_attention disagrees with its plain version at {meta}")
        worst = max(worst, err)
        if not bf16:
            continue
        sdpa_mask = mask[:, None, None, :]
        row = {**meta, "ms": graph_ms(lambda: da.decode_attention(q, k, v, mask)),
               "plain_ms": graph_ms(lambda: da.decode_attention_plain(q, k, v, mask)),
               "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                                             scale=1.0, enable_gqa=group > 1)),
               # the kernel reads K and V of the valid keys only
               "bound_ms": 1e3 * 2 * int(mask.sum()) * h * 64 * k.element_size() / H100_BYTES_PER_S}
        if splits > 1:  # the same kernel held to one split: what the split route saves
            split_choice = da.decode_split
            da.decode_split = lambda bh, r, sms, group=1: (1, r)
            try:
                row["one_split_ms"] = graph_ms(lambda: da.decode_attention(q, k, v, mask))
            finally:
                da.decode_split = split_choice
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        emit({"phase": "k5_time", **row})
    return {"max_abs_err": worst, "per_shape": rows}


def check_experts(moe) -> dict:
    """Phase 2: the LFM2 cell's grouped experts (``ops/moe.experts_grouped``:
    pairs sorted by expert, ``torch._grouped_mm`` over device offsets)
    against the loop over experts (``experts_plain``), bf16, at the cell's
    shapes: a decode step's 192 tokens x 4 experts (768 pairs) and its
    prefill's 192 x 65 tokens, 32 experts of 2048 -> 1792 -> 2048 at the
    benchmark's std 0.02.  Each token's output within ``OUT_TILE_TOL`` of the
    loop's (relative, Frobenius), the counts equal and none dropped; the
    grouped call given two experts' down projections swapped must miss that
    tolerance.  Then the grouped call's device time by graph replay (its
    705 MB of weights do not stay in L2) against its bound: each touched
    expert's weights read once at 3.35 TB/s, or 6 x H x F flops a pair at
    989 TFLOP/s, whichever is longer."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    e, h, f, k = 32, 2048, 1792, 4
    w13 = (torch.randn((e, h, 2 * f), generator=gen, device="cuda") * 0.02).bfloat16()
    w2 = (torch.randn((e, f, h), generator=gen, device="cuda") * 0.02).bfloat16()
    router = (torch.randn((h, e), generator=gen, device="cuda") * 0.02).bfloat16()
    bias = (torch.randn(e, generator=gen, device="cuda") * 0.02).bfloat16()
    swapped = w2[[1, 0, *range(2, e)]]
    tol = OUT_TILE_TOL[torch.bfloat16]
    rows = []
    for kind, tokens in (("decode step", 192), ("prefill", 192 * 65)):
        x = torch.randn((tokens, h), generator=gen, device="cuda").bfloat16()
        weights, experts = moe.route(x, router, bias, k)
        stats = [torch.zeros(3, dtype=torch.int64, device="cuda") for _ in range(2)]
        got = moe.experts_grouped(x, w13, w2, weights, experts, stats[0])
        ref = moe.experts_plain(x, w13, w2, weights, experts, stats[1])
        wrong = moe.experts_grouped(x, w13, swapped, weights, experts)

        def rel(a):
            return ((a.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1)).max().item()

        err, wrong_err = rel(got), rel(wrong)
        pairs, touched, dropped = stats[0].tolist()
        ok = (math.isfinite(err) and err <= tol < wrong_err and stats[0].tolist() == stats[1].tolist()
              and pairs == tokens * k and dropped == 0)
        meta = {"kind": kind, "tokens": tokens, "experts_per_token": k, "experts": e, "hidden": h, "width": f}
        emit({"phase": "experts_check", **meta, "max_token_rel_err": err, "tol": tol,
              "swapped_experts_rel_err": wrong_err, "stats": stats[0].tolist(), "ok": ok})
        if not ok:
            raise AssertionError(f"the grouped experts disagree with the loop over experts at {meta}")
        ms = graph_ms(lambda: moe.experts_grouped(x, w13, w2, weights, experts))
        bound_ms = 1e3 * max(touched * 3 * h * f * w2.element_size() / H100_BYTES_PER_S,
                             pairs * 6 * h * f / H100_BF16_FLOPS)
        row = {**meta, "ms": ms, "bound_ms": bound_ms, "share_of_bound": bound_ms / ms, "experts_touched": touched}
        rows.append(row)
        emit({"phase": "experts_time", **row})
    return {"per_shape": rows}


def check_nemotron_h_kernels(ssm_mod, da, fa) -> dict:
    """Phase 2: the Nemotron-H cell's new kernel and shapes.  K8 (the Mamba-2
    state update) against its plain version at the cell's step: 128 rows of
    64 heads x 64 over a state of 128 in 8 groups, x, B, C and dt read
    through one projection row's strides (``ssm_check``: the state within
    1e-5 + 1e-5 of itself, y within one bf16 rounding); its device time (``ssm_step_time``)
    against the fp32 state read and written once plus its inputs and output
    at 3.35 TB/s, and the plain version's.  K5 at head dim 128 at the cell's
    shapes (``k5_time`` lines with ``head_dim`` 128): self attention at
    group 16 over its first and last fused lengths (129, 822), cross
    attention at group 1 over 64; K1 at head dim 128 over the prefill's 32
    heads x 128 rows at 65 positions (a ``k1_time`` line)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    b, heads, p, n, groups = 128, 64, 64, 128, 8
    inner = heads * p
    state = torch.randn((b, heads, p, n), generator=gen, device="cuda")
    row = torch.randn((b, 2 * inner + 2 * groups * n + heads), generator=gen, device="cuda").bfloat16()
    x, bm = row[:, inner:2 * inner], row[:, 2 * inner:2 * inner + groups * n]
    cm, dt = row[:, 2 * inner + groups * n:2 * inner + 2 * groups * n], row[:, 2 * inner + 2 * groups * n:]
    dt_bias = (-2.0 - 4.0 * torch.rand(heads, generator=gen, device="cuda")).bfloat16()
    a_log = torch.log(1.0 + 15.0 * torch.rand(heads, generator=gen, device="cuda")).bfloat16()
    d = torch.ones(heads, device="cuda", dtype=torch.bfloat16)
    want_state = state.clone()
    want = ssm_mod.ssm_step_plain(want_state, x, bm, cm, dt, dt_bias, a_log, d)
    y = ssm_mod.ssm_step(state, x, bm, cm, dt, dt_bias, a_log, d)
    torch.cuda.synchronize()
    # each element's error over its tolerance: the state 1e-5 + 1e-5 |want|, y 1e-4 + 2^-7 |want|
    state_err = ((state - want_state).abs() / (1e-5 + 1e-5 * want_state.abs())).max().item()
    y_err = ((y.float() - want.float()).abs() / (1e-4 + 2**-7 * want.float().abs())).max().item()
    ok = state_err <= 1.0 and y_err <= 1.0
    emit({"phase": "ssm_check", "shape": [b, heads, p, n], "groups": groups, "state_err_over_tol": state_err,
          "y_err_over_tol": y_err, "ok": ok})
    if not ok:
        raise AssertionError("K8 disagrees with its plain version at the cell's step")
    nbytes = 2 * state.numel() * 4 + b * (2 * inner + 2 * groups * n + heads) * 2
    del want_state
    k8 = {"shape": [b, heads, p, n], "ms": graph_ms(lambda: ssm_mod.ssm_step(state, x, bm, cm, dt, dt_bias, a_log, d)),
          "plain_ms": graph_ms(lambda: ssm_mod.ssm_step_plain(state, x, bm, cm, dt, dt_bias, a_log, d), calls=2,
                               replays=3),
          "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S}
    k8["share_of_bound"] = k8["bound_ms"] / k8["ms"]
    emit({"phase": "ssm_step_time", **k8})
    del state
    torch.cuda.empty_cache()

    rows = []
    for kv_heads, group, r, cross in ((2, 16, 129, False), (2, 16, 822, False), (32, 1, 64, True)):
        q, k, v, mask = decode_inputs(b, kv_heads, r, torch.bfloat16, cross=cross, gen=gen, group=group, d=128)
        out = da.decode_attention(q, k, v, mask)
        err = (out.float() - da.decode_attention_plain(q, k, v, mask).float()).abs().max().item()
        if not err <= TOL[torch.bfloat16]:
            raise AssertionError(f"K5 at head dim 128 disagrees with its plain version ({err})")
        row = {"kind": "Nemotron-H " + ("cross" if cross else "self") + " attention",
               "shape": [b, kv_heads * group, r, 128], "head_dim": 128, "kv_heads": kv_heads, "group": group,
               "max_abs_err": err, "ms": graph_ms(lambda: da.decode_attention(q, k, v, mask)),
               "plain_ms": graph_ms(lambda: da.decode_attention_plain(q, k, v, mask)),
               "bound_ms": 1e3 * 2 * int(mask.sum()) * kv_heads * 128 * 2 / H100_BYTES_PER_S}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        emit({"phase": "k5_time", **row})
    t = 65
    q, k, v = (torch.randn((b * 32, t, 128), generator=gen, device="cuda").bfloat16() for _ in range(3))
    start = torch.zeros(b * 32, dtype=torch.int32, device="cuda")
    end = torch.full((b * 32,), t, dtype=torch.int32, device="cuda")
    kw = {"scale": 128**-0.5, "causal": True}
    out, _ = fa.flash_attention_fwd(q, k, v, start, end, **kw)
    err = (out.float() - fa.flash_attention_plain(q, k, v, start, end, **kw)[0].float()).abs().max().item()
    if not err <= TOL[torch.bfloat16]:
        raise AssertionError(f"K1 at head dim 128 disagrees with its plain version ({err})")
    k1 = {"kind": "Nemotron-H prefill", **k1_row(fa, q, k, v, start, end, kw), "max_abs_err": err}
    emit({"phase": "k1_time", **k1})
    return {"ssm_step": k8, "k5": rows, "k1": k1}


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


def check_bwd(name: str, got, ref, dtype, meta: dict) -> float:
    """A backward kernel's gradients against its plain version's on the same
    inputs: ``BWD_TOL`` relative to the largest |gradient| (at least 1), and
    ``BWD_TILE_TOL`` tile by tile.  Emits a ``bwd_check`` line; returns the
    max abs error."""
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    scale = max(1.0, max(r.float().abs().max().item() for r in ref))
    tile_err = max(tile_rel_err(g, r) for g, r in zip(got, ref))
    ok = math.isfinite(err) and err <= BWD_TOL[dtype] * scale and tile_err <= BWD_TILE_TOL[dtype]
    emit({"phase": "bwd_check", "kernel": name, **meta, "dtype": str(dtype).removeprefix("torch."),
          "max_abs_err": err, "tol": BWD_TOL[dtype] * scale, "max_tile_rel_err": tile_err,
          "tile_tol": BWD_TILE_TOL[dtype], "ok": ok})
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {meta} {dtype}")
    return err


BWD_NAMES = ("flash_attention_dq", "flash_attention_dkv", "flash_attention_dqkv")
# the training shape whose path launches each backward kernel: its row heads the kernels line
MAIN_SHAPE = {"flash_attention_dq": "main path 30 s", "flash_attention_dkv": "main path 30 s",
              "flash_attention_dqkv": "main path 10 s"}


def check_backward(fa) -> dict:
    """Phase 2, backward: K1, then K2, K3 and K4 against their plain
    versions at the training shapes (BH = 3*16, T = 903; BH = 16, T = 2623;
    causal, one left-padded row), the training CLI's (BH = 3*16, T = 91,
    prompts left-padded as its batches are), the CPU tests' odd shapes and a Tq < Tk
    case with ``q_offset`` > 0 (one batch row with no valid pair), in bf16
    and fp32;
    the two routes against each other; then, in bf16, the times of K4 at the
    10 s shape and of K2 and K3 at the 30 s shape (the kernels each path
    takes) and at the 10 s shape, their plain versions and SDPA's backward
    with the same mask; and K1 and K4 at the shapes a rank of the multiprocess
    phase takes under model=2 (8 of the 16 heads: BH = 3*8 at T = 903, the
    CLI's 2*8 at T = 91) and at the text phase's CLI shape (3*16, T = 385)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # (b, h, tq, d), tk, q_offset, left padding of each batch row, causal, kind; the
    # Tq < Tk case pads batch row 0 past every query row's causal limit (no valid pair)
    cases = [((3, 16, 903, 64), 903, 0, (20,), True, "main path 10 s"),
             ((1, 16, 2623, 64), 2623, 0, (12,), True, "main path 30 s"),
             ((3, 16, 91, 64), 91, 0, (10, 4, 0), True, "main path CLI"),
             ((3, 8, 903, 64), 903, 0, (20,), True, "main path 10 s, model=2"),
             ((2, 8, 91, 64), 91, 0, (10, 0), True, "main path CLI, model=2"),
             ((3, 16, 385, 64), 385, 0, (10, 4, 0), True, "main path text CLI"),
             ((1, 2, 40, 32), 40, 0, (5,), True, "odd shape"), ((2, 2, 300, 64), 300, 0, (0,), False, "odd shape"),
             ((3, 2, 200, 64), 456, 200, (420, 37, 0), True, "odd shape, Tq < Tk")]
    # each path's kernels, and at 10 s also the split route it was not given
    timed = {"main path 10 s": ("flash_attention_dqkv", "flash_attention_dq", "flash_attention_dkv"),
             "main path 30 s": ("flash_attention_dq", "flash_attention_dkv"),
             **{kind: ("flash_attention_dqkv",) for kind in ("main path 10 s, model=2", "main path CLI, model=2",
                                                             "main path text CLI")}}
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
                err = check_bwd(name, got[name], refs[name], dtype,
                                {"shape": [b, h, t, d], "tk": tk, "q_offset": q_offset, "pads": list(pads),
                                 "causal": causal, "kind": kind})
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
            k1 = {"kernel": "flash_attention_fwd", "kind": kind, "shape": [b, h, t, d], "pad": pad,
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
                row = {"kernel": name, "kind": kind, "shape": [b, h, t, d], "pad": pad,
                       "path": kind == MAIN_SHAPE[name],
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
                before = counts()
                out = fa.flash_attention_bhtd(q, k, v, kv_mask, scale=0.125)
                grads[env] = torch.autograd.grad(out.float().sin().sum(), (q, k, v))
                after = counts()
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


def check_reference(cfg_mod, parler, generate_mod, streaming_mod) -> None:
    """Phase 3: dummy_config (4-layer 512-wide decoder, head dim 64, the full
    DAC) greedy at fp32, the card (kernel path) against the CPU (plain
    path): composite generation, decoder-only continuation of 5 frames of
    codes, the int8 KV cache with int8 weights, and a stream (chunks of 8
    frames, lookback 48) whose codes must also be the card's ``generate``'s.
    The same tokens, and waveforms within 1e-3."""
    from parler_tts_tpu_torch.models.delay_pattern import undelay_pattern

    cfg = cfg_mod.dummy_config()
    cpu_model = parler.init(SEED, cfg, device="cpu")
    zero_special_heads(cpu_model)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gen = cfg_mod.GenerationConfig(max_length=30, do_sample=False)
    int8 = dataclasses.replace(gen, kv_cache_dtype="int8", int8_weights=True)
    rng = torch.Generator().manual_seed(SEED)
    batch = dict(
        input_ids=torch.randint(3, 1000, (2, 11), generator=rng),
        attention_mask=torch.tensor([[1] * 11, [1] * 7 + [0] * 4]),
        prompt_input_ids=torch.randint(3, 1000, (2, 9), generator=rng),
        prompt_attention_mask=torch.tensor([[0] * 3 + [1] * 6, [1] * 9]),
    )
    codes = torch.randint(0, cfg.audio_encoder.codebook_size, (2, cfg.decoder.num_codebooks, 5), generator=rng)
    cases = {
        "composite": lambda model, device: generate_mod.generate(model, gen, device=device, **batch),
        "decoder_only": lambda model, device: generate_mod.generate_decoder_only(
            model, gen, decoder_input_codes=codes, device=device),
        "int8 kv and weights": lambda model, device: generate_mod.generate(model, int8, device=device, **batch),
    }
    for case, run in cases.items():
        ref, out = run(cpu_model, "cpu"), run(gpu_model, "cuda")
        same_tokens = bool((out.tokens.cpu() == ref.tokens).all())
        audio_err = (out.audio.cpu() - ref.audio).abs().max().item()
        ok = same_tokens and audio_err <= 1e-3 and bool(torch.isfinite(out.audio).all())
        emit({"phase": "reference", "case": case, "config": "dummy_config fp32", "same_tokens": same_tokens,
              "code_lengths": out.code_lengths.tolist(), "max_abs_err_audio": audio_err, "tol_audio": 1e-3,
              "ok": ok})
        if not ok:
            raise AssertionError(f"the card and the CPU disagree on the small config ({case})")
    streams = {device: list(streaming_mod.stream_generate(model, gen, chunk_frames=8, device=device, **batch))
               for device, model in (("cpu", cpu_model), ("cuda", gpu_model))}
    s_codes = {d: np.concatenate([c.codes for c in chunks], axis=2) for d, chunks in streams.items()}
    s_audio = {d: np.concatenate([c.audio for c in chunks], axis=1) for d, chunks in streams.items()}
    offline = undelay_pattern(generate_mod.generate(gpu_model, gen, vocode=False, device="cuda", **batch).tokens[
        :, :, 1:]).cpu().numpy()[:, :, : s_codes["cuda"].shape[2]]
    same = bool(np.array_equal(s_codes["cuda"], s_codes["cpu"]))
    as_generate = bool(np.array_equal(s_codes["cuda"], offline))
    audio_err = float(np.abs(s_audio["cuda"] - s_audio["cpu"]).max())
    ok = same and as_generate and audio_err <= 1e-3 and len(streams["cuda"]) == len(streams["cpu"]) > 1
    emit({"phase": "reference", "case": "stream", "config": "dummy_config fp32", "chunks": len(streams["cuda"]),
          "same_codes": same, "codes_equal_generate": as_generate, "max_abs_err_audio": audio_err,
          "tol_audio": 1e-3, "ok": ok})
    if not ok:
        raise AssertionError("the card's stream is not the CPU's, or not generate's")


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
    reset_counts()
    for device, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        tensors = {key: torch.from_numpy(value).to(device) for key, value in batch.items()}
        loss = model.train_forward(**tensors, dtype=torch.float32)[0]
        loss.backward()
        loss = loss.item()  # the autograd graph goes: a captured step meets none of its nodes
        grads = from_jax.to_jax_tree(model, grads=True)
        state = step_mod.create_state(model, learning_rate=1e-3, warmup_steps=1)
        metrics = step_mod.make_train_step(cfg, dtype=torch.float32)(state, batch)
        results[device] = (loss, grads, metrics["loss"].item(), metrics["grad_norm"].item())
    launched = counts()
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


def check_snake(dac_mod, snake_mod, frames: int = 862, rows: int = 4) -> dict:
    """Phase 2: K6 against ``snake_fast`` bit for bit at each level of the
    DAC decoder (``SNAKE_LEVELS``) for a group of ``rows`` rows of
    ``frames`` frames (10 s at 86 Hz), alphas drawn in (0.05, 2.05); then
    device times (CUDA-graph replay) of K6 and of the plain chain, against
    the bf16 input read once and the output written once at 3.35 TB/s.  The
    summary weighs the levels by their Snakes per decode group, per audio
    second."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows_out, totals = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for c, per_frame, snakes in SNAKE_LEVELS:
        t = frames * per_frame
        x = (torch.randn((rows, c, t), generator=gen, device="cuda") * 3).to(torch.bfloat16)
        alpha = torch.rand(c, generator=gen, device="cuda") * 2 + 0.05
        out = snake_mod.snake_fast_cuda(x, alpha, dac_mod._SIN2_COEFFS)
        ref = dac_mod.snake_fast(x, alpha)
        torch.cuda.synchronize()
        differ = int((out.view(torch.int16) != ref.view(torch.int16)).sum())
        del out, ref
        row = {"shape": [rows, c, t], "snakes_per_decode": snakes, "elements": x.numel(),
               "differing_elements": differ, "bit_for_bit": differ == 0,
               "ms": graph_ms(lambda: snake_mod.snake_fast_cuda(x, alpha, dac_mod._SIN2_COEFFS)),
               "plain_ms": graph_ms(lambda: dac_mod.snake_fast(x, alpha), calls=4, replays=4),
               "bound_ms": 1e3 * 2 * x.numel() * x.element_size() / H100_BYTES_PER_S}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit({"phase": "snake_time", **row})
        if differ:
            raise AssertionError(f"the Snake kernel differs from snake_fast in {differ} elements at {row['shape']}")
        for key in totals:
            totals[key] += snakes * row[key]
        rows_out.append(row)
        del x
        torch.cuda.empty_cache()
    audio_s = rows * frames / 86
    summary = {f"{key}_per_audio_s": v / audio_s for key, v in totals.items()}
    summary["share_of_bound"] = totals["bound_ms"] / totals["ms"]
    emit({"phase": "snake_summary", "frames": frames, "rows": rows, "snakes_per_decode": SNAKES_PER_DECODE,
          **summary})
    return {"per_shape": rows_out, **summary}


def norm_agreement(got, want, x, scale, bias, eps: float) -> dict:
    """K9's output against the plain chain's: the share of elements equal,
    the largest distance in bf16 ulps (the bit patterns as integers in
    their order), and the elements farther than one ulp of ``want`` (2^-8
    of its binade) or, for a LayerNorm, than 2^-16 of the terms it sums,
    (|x| + |mean|) · rstd · |scale| + |bias| in float64 (where they nearly
    cancel, the two chains' fp32 statistics move the small result by more
    than one ulp of it)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    ulps = (ordered(got) - ordered(want)).abs()
    err = (got.double() - want.double()).abs()
    allowed = torch.ldexp(torch.ones_like(err), torch.frexp(want.double())[1] - 8)
    if bias is not None:
        x64 = x.double()
        mean, var = x64.mean(-1, keepdim=True), x64.var(-1, unbiased=False, keepdim=True)
        terms = (x64.abs() + mean.abs()) * torch.rsqrt(var + eps) * scale.double().abs() + bias.double().abs()
        allowed = torch.maximum(allowed, 2.0**-16 * terms)
    return {"equal_share": float((ulps == 0).float().mean()), "max_ulps": int(ulps.max()),
            "over_tolerance": int((err > allowed).sum())}


def check_norm(norm_mod) -> dict:
    """Phase 2: K9 against the plain chains (``layer_norm_plain``,
    ``rms_norm_plain``) at each shape the cells send (``NORM_SHAPES``),
    weights in bf16 as in the cells: at least 99.9 % of the elements equal
    and the rest within one bf16 ulp (``norm_agreement``); device times
    (CUDA-graph replay) of K9 and of the plain chain, whose kernels are
    profiled, against x read and y written once at 3.35 TB/s, and of the
    one PyTorch call computing the same function (``F.layer_norm`` / ``F.rms_norm`` on the bf16 tensors, a
    yardstick the port never calls).  The summary weighs the shapes by each
    family's norms a decode step (``NORM_SITES``; T5's per prefill)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows_out = {}
    for site, (kind, rows, width) in NORM_SHAPES.items():
        x = (torch.randn((rows, width), generator=gen, device="cuda") * 3
             + torch.randn((rows, 1), generator=gen, device="cuda")).to(torch.bfloat16)
        scale = (1 + 0.2 * torch.randn(width, generator=gen, device="cuda")).to(torch.bfloat16)
        if kind == "layer":
            bias = (0.1 * torch.randn(width, generator=gen, device="cuda")).to(torch.bfloat16)
            plain = lambda: norm_mod.layer_norm_plain(x, scale, bias, 1e-5)  # noqa: E731
            k9 = lambda: norm_mod.norm_cuda(x, scale, bias, 1e-5)  # noqa: E731
            library = lambda: torch.nn.functional.layer_norm(x, (width,), scale, bias, 1e-5)  # noqa: E731
        else:
            bias = None
            plain = lambda: norm_mod.rms_norm_plain(x, scale, 1e-6)  # noqa: E731
            k9 = lambda: norm_mod.norm_cuda(x, scale, None, 1e-6)  # noqa: E731
            library = lambda: torch.nn.functional.rms_norm(x, (width,), scale, 1e-6)  # noqa: E731
        kernels = device_kernels(plain)
        row = {"site": site, "kind": kind, "shape": [rows, width],
               **norm_agreement(k9(), plain(), x, scale, bias, 1e-5 if kind == "layer" else 1e-6),
               "ms": graph_ms(k9), "plain_ms": graph_ms(plain), "library_ms": graph_ms(library),
               "plain_launches": sum(n for _, _, n in kernels), "plain_kernels": kernels,
               "bound_ms": 1e3 * (2 * x.numel() + width * (2 if bias is not None else 1)) * 2 / H100_BYTES_PER_S}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit({"phase": "norm_time", **row})
        if row["equal_share"] < 0.999 or row["over_tolerance"]:
            raise AssertionError(f"the norm kernel is off the plain chain at {site} {row['shape']}: "
                                 f"{row['equal_share']} equal, {row['over_tolerance']} over its tolerance")
        rows_out[site] = row
    summaries = {}
    for family, sites in NORM_SITES.items():
        summaries[family] = {"norms": sum(sites.values()),
                             "plain_launches": sum(n * rows_out[s]["plain_launches"] for s, n in sites.items()),
                             **{key: sum(n * rows_out[s][key] for s, n in sites.items())
                                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}}
        emit({"phase": "norm_summary", "family": family,
              "per": "prefill" if family == "t5_prefill" else "decode step", **summaries[family]})
    return {"per_shape": list(rows_out.values()), "per_step": summaries}


def dac_conv_bound(c_in: int, c_out: int, taps: int, t: int, residual: bool, rows: int) -> dict:
    """Operations and bytes of one decoder convolution (inputs read once,
    the output written once) and the least time the card could take."""
    flops = 2 * c_out * c_in * taps * t * rows
    nbytes = (c_in * t + c_out * t + c_out * t * residual) * 2 * rows + c_out * c_in * taps * 2
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def device_kernels(fn) -> list:
    """The CUDA kernels of one ``fn()`` under torch.profiler, after a warm-up
    call: [name, device ms, launches], longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            calls[e.name] += 1
    return [[name, ms, calls[name]] for name, ms in by_name.most_common()]


def check_dac_conv(dac_mod, conv_mod, codec_mod, cfg_mod, frames: int = 862, rows: int = 4) -> dict:
    """Phase 2: K7 at each of the DAC decoder's stride-1 convolutions
    (``DAC_CONV_SHAPES``) for a group of ``rows`` rows of ``frames`` frames
    (10 s at 86 Hz), weights of std 1 / sqrt(fan-in): every output within one
    bf16 rounding (2**-8 of its size) of the fp32 result plus the fp32 sums'
    own reordering (2**-16 of the sum of the terms' sizes); then device times
    (CUDA-graph replay) of K7, of the plain version (fp32), of the parent's
    cuDNN chain (``nn.Conv1d`` with its bias, then the residual add) with
    the cuDNN kernels it ran, and of cuDNN channels-last with
    ``cudnn.benchmark`` on (a yardstick, set here only), against the bound
    (``dac_conv_bound``).  The summary weighs the shapes per audio second
    over a decode group, and profiles one decode group of Mini's DAC both
    ways: each device kernel's ms, the transposed convolutions' too."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    keys = ("ms", "plain_ms", "library_ms", "channels_last_ms", "bound_ms")
    rows_out, totals = [], dict.fromkeys(keys, 0.0)
    timed = {}  # the k1 convolutions repeat at each level: timed once
    for c_in, c_out, taps, d, per_frame, res in DAC_CONV_SHAPES:
        t = frames * per_frame
        conv = torch.nn.Conv1d(c_in, c_out, taps, dilation=d, padding=(taps - 1) // 2 * d).cuda()
        with torch.no_grad():
            conv.weight.normal_(0.0, (c_in * taps) ** -0.5, generator=gen)
            conv.bias.normal_(0.0, 0.1, generator=gen)
        conv = conv.to(torch.bfloat16).requires_grad_(False)
        x = torch.randn((rows, c_in, t), generator=gen, device="cuda").to(torch.bfloat16)
        r = torch.randn((rows, c_out, t), generator=gen, device="cuda").to(torch.bfloat16) if res else None
        pad = (taps - 1) // 2 * d
        with torch.no_grad():
            out = conv_mod.dac_conv_cuda(x, conv, r).float()
            ref = F.conv1d(x.float(), conv.weight.float(), conv.bias.float(), padding=pad, dilation=d)
            size = F.conv1d(x.float().abs(), conv.weight.float().abs(), conv.bias.float().abs(), padding=pad,
                            dilation=d)
            if r is not None:
                ref += r.float()
                size += r.float().abs()
            tol = 2.0**-8 * ref.abs() + 2.0**-16 * size
            ratio = float(((out - ref).abs() / tol).max())
            nearest = float((out != ref.to(torch.bfloat16).float()).float().mean())
            edges = [float(((out - ref).abs() / tol)[..., cols].max())
                     for cols in (slice(0, 256), slice((t - 1) // 256 * 256, t))]
        del out, ref, size, tol
        row = {"shape": [rows, c_in, c_out, t], "taps": taps, "dilation": d, "residual": res,
               "max_err_over_tol": ratio, "first_last_tile_err_over_tol": edges, "share_not_nearest": nearest,
               **dac_conv_bound(c_in, c_out, taps, t, res, rows)}
        key = (c_in, c_out, taps, t, res, d if taps > 1 else 0)
        if key not in timed:
            parent = (lambda: r + conv(x)) if res else (lambda: conv(x))
            x4, w4 = (v.unsqueeze(2).contiguous(memory_format=torch.channels_last) for v in (x, conv.weight))
            r4 = None if r is None else r.unsqueeze(2).contiguous(memory_format=torch.channels_last)

            def channels_last():
                y = F.conv2d(x4, w4, conv.bias, padding=(0, pad), dilation=(1, d))
                return y if r4 is None else y + r4

            saved = torch.backends.cudnn.benchmark
            torch.backends.cudnn.benchmark = True
            try:
                with torch.no_grad():
                    channels_last_ms = graph_ms(channels_last)
            finally:
                torch.backends.cudnn.benchmark = saved
            with torch.no_grad():
                timed[key] = {
                    "ms": graph_ms(lambda: conv_mod.dac_conv_cuda(x, conv, r)),
                    "plain_ms": graph_ms(lambda: conv_mod.dac_conv(x, conv.weight, conv.bias, d, r), calls=2,
                                         replays=3),
                    "library_ms": graph_ms(parent),
                    "channels_last_ms": channels_last_ms,
                    "library_kernels": device_kernels(parent)}
            del x4, w4, r4
        row.update(timed[key])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["faster_than_parent"] = row["ms"] < row["library_ms"]
        emit({"phase": "dac_conv_time", **row})
        if not ratio <= 1.0:
            raise AssertionError(f"K7 is off by {ratio} of its tolerance at {row['shape']}, taps {taps}, dilation {d}")
        for k in keys:
            totals[k] += row[k]
        rows_out.append(row)
        del x, r, conv
        torch.cuda.empty_cache()
    audio_s = rows * frames / 86
    summary = {f"{key}_per_audio_s": v / audio_s for key, v in totals.items()}
    summary["share_of_bound"] = totals["bound_ms"] / totals["ms"]
    summary["slower_than_parent"] = [r["shape"] + [r["taps"], r["dilation"]] for r in rows_out
                                     if not r["faster_than_parent"]]

    # one decode group of Mini's DAC, K7 and the parent's chain in its place: each device kernel's ms
    dac_cfg = cfg_mod.DACConfig()
    codec = dac_mod.DAC(dac_cfg)
    codec.reset_parameters(torch.Generator().manual_seed(SEED))
    codec = codec.to("cuda", torch.bfloat16).requires_grad_(False)
    codes = torch.randint(0, dac_cfg.codebook_size, (rows, dac_cfg.num_codebooks, frames), device="cuda",
                          generator=gen)
    profiles = {}
    with torch.no_grad():
        profiles["k7"] = device_kernels(lambda: codec_mod.decode(codec, codes))
        route = dac_mod.dac_conv_cuda
        dac_mod.dac_conv_cuda = lambda x, module, residual=None: (module(x) if residual is None
                                                                    else residual + module(x))
        try:
            profiles["parent"] = device_kernels(lambda: codec_mod.decode(codec, codes))
        finally:
            dac_mod.dac_conv_cuda = route
    summary["decode_group_ms"] = {name: sum(ms for _, ms, _ in kernels) for name, kernels in profiles.items()}
    summary["decode_group_kernels"] = {name: kernels[:16] for name, kernels in profiles.items()}
    del codec, codes
    torch.cuda.empty_cache()
    emit({"phase": "dac_conv_summary", "frames": frames, "rows": rows, "convs_per_decode": DAC_CONVS_PER_DECODE,
          **summary})
    return {"per_shape": rows_out, **summary}


def run_main_path(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod, card: str):
    """Phase 4: tts at full Mini width.  Returns the kernel launches of the
    counted calls, the model and its pipeline (the later inference phases
    run them)."""
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
    text_norms, step_norms = 2 * cfg.text_encoder.num_layers + 1, 3 * layers + 1  # T5's RMSNorms; LayerNorms

    calls = []
    reset_counts()
    groups = []  # the DAC's decode calls: one per group of rows (models/codec.py::decode)
    decode_group = model.audio_encoder.decode
    model.audio_encoder.decode = lambda codes: groups.append(codes.shape[0]) or decode_group(codes)
    for i, (n_words, p) in enumerate(((10, pipe), (50, pipe), (200, pipe16))):
        prompts = _prompts(n_words)
        before, steps_before = counts(), counter("decode.replays") + counter("decode.captures")
        groups_before = len(groups)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr, wavs = p.tts(DESCRIPTIONS, prompts, seed=SEED + i, max_seconds=max_seconds)
        wall = time.perf_counter() - t0
        after = counts()
        launched = after["flash_attention_fwd"] - before["flash_attention_fwd"]
        snake_launched, decode_groups = after["snake"] - before["snake"], len(groups) - groups_before
        conv_launched = after["dac_conv"] - before["dac_conv"]
        norm_launched = after["norm"] - before["norm"]
        # a captured step's warm-up launches K5 as a replay does
        decode_steps = counter("decode.replays") + counter("decode.captures") - steps_before
        decode_launched = after["decode_attention"] - before["decode_attention"]
        want = torch.int16 if p.pcm16 else torch.float32
        for w in wavs:
            if w.ndim != 1 or w.size == 0 or w.size % hop or str(w.dtype) != str(want).removeprefix("torch."):
                raise AssertionError(f"bad waveform: shape {w.shape}, dtype {w.dtype}, want 1-D {want}")
            if not torch.isfinite(torch.from_numpy(w.astype("float32"))).all():
                raise AssertionError("waveform holds non-finite values")
        if launched != layers:
            raise AssertionError(f"tts call launched flash_attention_fwd {launched} times, want {layers}")
        if decode_launched != 2 * layers * decode_steps or not decode_steps:
            raise AssertionError(f"tts call launched decode_attention {decode_launched} times over "
                                 f"{decode_steps} steps, want {2 * layers} a step")
        if snake_launched != SNAKES_PER_DECODE * decode_groups or not decode_groups:
            raise AssertionError(f"tts call launched snake {snake_launched} times over {decode_groups} DAC decode "
                                 f"groups, want {SNAKES_PER_DECODE} a group")
        if conv_launched != DAC_CONVS_PER_DECODE * decode_groups:
            raise AssertionError(f"tts call launched dac_conv {conv_launched} times over {decode_groups} DAC decode "
                                 f"groups, want {DAC_CONVS_PER_DECODE} a group")
        if norm_launched != step_norms * decode_steps + text_norms + step_norms:
            raise AssertionError(f"tts call launched norm {norm_launched} times over {decode_steps} steps, want "
                                 f"{step_norms} a step and {text_norms + step_norms} for the prefill")
        prompt_tokens = max(len(tok.encode(x)) for x in prompts)
        calls.append({"requests": len(wavs), "prompt_tokens": prompt_tokens,
                      "prefill_T": pipeline_mod._bucket(prompt_tokens) + 1, "pcm16": p.pcm16,
                      "samples": [int(w.size) for w in wavs], "sampling_rate": sr,
                      "wall_s": wall, "audio_s_per_wall_s": sum(w.size for w in wavs) / sr / wall,
                      "k1_launches": launched, "decode_steps": decode_steps, "k5_launches": decode_launched,
                      "dac_decode_groups": decode_groups, "k6_launches": snake_launched,
                      "k7_launches": conv_launched, "k9_launches": norm_launched})
        emit({"phase": "tts", **calls[-1]})
    del model.audio_encoder.decode  # the class's method again
    launches = counts()
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
    return launches, model, pipe


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


@contextlib.contextmanager
def train_route(step_mod, captured: bool):
    """The train and eval steps on the captured route (the default on one
    card) or, ``captured`` False, on the eager one."""
    from parler_tts_tpu_torch.core import graphs

    real = graphs.capturable
    if not captured:
        graphs.capturable = lambda device, groups=(): False
    try:
        yield
    finally:
        graphs.capturable = real


def train_run(cfg, base, fa, step_mod, batch, n_steps: int, captured: bool, profiled: bool = True) -> dict:
    """On one route, a copy of ``base``: one eval step twice (the captured
    route captures, then replays), then ``n_steps`` train steps on
    ``batch`` (the Mini recipe, dropout on): losses, gradient norms, step
    ms, kernel launches per step, the trained parameters, capture seconds
    and bytes, peak memory; then, when ``profiled``, two steps under
    ``launch_profile`` and one under ``profile_call``."""
    model = copy.deepcopy(base)
    state = step_mod.create_state(model, learning_rate=9.5e-4, warmup_steps=1, b1=0.9, b2=0.99,
                                  weight_decay=0.01, max_grad_norm=1.0)
    train_step = step_mod.make_train_step(cfg, dtype=torch.bfloat16, dropout_seed=SEED)
    eval_step = step_mod.make_eval_step(cfg, dtype=torch.bfloat16)
    with train_route(step_mod, captured):
        eval_losses = [eval_step(model, batch)["loss"].item() for _ in range(2)]
        eval_graphs = step_mod._eval_graphs(model)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        steps = []
        for _ in range(n_steps):
            timings = {}
            t0 = time.perf_counter()
            metrics = train_step(state, batch, timings)
            loss = metrics["loss"].item()
            step_ms = 1e3 * (time.perf_counter() - t0)
            steps.append({"step": metrics["step"], "loss": loss, "grad_norm": metrics["grad_norm"].item(),
                          "step_ms": step_ms, **timings})
        after = counts()
        run = {"route": "captured" if captured else "eager", "steps": steps,
               "launches_per_step": {k: (after[k] - before[k]) / n_steps for k in after},
               "params": [p.detach().clone() for p in state.optimizer.params],
               "captures": state.graphs.captures, "replays": state.graphs.replays,
               "capture_s": state.graphs.capture_seconds, "graph_bytes": state.graphs.nbytes,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "eval_losses": eval_losses,
               "eval_captures": eval_graphs.captures, "eval_replays": eval_graphs.replays}
        if profiled:
            run["launch_profile"] = launch_profile(lambda: [train_step(state, batch) for _ in range(2)], 2)
            run["profile"] = profile_call(lambda: train_step(state, batch))
    del state, model
    return run


def train_gap(ref: dict, run: dict) -> dict:
    """``run``'s largest differences from ``ref``: loss and gradient norm
    relative over the steps, parameters absolute."""
    def rel(key):
        return max(abs(a[key] - b[key]) / abs(a[key]) for a, b in zip(ref["steps"], run["steps"]))

    params = max(float((a - b).abs().max()) for a, b in zip(ref["params"], run["params"]))
    return {"loss": rel("loss"), "grad_norm": rel("grad_norm"), "params": params}


def run_train_path(cfg_mod, parler, fa, step_mod, data_mod, card: str) -> dict:
    """Phase 7: the training path at full Mini width, each shape on both
    routes from the same initial state: twice eagerly (their spread) and
    captured (``train_run``).  The captured run's losses, gradient norms
    and parameters must equal the eager run's bit for bit where two eager
    runs do, else stay within ``TRAIN_GRAPH_SPREAD`` times their spread;
    K1 and the shape's backward kernels must launch once per layer per
    step on each route, counted through replays; the captured route
    captures once and replays after.  Returns the kernel launches of the
    whole phase."""
    cfg = cfg_mod.mini_600m_config()
    layers = cfg.decoder.num_hidden_layers
    text_norms = 2 * cfg.text_encoder.num_layers + 1  # T5 runs without autograd: its RMSNorms take K9
    base = parler.init(SEED, cfg, device="cuda")  # fp32 parameters
    n_params = sum(p.numel() for p in step_mod.trainable_parameters(base))
    reset_counts()
    out = {"config": "mini_600m_config, fp32 parameters, bf16 compute, random weights (seed 0), dropout 0.1",
           "card": card, "trainable_params": n_params}
    for seconds, prompt_lens, desc_lens, n_steps, route in (
            (10, (32, 20, 27), (48, 31, 40), 5, "flash_attention_dqkv"),
            (30, (26,), (48,), 3, "flash_attention_dq")):
        batch = mini_batch(cfg, data_mod, seconds=seconds, prompt_lens=prompt_lens, desc_lens=desc_lens,
                           seed=SEED + seconds)
        b, t_lab = batch["labels"].shape[0], batch["labels"].shape[2]
        runs = [train_run(cfg, base, fa, step_mod, batch, n_steps, captured, profiled)
                for captured, profiled in ((False, True), (False, False), (True, True))]
        eager, _, captured = runs
        spread, gap = train_gap(eager, runs[1]), train_gap(eager, captured)
        for run in runs:
            del run["params"]
        tol = {k: TRAIN_GRAPH_SPREAD * v for k, v in spread.items()}
        want = {"flash_attention_fwd": layers, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                "flash_attention_dqkv": 0, "decode_attention": 0, "snake": 0,
                "dac_conv": 0, "ssm_step": 0, "norm": text_norms}
        if route == "flash_attention_dqkv":
            want["flash_attention_dqkv"] = layers
        else:
            want["flash_attention_dq"] = want["flash_attention_dkv"] = layers
        flops = train_step_model_flops(cfg, b, t_lab, 48, 32)
        summary = {"seconds": seconds, "batch": b, "label_frames": t_lab, "fused_T": 32 + t_lab,
                   "model_tflop_per_step": flops / 1e12, "spread_of_two_eager_runs": spread,
                   "captured_vs_eager": gap, "tol": tol,
                   "bit_for_bit": all(v == 0 for v in gap.values())}
        for run in (eager, captured):
            steady = run["steps"][1:]
            step_s = sorted(s["step_ms"] for s in steady)[len(steady) // 2] / 1e3
            run.update(median_step_ms=1e3 * step_s, audio_s_per_wall_s=b * seconds / step_s,
                       codec_tokens_per_wall_s=b * t_lab * cfg.decoder.num_codebooks / step_s,
                       mfu_vs_989_tflops=flops / step_s / H100_BF16_FLOPS)
            summary[run["route"]] = run
            emit({"phase": "train", "seconds": seconds, "batch": b, "card": card,
                  **{k: v for k, v in run.items() if k != "profile"}})
            emit({"phase": "train_profile", "seconds": seconds, "batch": b, "route": run["route"], **run["profile"]})
        emit({"phase": "train_routes", **{k: v for k, v in summary.items() if k not in ("eager", "captured")}})
        losses = [s["loss"] for run in runs for s in run["steps"]] + [x for run in runs for x in run["eval_losses"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        if any(run["launches_per_step"] != want for run in runs):
            raise AssertionError(f"train steps at {seconds} s launched {[r['launches_per_step'] for r in runs]} "
                                 f"per step, want {want}")
        if any(gap[k] > tol[k] for k in gap):
            raise AssertionError(f"the captured train step at {seconds} s is off the eager one: {gap}, tol {tol}")
        if (captured["captures"], captured["replays"]) != (1, n_steps - 1) or eager["captures"]:
            raise AssertionError(f"the captured route at {seconds} s did not capture once and replay")
        if captured["eval_losses"] != eager["eval_losses"] or (captured["eval_captures"],
                                                               captured["eval_replays"]) != (1, 1):
            raise AssertionError(f"the captured eval step is not the eager one: {captured['eval_losses']} "
                                 f"against {eager['eval_losses']}")
        if seconds == 10 and not eager["steps"][-1]["loss"] < eager["steps"][0]["loss"]:
            raise AssertionError(f"the loss did not fall over {n_steps} steps: {eager['steps']}")
        out[f"{seconds}s"] = summary
    del base
    out["launches"] = counts()
    emit({"phase": "train_path", **{k: v for k, v in out.items() if not k.endswith("0s")}})
    return out


def run_codec_encode(codec_cfg, label: str, codec_mod, data_mod, card: str) -> None:
    """Phases 8 and 5: a codec's encode side (random weights
    from seed 0, fp32): 8 seeded waveforms of 2-10 s through
    ``tokenize_audio_batches(batch_size=4)``, once to warm up and once timed;
    each sample must get ``ceil(len / hop)`` frames of every codebook the
    composite models.  Then one 1 s clip's codes on the card against the
    CPU's: a code may differ only at a near-tie, where the CPU's score of the
    card's code is within ``CODE_TIE_TOL`` of its best (``code_gaps``).  The
    same clip through the conv stack outside the codec's fp32 pin, under the
    run's default flags (cuDNN's TF32 on), is counted the same way and
    reported, not gated."""
    from parler_tts_tpu_torch.models.dac import pad_audio

    with torch.device("cuda"):
        codec = codec_mod.build(codec_cfg)
    codec.reset_parameters(torch.Generator(device="cuda").manual_seed(SEED))
    sr, hop, k = codec_cfg.sampling_rate, codec_cfg.hop_length, codec_cfg.num_codebooks
    # the conv stack's input: the DAC pads to a multiple of its hop, EnCodec's convs pad themselves
    prep = (lambda a: a[:, None]) if codec_mod.is_encodec(codec_cfg) else (lambda a: pad_audio(a, hop)[:, None])
    rng = np.random.default_rng(SEED)
    waves = []
    for n in rng.integers(2 * sr, 10 * sr + 1, 8):
        t = np.arange(n) / sr
        waves.append((0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t)
                      + 0.05 * rng.standard_normal(n)).astype(np.float32))
    data_mod.tokenize_audio_batches(codec, codec_cfg, waves, batch_size=4)  # warm-up (cuDNN's choices)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes = data_mod.tokenize_audio_batches(codec, codec_cfg, waves, batch_size=4)
    wall = time.perf_counter() - t0
    shapes_ok = all(c.shape == (k, -(-len(w) // hop)) and c.dtype == np.int16 for c, w in zip(codes, waves))
    clip = torch.from_numpy(waves[0][:sr])[None]
    cpu_codec = copy.deepcopy(codec).cpu()
    with torch.no_grad():
        card_codes = codec_mod.encode(codec, clip.cuda()).cpu()
        cpu_codes = codec_mod.encode(cpu_codec, clip)
        z = cpu_codec.encoder(prep(clip)).transpose(1, 2)
        gaps = cpu_codec.quantizer.code_gaps(z, card_codes)
        # the conv stack as the codec ran it before it pinned fp32: under this run's flags, the defaults
        unpinned = codec.quantizer.encode(codec.encoder(prep(clip.cuda())).transpose(1, 2), k).cpu()
        unpinned_gaps = cpu_codec.quantizer.code_gaps(z, unpinned)
    differ = card_codes != cpu_codes
    worst_gap = gaps.max().item()
    ok = shapes_ok and worst_gap <= CODE_TIE_TOL
    audio_s = sum(len(w) for w in waves) / sr
    emit({"phase": "codec_encode", "codec": label, "config": f"{label} fp32, random weights (seed 0)", "card": card,
          "waveforms": len(waves), "audio_s": audio_s, "batch_size": 4, "ms": 1e3 * wall,
          "audio_s_per_wall_s": audio_s / wall, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "frames": [int(c.shape[1]) for c in codes], "shapes_ok": shapes_ok,
          "clip_codes": list(card_codes.shape), "codes_differing_from_cpu": int(differ.sum()),
          "frames_with_a_tie": int(differ.any(dim=1).sum()), "max_score_gap": worst_gap,
          "tie_tol": CODE_TIE_TOL, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "unpinned_codes_differing_from_cpu": int((unpinned != cpu_codes).sum()),
          "unpinned_frames_differing": int((unpinned != cpu_codes).any(dim=1).sum()),
          "unpinned_max_score_gap": unpinned_gaps.max().item(), "ok": ok})
    if not ok:
        raise AssertionError(f"the {label} encode side gives wrong shapes or codes that are not the CPU's")


REPLAYED = " (replayed prefill, run eagerly)"  # KernelSpy's place suffix for a replay's eager prefill


class KernelSpy:
    """While active, the first call of each wrapped kernel wrapper (by
    name, in ``fa``) at each (place, input shapes, dtype) keeps its inputs
    and outputs; the calls and their launch counts are the wrappers' own.
    The caller sets ``place`` to name where the calls come from.  ``hold``
    then checks every kept call against its plain version (no launch).
    A call made while a stream is captured keeps nothing (its tensors are
    placeholders, and a clone would go into the graph).  A prefill replayed
    from its graph runs K1 out of reach: the first replay of each model and
    input shape is noted, and ``hold`` runs an eager ``prefill`` on its
    inputs, whose K1 calls are kept under the place's name + " (replayed
    prefill, run eagerly)" (the replay and the eager prefill agree bit for
    bit: the ``decode_graph`` phase's prefill cases)."""

    def __init__(self, fa, names=("flash_attention_fwd",), place: str = ""):
        from parler_tts_tpu_torch.generation import generate as generate_mod

        self.fa, self.place, self.captured, self.replayed = fa, place, {}, {}
        self.wrappers = {name: getattr(fa, name) for name in names}
        self.generate_mod, self.real_prefill = generate_mod, generate_mod._captured_prefill

    def __enter__(self) -> "KernelSpy":
        for name, wrapper in self.wrappers.items():
            setattr(self.fa, name, self._spy(name, wrapper))
        self.generate_mod._captured_prefill = self._prefill
        return self

    def __exit__(self, *exc) -> None:
        for name, wrapper in self.wrappers.items():
            setattr(self.fa, name, wrapper)
        self.generate_mod._captured_prefill = self.real_prefill

    def _spy(self, name, wrapper):
        def call(*args, **kw):
            result = wrapper(*args, **kw)
            if torch.cuda.is_current_stream_capturing():
                return result
            key = (self.place, name, tuple(tuple(a.shape) for a in args[:3]), args[0].dtype)
            if key not in self.captured:
                self.captured[key] = ([a.detach().clone() for a in args], kw, [r.detach().clone() for r in result])
            return result
        return call

    def _prefill(self, model, gen, captured, plan, *, max_length, **inputs):
        shapes = self.generate_mod._input_shapes(inputs)
        key = (id(model), gen, max_length, shapes)
        if shapes in captured.prefills and key not in self.replayed:
            self.replayed[key] = (self.place, model, gen, max_length,
                                  {k: None if v is None else v.clone() for k, v in inputs.items()})
        return self.real_prefill(model, gen, captured, plan, max_length=max_length, **inputs)

    def hold(self, kind: str) -> dict[str, float]:
        """Every kept call against its plain version (``check_k1``,
        ``check_bwd``), after the eager prefills of the noted replays; the
        largest error of each kernel."""
        place = self.place
        with self:
            for where, model, gen, max_length, inputs in self.replayed.values():
                self.place = where + REPLAYED
                self.generate_mod.prefill(model, gen, max_length=max_length, **inputs)
        self.place, self.replayed = place, {}
        errs = {name: 0.0 for name in self.wrappers}
        for (place, name, shapes, dtype), (args, kw, result) in self.captured.items():
            meta = {"kind": f"{kind} {place}".strip(), "shape": list(shapes[0]), "tk": shapes[1][1], **kw,
                    "kv_starts": sorted(set(args[-2].tolist())), "kv_ends": sorted(set(args[-1].tolist()))}
            if name == "flash_attention_fwd":
                err = check_k1(self.fa, *args, *result, kw, meta)
            else:
                err = check_bwd(name, result, self.fa.flash_dqkv_plain(*args, **kw), dtype, meta)
            errs[name] = max(errs[name], err)
        return errs


def run_train_cli(cfg_mod, run_mod, ck, step_mod, fa, out_dir: str, card: str) -> dict:
    """Phase 9: ``run_training.main`` at full Mini width (the default model,
    random weights from the default seed, bf16 compute) on ``synthetic://48``:
    4 optimizer steps of batch 3 with a checkpoint every 2 (one kept), an
    eval at step 4 (loss pass over 3 samples, generation of up to 100
    positions), then a second ``main`` to step 6 that must resume from
    ``checkpoint-4-epoch-0`` with its trainable parameters bit for bit and
    log steps 5 and 6 only.  Each run's steps take the captured route (the
    first captures, the others replay).  Each train step must launch K1
    and K4 once per layer, counted through replays.  The first call of K1 and of K4 at each shape, in the train steps
    and in the eval (loss batches, generation prefill), keeps its inputs and
    outputs, which are then held against the plain versions (no launch).
    Returns the launches of both runs and the largest error of each kernel
    so held."""
    argv = ["--train_dataset_name", "synthetic://48", "--per_device_train_batch_size", "3", "--save_steps", "2",
            "--save_total_limit", "1", "--logging_steps", "1", "--do_eval", "--eval_steps", "4",
            "--max_eval_samples", "3", "--generation_max_length", "100", "--warmup_steps", "1",
            "--output_dir", out_dir]
    layers = cfg_mod.mini_600m_config().decoder.num_hidden_layers
    text_norms = 2 * cfg_mod.mini_600m_config().text_encoder.num_layers + 1  # T5's RMSNorms, on K9
    per_step, routes, restored, loaded = [], [], [], {}
    make_train_step, load_train_state = step_mod.make_train_step, ck.load_train_state
    spy = KernelSpy(fa, ("flash_attention_fwd", "flash_attention_dqkv"), place="eval")

    def load_spy(path):
        payload, meta = load_train_state(path)
        loaded.update(path=path, params=payload["params"])
        return payload, meta

    def make_spy(*args, **kwargs):
        inner = make_train_step(*args, **kwargs)

        def step(state, batch, timings=None):
            if "params" in loaded:  # the first step after the resume
                params = loaded.pop("params")
                own = ck.trainable_state_dict(state.model)
                restored.append({"path": os.path.basename(loaded["path"]), "step": state.step,
                                 "tensors": len(params), "bit_exact": set(own) == set(params) and all(
                                     torch.equal(own[k].cpu(), params[k]) for k in params)})
            before, graphs = counts(), (state.graphs.captures, state.graphs.replays)
            spy.place = "train step"
            try:
                metrics = inner(state, batch, timings)
            finally:
                spy.place = "eval"
            after = counts()
            per_step.append({k: after[k] - before[k] for k in after})
            routes.append("captured" if state.graphs.captures > graphs[0] else
                          "replayed" if state.graphs.replays > graphs[1] else "eager")
            return metrics
        return step

    step_mod.make_train_step, ck.load_train_state = make_spy, load_spy
    reset_counts()
    try:
        with spy:
            first = run_mod.main(argv + ["--max_steps", "4"], device="cuda")
            ckpts_first = [os.path.basename(p) for p in ck.sorted_checkpoints(out_dir)]
            launches_first = counts()
            second = run_mod.main(argv + ["--max_steps", "6"], device="cuda")
    finally:
        step_mod.make_train_step, ck.load_train_state = make_train_step, load_train_state
    launches = counts()
    errs = spy.hold("main path CLI")
    held = sorted({(place, name, shapes[0]) for place, name, shapes, _ in spy.captured})
    records = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    train = [r for r in records if "train/loss" in r]
    evals = [r for r in records if "eval/loss" in r]
    losses = [r["train/loss"] for r in train]
    want_step = {"flash_attention_fwd": layers, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                 "flash_attention_dqkv": layers, "decode_attention": 0, "snake": 0,
                 "dac_conv": 0, "ssm_step": 0, "norm": text_norms}
    # K1 also runs in each eval loss batch and each eval generation prefill (2 + 2 of them)
    want_first = {"flash_attention_fwd": layers * (4 + 2 + 2), "flash_attention_dqkv": layers * 4}
    ckpts = [os.path.basename(p) for p in ck.sorted_checkpoints(out_dir)]
    t1, t2 = first["timings"], second["timings"]
    summary = {
        "config": "mini_600m_config, fp32 parameters, bf16 compute, random weights (seed 42)", "card": card,
        "steps_logged": [r["step"] for r in train], "losses": losses,
        "grad_norms": [r["train/grad_norm"] for r in train],
        "eval": {k: v for k, v in evals[0].items() if k.startswith("eval/")} if evals else None,
        "step_ms": t1["step_ms"] + t2["step_ms"], "save": t1["save"] + t2["save"], "load": t2["load"],
        "eval_ms": t1["eval"], "artifact": [t1["artifact"], t2["artifact"]],
        "checkpoints_after_first": ckpts_first, "checkpoints_after_second": ckpts, "restored": restored,
        "launches_per_step": per_step, "step_routes": routes, "launches_first_run": launches_first,
        "launches": launches,
        "held_against_plain": held, "max_abs_err": errs, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit({"phase": "train_cli", **summary})
    ok = (all(math.isfinite(x) for x in losses) and summary["steps_logged"] == [1, 2, 3, 4, 5, 6]
          and all(s == want_step for s in per_step) and len(per_step) == 6
          and routes == ["captured", "replayed", "replayed", "replayed", "captured", "replayed"]
          and all(launches_first[k] == v for k, v in want_first.items())
          and evals and "eval/gen_code_len_mean" in evals[0] and math.isfinite(evals[0]["eval/loss"])
          and ckpts_first == ["checkpoint-4-epoch-0"] and ckpts == ["checkpoint-6-epoch-0"]
          and restored == [{"path": "checkpoint-4-epoch-0", "step": 4, "tensors": restored[0]["tensors"],
                            "bit_exact": True}]
          and first["steps"] == 4 and second["steps"] == 6
          # K1 and K4 of the train steps, K1 of the eval loss batches and of the generation prefill
          and {(place.removesuffix(REPLAYED), name) for place, name, _ in held} == {
              ("train step", "flash_attention_fwd"), ("train step", "flash_attention_dqkv"),
              ("eval", "flash_attention_fwd")}
          and len({shape for place, _, shape in held if place == "eval"}) >= 2)
    if not ok:
        raise AssertionError("the training CLI's run on the card is not as it should be (see the train_cli line)")
    return launches, errs


def run_from_pretrained(cfg_mod, pipeline_mod, tokenizer_mod, ck, out_dir: str, card: str) -> None:
    """Phase 10: ``ParlerTTSPipeline.from_pretrained`` over the CLI's
    ``final/`` (bf16, the toy tokenizer), one ``tts`` call of 4 requests at
    ``max_seconds=2.5`` (special-id LM-head columns zeroed and top-k 50, as
    in phase 4, so that the six-step model decodes full length): finite
    audio.  The
    artifact's fp32 tensors must equal ``checkpoint-6``'s trainable tensors
    bit for bit."""
    final = os.path.join(out_dir, "final")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = tokenizer_mod.ToyTokenizer(vocab_size=cfg_mod.ParlerTTSConfig.load(os.path.join(final, "config.json")).vocab_size)
    pipe = pipeline_mod.ParlerTTSPipeline.from_pretrained(final, tokenizer=tok, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    zero_special_heads(pipe.model)
    pipe.gen = dataclasses.replace(pipe.gen, top_k=50)  # phase 4's sampler
    t0 = time.perf_counter()
    sr, wavs = pipe.tts(DESCRIPTIONS, _prompts(10), seed=SEED, max_seconds=2.5)
    wall = time.perf_counter() - t0
    finite = all(w.size > 0 and bool(np.isfinite(w).all()) for w in wavs)
    weights = torch.load(os.path.join(final, ck.WEIGHTS_FILE), map_location="cpu", weights_only=True)
    saved = torch.load(os.path.join(out_dir, "checkpoint-6-epoch-0", ck.STATE_FILE), map_location="cpu",
                       weights_only=True)["params"]
    equal = all(weights[k].dtype == torch.float32 and torch.equal(weights[k], v) for k, v in saved.items())
    emit({"phase": "from_pretrained", "card": card, "load_ms": load_ms, "artifact_gb": sum(
        os.path.getsize(os.path.join(final, f)) for f in os.listdir(final)) / 1e9, "tts_wall_s": wall,
        "samples": [int(w.size) for w in wavs], "sampling_rate": sr, "finite": finite,
        "trainable_tensors": len(saved), "artifact_tensors": len(weights), "equal_to_checkpoint_6": equal,
        "ok": finite and equal})
    if not (finite and equal):
        raise AssertionError("from_pretrained's model does not speak, or the artifact is not checkpoint-6's")


TOKENIZER_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_tokenizers")
TEXT_ROWS = 12  # rows prepared in the text phase, two of which the filters drop
TEXT_FILTERS = {"min_duration_in_seconds": 0.5, "max_duration_in_seconds": 4.5, "max_text_length": 95}
WORD_SLOTS = (("A", "The", "One"), ("female", "male", "young", "older", "calm", "lively"),
              ("speaker", "narrator", "voice actor", "presenter"),
              ("with a low-pitched", "with a high-pitched", "with a deep", "with a bright", "with a hoarse"),
              ("voice", "tone"), ("speaks", "reads", "delivers the words"),
              ("very fast", "slowly", "at a moderate pace", "expressively", "in a monotone"),
              ("in a quiet room", "in a large hall", "outdoors", "close to the microphone"),
              ("with clear audio.", "with some background noise.", "with very clear audio quality.",
               "and the recording is slightly distant."))


def synthetic_descriptions(n: int, seed: int) -> list[str]:
    """``n`` descriptions in the style of Parler-TTS's, drawn from ``WORD_SLOTS``."""
    rng = np.random.default_rng(seed)
    return [" ".join(slot[int(rng.integers(len(slot)))] for slot in WORD_SLOTS) for _ in range(n)]


def reader_rates(tokenizer_mod, t5_dir: str, texts: list[str]) -> dict:
    """The reader's ids per second on this host: a 4-request padded batch
    (the first call of a fresh reader, then 200 calls), and 1,000
    descriptions in one call of another fresh reader."""
    out = {}
    tok = tokenizer_mod.Tokenizer.from_pretrained(t5_dir)
    t0 = time.perf_counter()
    enc = tok(texts[:4], padding=True, return_tensors="np")
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(200):
        enc = tok(texts[:4], padding=True, return_tensors="np")
    warm = (time.perf_counter() - t0) / 200
    n_ids = int(enc.attention_mask.sum())
    out["batch4"] = {"ids": n_ids, "first_call_ms": 1e3 * cold, "ids_per_s_first_call": n_ids / cold,
                     "ms_per_call": 1e3 * warm, "ids_per_s": n_ids / warm}
    descriptions = synthetic_descriptions(1000, SEED)
    tok = tokenizer_mod.Tokenizer.from_pretrained(t5_dir)
    t0 = time.perf_counter()
    ids = tok(descriptions).input_ids
    wall = time.perf_counter() - t0
    n_ids = sum(len(x) for x in ids)
    out["descriptions_1000"] = {"ids": n_ids, "ms": 1e3 * wall, "ids_per_s": n_ids / wall}
    return out


def text_rows(expected: dict, sr: int) -> tuple[list[dict], set[int]]:
    """``TEXT_ROWS`` in-memory rows: 1-4 s of seeded noise each, the
    fixture's descriptions and prompts; row 3 lasts 5 s (over
    ``max_duration_in_seconds``) and row 7's description is over
    ``max_text_length``.  Returns the rows and the indices the filters drop."""
    rng = np.random.default_rng(SEED)
    descs, prompts = expected["smoke_descriptions"], expected["smoke_prompts"]
    rows = []
    for i in range(TEXT_ROWS):
        seconds = 5.0 if i == 3 else float(rng.uniform(1.0, 4.0))
        desc = descs[i % len(descs)]
        if i == 7:
            desc = desc + " " + descs[(i + 1) % len(descs)]
        rows.append({"audio": {"array": (0.1 * rng.standard_normal(int(seconds * sr))).astype(np.float32),
                               "sampling_rate": sr},
                     "description": desc, "text": prompts[(5 * i) % len(prompts)]})
    if len(rows[7]["description"]) <= TEXT_FILTERS["max_text_length"]:
        raise AssertionError("row 7's description should be over max_text_length")
    return rows, {3, 7}


def run_text(cfg_mod, run_mod, fa, pipeline_mod, generate_mod, codec_mod, data_mod, tokenizer_mod,
             out_dir: str, card: str) -> tuple[dict, dict]:
    """Phase 11, text in.  The tokenizer fixtures read by the port's reader
    give the ids recorded beside them (no ``tokenizers`` here), and the
    reader's rates.  ``TEXT_ROWS`` in-memory rows go through the CLI's row
    loop (``prepare_rows``) at Mini's DAC (44.1 kHz, random weights from
    seed 0, fp32) with the codes cache on: the 5 s row and the long
    description are dropped before the codec; a second preparation reads
    every code back and encodes nothing; the samples go to the fingerprinted
    ``save_to_disk`` file.  ``run_training.main`` then takes 2 steps at full
    Mini width from that file (K1 and K4 once per layer per step, their
    first calls held against the plain versions) with the T5-shaped
    fixture as prompt tokenizer, which its ``final/`` carries.
    ``ParlerTTSPipeline.from_pretrained(final)`` with no tokenizer argument
    then speaks 2 requests of real text (1 s, special-id heads zeroed, top-k
    50): its ids are the recorded ones, its tokens those of ``generate`` fed
    the recorded ids with the same seed, its audio finite.  Returns the
    phase's kernel launches and the largest error of each kernel held."""
    t_phase = time.perf_counter()
    expected = json.load(open(os.path.join(TOKENIZER_FIXTURES, "expected_ids.json"), encoding="utf-8"))
    t5_dir = os.path.join(TOKENIZER_FIXTURES, "t5_unigram")
    fixtures_equal = {}
    for name, want in expected["ids"].items():
        tok = tokenizer_mod.Tokenizer.from_pretrained(os.path.join(TOKENIZER_FIXTURES, name))
        fixtures_equal[name] = all(tok(text).input_ids == ids for text, ids in want.items())
    if not all(fixtures_equal.values()):
        raise AssertionError(f"the reader's ids differ from the recorded ones: {fixtures_equal}")
    rates = reader_rates(tokenizer_mod, t5_dir, expected["smoke_descriptions"])
    t5_ids = expected["ids"]["t5_unigram"]

    # ----- preparation -----
    cfg = cfg_mod.mini_600m_config()
    acfg = cfg.audio_encoder
    rows_dir = os.path.join(out_dir, "rows")  # the dataset name; it exists, so a cache miss reads no hub
    os.makedirs(rows_dir)
    argv = ["--train_dataset_name", rows_dir, "--save_to_disk", os.path.join(out_dir, "prepared"),
            "--temporary_save_to_disk", os.path.join(out_dir, "codes"), "--prompt_tokenizer_name", t5_dir,
            "--description_tokenizer_name", t5_dir, "--audio_encoder_batch_size", "4",
            *[x for k, v in TEXT_FILTERS.items() for x in (f"--{k}", str(v))],
            "--per_device_train_batch_size", "3", "--max_steps", "2", "--logging_steps", "1", "--save_steps", "0",
            "--warmup_steps", "1", "--output_dir", os.path.join(out_dir, "run")]
    model_args, data_args, _ = run_mod.parse_args(argv)
    rows, dropped = text_rows(expected, acfg.sampling_rate)
    with torch.device("cuda"):
        codec = codec_mod.build(acfg)
    codec.reset_parameters(torch.Generator(device="cuda").manual_seed(SEED))
    encoded, real_encode = [], data_mod.tokenize_audio_batches

    def spy_encode(codec_, codec_cfg, arrays, **kw):
        encoded.extend(len(a) for a in arrays)
        return real_encode(codec_, codec_cfg, arrays, **kw)

    tok = tokenizer_mod.Tokenizer.from_pretrained(t5_dir)
    data_mod.tokenize_audio_batches = spy_encode
    try:
        samples, prep_s = sync_time(lambda: run_mod.prepare_rows(rows, data_args, cfg, codec, tok, tok))
        first_encoded = list(encoded)
        encoded.clear()
        again, reread_s = sync_time(lambda: run_mod.prepare_rows(rows, data_args, cfg, codec, tok, tok))
    finally:
        data_mod.tokenize_audio_batches = real_encode
    del codec
    kept_audio_s = sum(first_encoded) / acfg.sampling_rate
    written = run_mod._load_or_prepare(data_args, model_args, cfg, split="train", make=lambda: samples)
    prepared_files = sorted(os.listdir(os.path.join(out_dir, "prepared")))
    prep_ok = ({s["_idx"] for s in samples} == set(range(TEXT_ROWS)) - dropped and encoded == []
               and len(first_encoded) == len(samples) and written is samples and len(prepared_files) == 1
               and all(np.array_equal(a["labels"], b["labels"]) for a, b in zip(samples, again))
               and all(list(s["input_ids"]) == t5_ids[s["description_text"]]
                       and list(s["prompt_input_ids"]) == t5_ids[s["prompt_text"]] for s in samples))

    # ----- training from the prepared file -----
    layers = cfg.decoder.num_hidden_layers
    text_norms = 2 * cfg.text_encoder.num_layers + 1  # T5's RMSNorms, on K9
    spy = KernelSpy(fa, ("flash_attention_fwd", "flash_attention_dqkv"), place="text train step")
    reset_counts()
    with spy:
        result = run_mod.main(argv, device="cuda")
    cli_launches = counts()
    errs = spy.hold("main path text")
    final = os.path.join(out_dir, "run", "final")
    records = [json.loads(line) for line in open(os.path.join(out_dir, "run", "metrics.jsonl"))]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    carried = all(open(os.path.join(final, f), "rb").read() == open(os.path.join(t5_dir, f), "rb").read()
                  for f in tokenizer_mod.FILES)
    want_cli = {"flash_attention_fwd": 2 * layers, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                "flash_attention_dqkv": 2 * layers, "decode_attention": 0, "snake": 0,
                "dac_conv": 0, "ssm_step": 0, "norm": 2 * text_norms}
    gc.collect()
    torch.cuda.empty_cache()

    # ----- serving from the artifact with its own tokenizer -----
    pipe, load_s = sync_time(lambda: pipeline_mod.ParlerTTSPipeline.from_pretrained(final, dtype=torch.bfloat16,
                                                                                   device="cuda"))
    zero_special_heads(pipe.model)
    pipe.gen = dataclasses.replace(pipe.gen, top_k=50)
    descs, prompts = expected["smoke_descriptions"][:2], expected["smoke_prompts"][:2]
    max_seconds, seed = 1.0, SEED + 11
    sampled, real_generate = [], pipeline_mod.generate

    def spy_generate(*args, **kwargs):
        out = real_generate(*args, **kwargs)
        sampled.append(out.tokens.clone())
        return out

    pipeline_mod.generate = spy_generate
    try:
        ((sr, wavs), first_tts_s), tts_launches, tts_spy, tts_err = counted(
            fa, layers, lambda: sync_time(lambda: pipe.tts(descs, prompts, seed=seed, max_seconds=max_seconds)),
            place="text tts")
        tts_s = sync_time(lambda: pipe.tts(descs, prompts, seed=seed, max_seconds=max_seconds))[1]
    finally:
        pipeline_mod.generate = real_generate

    def padded(rows_ids, left: bool):
        """As ``tts`` lays ids out: the tokenizer pads each row on the right
        (with ``<pad>``, id 0) to the longest, then prompts are padded on
        the left to their bucket and descriptions on the right."""
        longest = max(len(r) for r in rows_ids)
        width = pipeline_mod._bucket(longest)
        ids, mask = np.zeros((len(rows_ids), width), np.int64), np.zeros((len(rows_ids), width), np.int64)
        start = width - longest if left else 0
        for i, r in enumerate(rows_ids):
            ids[i, start:start + len(r)], mask[i, start:start + len(r)] = r, 1
        return ids, mask

    d_ids, d_mask = padded([t5_ids[d] for d in descs], left=False)
    p_ids, p_mask = padded([t5_ids[p] for p in prompts], left=True)
    direct = generate_mod.generate(pipe.model, dataclasses.replace(pipe.gen, max_length=pipe.max_length(max_seconds)),
                                   input_ids=d_ids, attention_mask=d_mask, prompt_input_ids=p_ids,
                                   prompt_attention_mask=p_mask,
                                   generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    ids_equal = (all(pipe.description_tokenizer(d).input_ids == t5_ids[d] for d in descs)
                 and all(pipe.prompt_tokenizer(p).input_ids == t5_ids[p] for p in prompts))
    tokens_equal = len(sampled) == 2 and all(torch.equal(t, direct.tokens) for t in sampled)
    finite = all(w.size > 0 and bool(np.isfinite(w).all()) for w in wavs)
    reader_is_the_ports = isinstance(pipe.description_tokenizer, tokenizer_mod.Tokenizer)
    del pipe, direct
    gc.collect()
    torch.cuda.empty_cache()

    launches = {name: cli_launches[name] + (tts_launches if name == "flash_attention_fwd" else 0)
                for name in cli_launches}
    errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], tts_err)
    ok = (prep_ok and cli_launches == want_cli and result["steps"] == 2 and len(losses) == 2
          and all(math.isfinite(x) for x in losses) and carried and reader_is_the_ports and ids_equal
          and tokens_equal and finite)
    emit({"phase": "text", "config": "mini_600m_config: DAC encode fp32 (seed 0), CLI fp32 parameters bf16 "
          "compute (seed 42), tts bf16", "card": card, "fixtures_equal_recorded_ids": fixtures_equal,
          "reader": rates, "rows": TEXT_ROWS, "dropped": sorted(dropped), "kept": len(samples),
          "kept_audio_s": kept_audio_s, "prepare_s": prep_s, "prepare_audio_s_per_wall_s": kept_audio_s / prep_s,
          "reprepare_s": reread_s, "encoded_first": len(first_encoded), "encoded_second": len(encoded),
          "prepared_file": prepared_files, "prep_ok": prep_ok, "cli_step_ms": result["timings"]["step_ms"],
          "cli_losses": losses, "cli_launches": cli_launches, "artifact_tokenizer_carried": carried,
          "artifact_load_s": load_s, "tts_requests": len(wavs), "tts_max_seconds": max_seconds,
          "tts_first_call_s": first_tts_s, "tts_wall_s": tts_s, "tts_samples": [int(w.size) for w in wavs],
          "sampling_rate": sr,
          "ids_equal_recorded": ids_equal, "tokens_equal_direct_generate": tokens_equal, "finite": finite,
          "launches": launches, "held_against_plain": sorted({(place, name, shapes[0]) for place, name, shapes, _
                                                              in list(spy.captured) + list(tts_spy.captured)}),
          "max_abs_err": errs, "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise AssertionError("the text phase is not as it should be (see the text line)")
    return launches, errs


def k1_row(fa, q, k, v, start, end, kw) -> dict:
    """Device times of K1, its plain version and SDPA with the same mask on
    one kept call's inputs (BH, T, D), and the bound for the pairs its
    bounds and causality leave valid."""
    import torch.nn.functional as F

    bh, t, d = q.shape
    keys = torch.arange(k.shape[1], device=q.device)[None, None, :]
    valid = (keys >= start[:, None, None].long()) & (keys < end[:, None, None].long())
    if kw.get("causal", True):
        valid = valid & (keys <= torch.arange(t, device=q.device)[None, :, None] + kw.get("q_offset", 0))
    row = {"shape": [bh, t, d], "ms": graph_ms(lambda: fa.flash_attention_fwd(q, k, v, start, end, **kw)),
           "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q, k, v, start, end, **kw)),
           "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=valid,
                                                                         scale=kw["scale"]))}
    nbytes = 4 * bh * t * d * q.element_size() + bh * t * 4 + 2 * bh * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * d * int(valid.sum()), H100_BF16_FLOPS)
    return row


def counted(fa, layers: int, fn, *, place: str, calls=1):
    """``fn()`` with the kernel counts set to 0 just before it and read just
    after.  K1 must have launched once per layer per prefill (``calls``, or
    ``calls()`` after ``fn``; a prefill replayed from its graph counts the
    launches the graph holds) and no backward kernel at all.  The first K1
    call at each shape keeps its tensors, which are then held against the
    plain version.  Returns (fn's result, K1's launches, the spy, the
    largest error held)."""
    spy = KernelSpy(fa, place=place)
    reset_counts()
    with spy:
        result = fn()
    launched = counts()
    want = layers * (calls() if callable(calls) else calls)
    if launched["flash_attention_fwd"] != want or any(launched[name] for name in BWD_NAMES):
        raise AssertionError(f"{place} launched {launched}, want K1 {want} times and no backward")
    return result, launched["flash_attention_fwd"], spy, spy.hold("main path")["flash_attention_fwd"]


def counter(name: str) -> float:
    """The program's counter ``name`` now (``utils/profiling.counters()``)."""
    from parler_tts_tpu_torch.utils import profiling

    return profiling.counters().get(name, 0)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def run_decoder_only(cfg, model, pipe, fa, generate_mod, card: str) -> tuple[int, float, dict]:
    """Mini's DAC (bf16) encodes two seeded 2 s waveforms; then, at batch 2,
    CFG 3.0 and top-k 50, ``generate_decoder_only`` continues their codes
    with two embedded prompts as ``prompt_hidden_states`` (their null rows
    zeroed), and composite ``generate(input_values=...)`` continues the
    waveforms from two descriptions and prompts.  ``max_length`` holds the
    audio prompt's frames plus 2.5 s of new audio.  Each call launches K1
    once per layer; the first K1 call of each prefill is held against its
    plain version, and the decoder-only one timed.  Returns K1's launches,
    its largest error held and its time row."""
    layers, hop, sr = cfg.decoder.num_hidden_layers, cfg.audio_encoder.hop_length, cfg.sampling_rate
    waves = sine_waves((140.0, 220.0), 2.0, sr, SEED + 6)
    codes, encode_s = sync_time(lambda: model.audio_encoder.encode(torch.from_numpy(waves).cuda()))
    frames = codes.shape[2]
    gen = dataclasses.replace(pipe.gen, guidance_scale=3.0)
    max_length = frames + pipe.max_length(2.5)
    ids = pipe.tokenize(DESCRIPTIONS[:2], _prompts(10)[:2])
    with torch.no_grad():
        prompt_hidden = model.embed_prompts(torch.from_numpy(ids["prompt_input_ids"]).cuda())
    runs = {
        "generate_decoder_only": lambda: generate_mod.generate_decoder_only(
            model, gen, decoder_input_codes=codes, prompt_hidden_states=prompt_hidden,
            prompt_attention_mask=ids["prompt_attention_mask"], max_length=max_length,
            generator=torch.Generator(device="cuda").manual_seed(SEED)),
        "generate(input_values)": lambda: generate_mod.generate(
            model, gen, input_values=waves, max_length=max_length,
            generator=torch.Generator(device="cuda").manual_seed(SEED), **ids),
    }
    launches, rows, errs, spies = 0, [], [], {}
    for name, run in runs.items():
        (out, wall), launched, spies[name], err = counted(fa, layers, lambda: sync_time(run), place=name)
        launches, errs = launches + launched, errs + [err]
        new_s = (out.code_lengths - frames).clamp(min=0).sum().item() * hop / sr
        ok = (bool((out.codes[:, :, :frames] == codes).all()) and bool(torch.isfinite(out.audio).all())
              and int(out.code_lengths.min()) > frames)
        rows.append({"call": name, "batch": 2, "cfg": 3.0, "prompt_frames": frames, "max_length": max_length,
                     "prefill_T": ids["prompt_input_ids"].shape[1] + 1 + frames, "wall_s": wall,
                     "new_audio_s": new_s, "code_lengths": out.code_lengths.tolist(), "k1_launches": launched,
                     "prompt_codes_kept": ok})
        emit({"phase": "decoder_only", **rows[-1]})
        if not ok:
            raise AssertionError(f"{name} lost its audio prompt or gave non-finite audio")
    (args, kw, _), = spies["generate_decoder_only"].captured.values()
    k1 = {"kernel": "flash_attention_fwd", "path": "decoder_only prefill", **k1_row(fa, *args, kw)}
    emit({"phase": "k1_time", **k1})
    emit({"phase": "decoder_only_summary", "config": "mini_600m_config bf16, random weights (seed 0)", "card": card,
          "dac_encode_s": encode_s, "audio_prompt_s": waves.shape[1] / sr, "calls": rows,
          "k1_max_abs_err": max(errs), "k1_launches": launches})
    return launches, max(errs), k1


def mel_worst(mel_mod, pairs, sr: int) -> dict:
    """The largest of ``mel_mod.mel_distance``'s numbers over (a, b)
    waveform pairs, computed on the card; the length mismatches."""
    d = [mel_mod.mel_distance(torch.as_tensor(np.asarray(a, np.float32)).cuda(),
                              torch.as_tensor(np.asarray(b, np.float32)).cuda(), sr) for a, b in pairs]
    return {"pairs": len(d), "mel_max_abs_db": max((x["mel_max_abs_db"] for x in d), default=None),
            "mel_mean_abs_db": max((x["mel_mean_abs_db"] for x in d), default=None),
            "wave_max_abs": max((x["wave_max_abs"] for x in d), default=None),
            "length_mismatch": [x["length_mismatch"] for x in d]}


def run_int8(cfg, model, pipe, fa, generate_mod, mel_mod, card: str) -> tuple[int, float]:
    """The main path's tts config (4 requests, 2.5 s, prompt bucket 64) with
    ``kv_cache_dtype="int8"`` and ``int8_weights`` beside the bf16 config,
    in turns (bf16, int8, int8, bf16), each call synchronised and timed
    phase by phase; the KV cache's bytes of each; the mel distance of the
    first int8 call's waveforms from the first bf16 call's (the same input
    ids and sampling seed; reported, not gated); and, greedy from one
    prefill's inputs, the max abs difference of the first decode step's
    logits, int8 against bf16.  Returns K1's launches and its largest
    error held."""
    layers = cfg.decoder.num_hidden_layers
    pipes = {"bf16": pipe, "int8": dataclasses.replace(pipe, gen=dataclasses.replace(
        pipe.gen, kv_cache_dtype="int8", int8_weights=True))}
    caches, real_prefill = {}, generate_mod._captured_prefill

    def keep_cache(model, gen, captured, *args, **kw):  # the cache the prefill writes: the signature's static one
        cache = captured.state.cache
        caches["int8" if cache.self_k.dtype == torch.int8 else "bf16"] = cache.nbytes
        return real_prefill(model, gen, captured, *args, **kw)

    timings, results = {"bf16": [], "int8": []}, {"bf16": [], "int8": []}
    generate_mod._captured_prefill = keep_cache
    try:
        def calls():
            for name in ("bf16", "int8", "int8", "bf16"):
                timings[name].append(time_phases(model, pipes[name], _prompts(50), 2.5, out=results[name]))
        _, launches, _, err = counted(fa, layers, calls, place="int8 and bf16 tts", calls=4)
    finally:
        generate_mod._captured_prefill = real_prefill
    tensors = {key: torch.from_numpy(value).cuda() for key, value in pipe.tokenize(DESCRIPTIONS, _prompts(50)).items()}
    greedy = dataclasses.replace(pipe.gen, do_sample=False, max_length=pipe.max_length(2.5))
    logits = {}
    for name, gen in (("bf16", greedy), ("int8", dataclasses.replace(greedy, kv_cache_dtype="int8",
                                                                     int8_weights=True))):
        state = generate_mod.prefill(model, gen, max_length=gen.max_length, **tensors)
        generate_mod.decode_step(model, gen, state)
        logits[name] = state.logits.float()
    diff = (logits["int8"] - logits["bf16"]).abs().max().item()
    summary = {
        "config": "mini_600m_config bf16, random weights (seed 0), 4 requests x 2.5 s, prefill T = 65",
        "card": card, "k1_launches": launches, "k1_max_abs_err": err,
        **{f"{name}_decode_ms_per_step": [t["decode_ms_per_step"] for t in runs] for name, runs in timings.items()},
        **{f"{name}_decode_ms_per_step_median": [t["decode_ms_per_step_median"] for t in runs]
           for name, runs in timings.items()},
        **{f"{name}_synced_wall_s": [t["synced_wall_s"] for t in runs] for name, runs in timings.items()},
        "decode_steps": timings["bf16"][0]["decode_steps"], "kv_cache_bytes": caches,
        "first_step_logits_max_abs_diff": diff, "first_step_logits_max_abs": logits["bf16"].abs().max().item(),
        "int8_vs_bf16_mel": mel_worst(mel_mod, zip(results["int8"][0][1], results["bf16"][0][1]),
                                      cfg.sampling_rate),
    }
    emit({"phase": "int8", **summary})
    if not (math.isfinite(diff) and caches["int8"] < caches["bf16"]):
        raise AssertionError(f"int8 decode gave non-finite logits or a cache no smaller than bf16's: {summary}")
    return launches, err


DECODE_PROFILE_STEPS = 16  # decode steps under torch.profiler, per loop
# the host's kernel-launch calls: a graph's replay is one cudaGraphLaunch
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")


def launch_profile(fn, steps: int) -> dict:
    """``fn()`` (``steps`` decode steps) under torch.profiler: the host's
    launch calls per step (graph launches among them), the device's kernels
    and their busy ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = graphs = kernels = 0
    busy_us = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            kernels += 1
            busy_us += e.time_range.elapsed_us()
        elif e.name in LAUNCH_CALLS:
            launches += 1
            graphs += e.name == "cudaGraphLaunch"
    return {"host_launches_per_step": launches / steps, "graph_launches_per_step": graphs / steps,
            "device_kernels_per_step": kernels / steps, "device_busy_ms_per_step": busy_us / 1e3 / steps}


def first_difference(a: torch.Tensor, b: torch.Tensor):
    """(b, k, t) of the earliest position where two token buffers differ,
    or None."""
    diff = (a != b).nonzero()
    if not len(diff):
        return None
    return tuple(int(x) for x in diff[diff[:, 2].argmin()])


def tie_gap(model, gen, tensors, seed: int, where, tokens) -> dict:
    """The eager loop run again up to the step that sampled ``where`` =
    (b, k, t): the score (processed logits, plus the Gumbel noise when
    sampling) of the eager token and of the captured token ``tokens[where]``
    at that step, their gap and the score's scale."""
    from parler_tts_tpu_torch.generation import generate as generate_mod
    from parler_tts_tpu_torch.generation import sampling

    b, k, t = where
    s = generate_mod.prefill(model, gen, max_length=gen.max_length, **tensors)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    while s.t < t:
        generate_mod.decode_step(model, gen, s, generator=generator)
    logits = s.logits.float()
    n = s.tokens.shape[0]
    if s.use_cfg:
        logits = sampling.apply_cfg(logits[:n], logits[n:], gen.guidance_scale)
    scores = sampling.process_logits(logits, gen)
    generate_mod.decode_step(model, gen, s, generator=generator)
    if gen.do_sample:
        scores = scores + sampling.gumbel_of(s.draw)
    row = scores[b, k]
    eager, captured = int(s.tokens[b, k, t]), int(tokens[b, k, t])
    return {"at": [b, k, t], "eager_token": eager, "captured_token": captured,
            "gap": abs(row[eager] - row[captured]).item(), "score_scale": row.abs().max().item()}


PREFILL_TIMED_CALLS = 5  # prefills timed per case and way; the median is reported


def state_difference(s, ref) -> list[str]:
    """The parts of a captured prefill's static state that are not an eager
    ``prefill``'s bit for bit: the cache's self K/V (and int8 scales) over
    the prefill's positions, its cross K/V (and scales), the first logits,
    tokens, pattern, masks, position, ``t`` and the cache index."""
    t = ref.cache.index
    bad = []
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
        a, b = getattr(s.cache, name), getattr(ref.cache, name)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a[:, :, :, :t], b[:, :, :, :t])):
            bad.append(name)
    for name in ("cross_k", "cross_v", "cross_k_scale", "cross_v_scale"):
        a, b = getattr(s.cache, name), getattr(ref.cache, name)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            bad.append(name)
    for name in ("logits", "tokens", "pattern", "fused_mask"):
        if not torch.equal(getattr(s, name), getattr(ref, name)):
            bad.append(name)
    if (s.enc_mask is None) != (ref.enc_mask is None) or (
            s.enc_mask is not None and not torch.equal(s.enc_mask, ref.enc_mask.to(s.enc_mask.dtype))):
        bad.append("enc_mask")
    if not (s.t == ref.t == int(s.position) and s.cache.index == t and not bool(s.finished.any())):
        bad.append("position")
    return bad


def prefill_cases(model, pipe, generate_mod) -> list[dict]:
    """The captured prefill (T5, prompt, delay pattern, the decoder prefill
    with K1, first logits) against an eager ``prefill`` on the same inputs,
    at Mini bf16, 4 requests: greedy at prefill T = 17, 65 and 257, int8
    weights and KV at 65, CFG 3.0 at 65, decoder-only (embedded prompts as
    ``prompt_hidden_states``, no text, CFG 3.0) and audio-prompted (86
    frames of codes after the BOS frame, T = 17 + 86).  Each: the static
    state after a replay must be the eager prefill's bit for bit
    (``state_difference``); the median of ``PREFILL_TIMED_CALLS`` replays
    against as many eager prefills (both into an allocated cache, with the
    decode view given); capture s where the shape was new."""
    greedy = dataclasses.replace(pipe.gen, do_sample=False, max_length=pipe.max_length(2.5))
    none = dict(prompt_hidden_states=None, decoder_input_codes=None)

    def tensors(n_words):
        ids = pipe.tokenize(DESCRIPTIONS, _prompts(n_words))
        return {**none, **{key: torch.from_numpy(value).cuda() for key, value in ids.items()}}

    short = tensors(10)
    with torch.no_grad():
        hidden = model.embed_prompts(short["prompt_input_ids"])
    k = model.cfg.decoder.num_codebooks
    codes = torch.randint(0, model.cfg.audio_encoder.codebook_size, (4, k, 86),
                          generator=torch.Generator().manual_seed(SEED + 15)).cuda()
    cfg3 = dataclasses.replace(greedy, guidance_scale=3.0)
    cases = [("T17", greedy, short), ("T65", greedy, tensors(50)), ("T257", greedy, tensors(200)),
             ("int8_T65", dataclasses.replace(greedy, kv_cache_dtype="int8", int8_weights=True), tensors(50)),
             ("cfg3_T65", cfg3, tensors(50)),
             ("decoder_only", cfg3, dict(input_ids=None, attention_mask=None, prompt_input_ids=None,
                                         prompt_attention_mask=short["prompt_attention_mask"],
                                         prompt_hidden_states=hidden, decoder_input_codes=codes[:, :, :0])),
             ("audio_prompted", greedy, {**short, "decoder_input_codes": codes})]
    programs = generate_mod._programs_of(model)
    rows = []
    for name, gen, inputs in cases:
        frames = 0 if inputs["decoder_input_codes"] is None else inputs["decoder_input_codes"].shape[2]
        max_length = gen.max_length + frames
        plan = generate_mod._plan(model, gen, max_length, inputs["input_ids"], inputs["prompt_input_ids"],
                                  inputs["prompt_hidden_states"], inputs["decoder_input_codes"])
        captures, capture_s = counter("prefill.captures"), counter("prefill.capture_s")
        with programs.lock:
            _, captured, _ = generate_mod._captured_generation(model, gen, programs, max_length=max_length,
                                                               generator=None, noise=None, **inputs)
            new = counter("prefill.captures") - captures
            s = captured.state
            replay_ms = [1e3 * sync_time(lambda: generate_mod._captured_prefill(
                model, gen, captured, plan, max_length=max_length, **inputs))[1] for _ in range(PREFILL_TIMED_CALLS)]
            ref = generate_mod.prefill(model, gen, max_length=max_length, params=s.params, **inputs)
            bad = state_difference(s, ref)
            eager_ms = [1e3 * sync_time(lambda: generate_mod.prefill(
                model, gen, max_length=max_length, cache=ref.cache, params=s.params, **inputs))[1]
                for _ in range(PREFILL_TIMED_CALLS)]
        del ref
        row = {"case": name, "prefill_T": plan.p_len + plan.t0, "rows": plan.rows, "bit_exact": not bad,
               "differing": bad, "captured_ms": sorted(replay_ms)[len(replay_ms) // 2],
               "eager_ms": sorted(eager_ms)[len(eager_ms) // 2],
               "capture_s": (counter("prefill.capture_s") - capture_s) / new if new else None,
               "k1_launches_per_replay":
                   captured.prefills[generate_mod._input_shapes(inputs)].program.launches["flash_attention_fwd"]}
        row["speedup"] = row["eager_ms"] / row["captured_ms"]
        emit({"phase": "decode_graph_prefill", **row})
        rows.append(row)
    return rows


def run_decode_graph(cfg, model, pipe, fa, generate_mod, card: str) -> tuple[int, float]:
    """The decode loop replayed from CUDA graphs (``generate_tokens`` on a
    CUDA model) against the per-step eager loop (``prefill`` then
    ``decode_step`` until ``done``), at Mini, 4 requests x 2.5 s, prefill T
    = 65 (the ladder [256, 280]): greedy fp32 (an fp32 copy of the model),
    greedy bf16, int8 weights with the int8 KV cache, and CFG 3.0 with top-k
    50 sampled from a seed.  fp32's tokens must be the eager loop's bit for
    bit; the others' equal, or their first difference at a near-tie (score
    gap within ``GRAPH_TIE_TOL`` of the score's scale), its gap printed.
    Each: the stop positions, decode ms/step both ways (the captured loop's
    second call, by segment; the eager loop whole), capture seconds per
    graph, launches and device kernels per step under torch.profiler.  Then
    one ``tts`` call must replay its steps (no eager ``decode_step``), and
    the captured prefill must write the eager prefill's state
    (``prefill_cases``).  K1 once per layer per prefill run: eager, replayed,
    or the warm-up that is a capturing call's prefill.  Peak memory
    allocated and nvidia-smi's memory.used.  Returns K1's launches and its
    largest error held."""
    from parler_tts_tpu_torch.core import graphs as graphs_mod

    layers = cfg.decoder.num_hidden_layers
    tensors = {key: torch.from_numpy(value).cuda() for key, value in pipe.tokenize(DESCRIPTIONS, _prompts(50)).items()}
    inputs = {"prompt_hidden_states": None, "decoder_input_codes": None, **tensors}
    greedy = dataclasses.replace(pipe.gen, do_sample=False, max_length=pipe.max_length(2.5))
    model32 = copy.deepcopy(model).float()
    cases = {
        "greedy_fp32": (model32, greedy),
        "greedy_bf16": (model, greedy),
        "int8_weights_and_kv": (model, dataclasses.replace(greedy, kv_cache_dtype="int8", int8_weights=True)),
        "cfg3_topk50_sampled": (model, dataclasses.replace(pipe.gen, guidance_scale=3.0,
                                                           max_length=greedy.max_length)),
    }
    torch.cuda.reset_peak_memory_stats()
    prefills, real_prefill, real_captured = [0], generate_mod.prefill, generate_mod._captured_prefill

    def counting_prefill(*args, **kw):
        prefills[0] += 1
        return real_prefill(*args, **kw)

    def counting_captured(*args, **kw):  # a replay, or the warm-up that is the capturing call's prefill
        prefills[0] += 1
        return real_captured(*args, **kw)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(SEED + 14)

    def cases_run():
        rows = []
        for name, (m, gen) in cases.items():
            captures, capture_s = counter("decode.captures"), counter("decode.capture_s")
            with timed_decode(generate_mod) as loops:
                first, t_first = generate_mod.generate_tokens(m, gen, max_length=gen.max_length, generator=seeded(),
                                                              **tensors)
                replays = counter("decode.replays")
                second, t_second = generate_mod.generate_tokens(m, gen, max_length=gen.max_length,
                                                                generator=seeded(), **tensors)
                replays = counter("decode.replays") - replays
            captured = counter("decode.captures") - captures
            s = generate_mod.prefill(m, gen, max_length=gen.max_length, **tensors)
            t0, generator = s.t, seeded()
            torch.cuda.synchronize()
            start = time.perf_counter()
            while not s.done:
                generate_mod.decode_step(m, gen, s, generator=generator)
            torch.cuda.synchronize()
            eager_ms = 1e3 * (time.perf_counter() - start) / (s.t - t0)
            where = first_difference(first, s.tokens)
            gap = None if where is None else tie_gap(m, gen, tensors, SEED + 14, where, first)
            # launches: 16 eager steps, then 16 replays of the first bucket's graph
            p = generate_mod.prefill(m, gen, max_length=gen.max_length, **tensors)
            generator = seeded()
            eager_prof = launch_profile(lambda: [generate_mod.decode_step(m, gen, p, generator=generator)
                                                 for _ in range(DECODE_PROFILE_STEPS)], DECODE_PROFILE_STEPS)
            programs = generate_mod._programs_of(m)
            with programs.lock:
                _, instance, segment = generate_mod._captured_generation(m, gen, programs, max_length=gen.max_length,
                                                                         generator=seeded(), noise=None, **inputs)
                state = instance.state
                size = state.limits[0]
                graph_prof = launch_profile(lambda: segment(size, min(gen.max_length, size - state.p_len),
                                                            DECODE_PROFILE_STEPS), DECODE_PROFILE_STEPS)
            spans = loops[1]
            steps = sum(n for _, n in spans)
            near_tie = gap is not None and gap["gap"] <= GRAPH_TIE_TOL * max(1.0, gap["score_scale"])
            row = {
                "case": name, "dtype": str(next(m.parameters()).dtype).removeprefix("torch."),
                "kv_read_buckets": state.limits, "stop_captured": t_first, "stop_eager": s.t,
                "same_tokens": where is None, "first_difference": gap,
                "second_call_same": bool(torch.equal(first, second)) and t_first == t_second,
                "graphs_captured": captured, "capture_s_per_graph": (counter("decode.capture_s") - capture_s)
                / max(captured, 1),
                "replays_second_call": replays, "captured_steps": steps,
                "captured_ms_per_step": sum(ms for ms, _ in spans) / steps, "eager_ms_per_step": eager_ms,
                "eager": eager_prof, "captured": graph_prof,
            }
            row["speedup"] = row["eager_ms_per_step"] / row["captured_ms_per_step"]
            row["ok"] = (row["second_call_same"] and replays == steps and t_first == s.t
                         and (where is None or (name != "greedy_fp32" and near_tie)))
            emit({"phase": "decode_graph", **row})
            rows.append(row)
        # the tts path replays the captured steps; no eager step runs
        eager_steps, real_step = [0], generate_mod.decode_step

        def counting_step(*args, **kw):
            eager_steps[0] += 1
            return real_step(*args, **kw)

        generate_mod.decode_step = counting_step
        try:
            replays = counter("decode.replays")
            sr, wavs = pipe.tts(DESCRIPTIONS, _prompts(50), seed=SEED, max_seconds=2.5)
            replays = counter("decode.replays") - replays
        finally:
            generate_mod.decode_step = real_step
        return rows, {"replays": replays, "eager_decode_steps": eager_steps[0],
                      "finite": all(bool(np.isfinite(w).all()) for w in wavs)}, prefill_cases(
            model, pipe, generate_mod)

    generate_mod.prefill, generate_mod._captured_prefill = counting_prefill, counting_captured
    try:
        (rows, tts, prefill_rows), launches, _, err = counted(fa, layers, cases_run, place="decode_graph",
                                                              calls=lambda: prefills[0])
    finally:
        generate_mod.prefill, generate_mod._captured_prefill = real_prefill, real_captured
    programs, views = generate_mod._programs_of(model), model.__dict__.get("_decode_views", {})
    summary = {
        "config": "mini_600m_config, random weights (seed 0), 4 requests x 2.5 s, prefill T = 65", "card": card,
        "cases": {r["case"]: {key: r[key] for key in ("same_tokens", "captured_ms_per_step", "eager_ms_per_step",
                                                       "speedup", "capture_s_per_graph")} for r in rows},
        "tts_replays": tts["replays"], "tts_eager_decode_steps": tts["eager_decode_steps"],
        "static_bytes_bf16_model": programs.nbytes,
        "decode_view_bytes_bf16_model": sum(x.numel() * x.element_size() for view in views.values()
                                            for x in generate_mod._view_tensors(view)),
        "graph_memory_share": graphs_mod.GRAPH_MEMORY_SHARE,
        "peak_mem_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "memory_used_mib": subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                                          capture_output=True, text=True, timeout=60).stdout.strip(),
        "k1_launches": launches, "k1_max_abs_err": err,
        "prefill_cases": {r["case"]: {key: r[key] for key in ("bit_exact", "captured_ms", "eager_ms",
                                                               "capture_s")} for r in prefill_rows},
    }
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    ok = (all(r["ok"] for r in rows) and tts["replays"] > 0 and tts["eager_decode_steps"] == 0 and tts["finite"]
          and all(r["bit_exact"] for r in prefill_rows))
    emit({"phase": "decode_graph_summary", **summary, "ok": ok})
    if not ok:
        raise AssertionError(f"the captured decode loop or prefill is not the eager one's, or tts did not replay "
                             f"it: {rows} {prefill_rows}")
    return launches, err


def stream_run(model, streaming_mod, gen, ids, vocode_ms: list | None = None) -> dict:
    """One stream of 86-frame chunks with a lookback of 48, timed; with
    ``vocode_ms`` each chunk's vocode is synchronised and timed into it."""
    from parler_tts_tpu_torch.models import codec as codec_mod

    chunks, first, real_decode = [], None, codec_mod.decode
    if vocode_ms is not None:
        def timed(*args, **kw):
            audio, t = sync_time(lambda: real_decode(*args, **kw))
            vocode_ms.append(1e3 * t)
            return audio
        codec_mod.decode = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for chunk in streaming_mod.stream_generate(model, gen, chunk_frames=86, lookback=48,
                                                   generator=torch.Generator(device="cuda").manual_seed(SEED), **ids):
            if first is None:
                first = time.perf_counter() - t0
            chunks.append(chunk)
        wall = time.perf_counter() - t0
    finally:
        codec_mod.decode = real_decode
    return {"chunks": chunks, "first_chunk_s": first, "wall_s": wall}


def eager_stream_run(model, streaming_mod, generate_mod, gen, ids) -> dict:
    """The same stream on the per-step eager loop (``prefill``, then
    ``decode_step`` position by position, as a split model streams), its
    chunks cut and vocoded by the stream's own ``_chunks``, timed."""
    tensors = {key: torch.from_numpy(value).cuda() for key, value in ids.items()}
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    chunks, first = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = generate_mod.prefill(model, gen, max_length=gen.max_length, **tensors)

    def decode_to(end):
        while s.t < end and not s.done:
            generate_mod.decode_step(model, gen, s, generator=generator)

    for chunk in streaming_mod._chunks(model, s, decode_to, max_length=gen.max_length, chunk_frames=86, lookback=48,
                                       vocode=True, dev=torch.device("cuda")):
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(chunk)
    return {"chunks": chunks, "first_chunk_s": first, "wall_s": time.perf_counter() - t0}


def stream_vs_one_shot(codec, chunks, mel_mod) -> tuple[float, float, float, dict]:
    """Each chunk's audio against a one-shot vocode of every frame ready so
    far, and the whole stream against a one-shot vocode of all its frames
    (codes cleaned as the stream cleans them, audio zeroed past each
    sample's end): the max abs differences, the one-shot's peak, and the
    mel distance (``mel_worst``) of each sample's stream from its whole
    one-shot vocode over its valid samples."""
    codes = np.concatenate([c.codes for c in chunks], axis=2)
    cb, hop = codec.cfg.codebook_size, codec.cfg.hop_length

    def one_shot(n, lengths):
        frames = np.arange(n)
        clean = np.where((frames[None, None] < lengths[:, None, None]) & (codes[:, :, :n] < cb), codes[:, :, :n], 0)
        with torch.no_grad():
            audio = codec.decode(torch.from_numpy(clean).cuda()).float().cpu().numpy()
        return np.where(np.arange(audio.shape[1])[None] < lengths[:, None] * hop, audio, 0.0)

    prefix = 0.0
    for c in chunks:
        ready = c.frame_offset + c.codes.shape[2]
        ref = one_shot(ready, np.minimum(c.valid_lengths, ready))[:, c.frame_offset * hop:]
        prefix = max(prefix, float(np.abs(ref - c.audio).max()))
    lengths = chunks[-1].valid_lengths
    whole = one_shot(codes.shape[2], lengths)
    audio = np.concatenate([c.audio for c in chunks], axis=1)
    mel = mel_worst(mel_mod, [(audio[i, :n * hop], whole[i, :n * hop]) for i, n in enumerate(lengths) if n],
                    codec.cfg.sampling_rate)
    return prefix, float(np.abs(whole - audio).max()), float(np.abs(whole).max()), mel


def run_stream(cfg, model, pipe, fa, generate_mod, streaming_mod, mel_mod, card: str) -> tuple[int, float]:
    """``stream_generate`` at Mini, batch 4, 2.5 s, chunks of 86 frames,
    lookback 48 (bf16, top-k 50, one generator seed), on the captured
    programs (the prefill replayed or captured, the bucket graphs replayed
    chunk by chunk; no ``decode_step`` may run), then on the per-step eager
    loop (``eager_stream_run``) with the same seed: first-chunk latency,
    wall, audio s per wall s both ways, prefill replays and captures; the
    codes of both and of ``generate`` with that seed must be equal bit for
    bit.  Each chunk's vocode ms (synchronised), and the device's busy share
    of one chunk's vocode under torch.profiler (the second chunk's window of
    48 + 86 frames).  Then the captured stream with an fp32 copy of the
    codec: each chunk must equal a one-shot fp32 vocode of the frames ready
    so far within 1e-4; the difference from a one-shot vocode of the whole
    utterance (the chunks lack right context) and the bf16 codec's
    differences are reported, with the mel distance of the stream from that
    whole vocode.  Returns K1's launches and its largest error held."""
    from parler_tts_tpu_torch.models import codec as codec_mod
    from parler_tts_tpu_torch.models.delay_pattern import undelay_pattern

    layers, sr = cfg.decoder.num_hidden_layers, cfg.sampling_rate
    ids = pipe.tokenize(DESCRIPTIONS, _prompts(10))
    gen = dataclasses.replace(pipe.gen, max_length=pipe.max_length(2.5))
    steps, real_step = [0], generate_mod.decode_step

    def counting_step(*args, **kw):
        steps[0] += 1
        return real_step(*args, **kw)

    def captured_stream():  # no eager decode_step may run in it
        generate_mod.decode_step = counting_step
        try:
            return stream_run(model, streaming_mod, gen, ids, vocode_ms)
        finally:
            generate_mod.decode_step = real_step

    vocode_ms = []
    replays, captures = counter("prefill.replays"), counter("prefill.captures")
    (run, eager), launches, _, err = counted(
        fa, layers, lambda: (captured_stream(), eager_stream_run(model, streaming_mod, generate_mod, gen, ids)),
        place="stream", calls=2)
    replays, captures = counter("prefill.replays") - replays, counter("prefill.captures") - captures
    chunks = run["chunks"]
    codes = np.concatenate([c.codes for c in chunks], axis=2)
    eager_codes = np.concatenate([c.codes for c in eager["chunks"]], axis=2)
    lengths = chunks[-1].valid_lengths
    out = generate_mod.generate(model, gen, generator=torch.Generator(device="cuda").manual_seed(SEED),
                                vocode=False, **ids)
    offline = undelay_pattern(out.tokens[:, :, 1:]).cpu().numpy()[:, :, : codes.shape[2]]
    as_generate = bool(np.array_equal(codes, offline)) and np.array_equal(lengths, out.code_lengths.cpu().numpy())
    as_eager = (np.array_equal(codes, eager_codes) and [c.frame_offset for c in chunks]
                == [c.frame_offset for c in eager["chunks"]])
    ready = chunks[1].frame_offset + chunks[1].codes.shape[2]
    window = codes[:, :, max(0, ready - 48 - 86):ready]
    window = torch.from_numpy(np.where(window >= cfg.audio_encoder.codebook_size, 0, window)).cuda()
    vocode_profile = profile_call(lambda: codec_mod.decode(model.audio_encoder, window))
    bf16 = stream_vs_one_shot(model.audio_encoder, chunks, mel_mod)
    bf16_codec = model.audio_encoder
    model.audio_encoder = copy.deepcopy(bf16_codec).float()
    try:
        fp32_run = stream_run(model, streaming_mod, gen, ids)
        fp32 = stream_vs_one_shot(model.audio_encoder, fp32_run["chunks"], mel_mod)
    finally:
        model.audio_encoder = bf16_codec
    fp32_codes = np.concatenate([c.codes for c in fp32_run["chunks"]], axis=2)
    audio_s = float(lengths.sum()) * cfg.audio_encoder.hop_length / sr
    summary = {
        "config": "mini_600m_config bf16, random weights (seed 0), 4 requests x 2.5 s", "card": card,
        "chunk_frames": 86, "lookback": 48, "chunks": len(chunks), "chunk_frames_emitted": [
            int(c.codes.shape[2]) for c in chunks], "first_chunk_s": run["first_chunk_s"], "wall_s": run["wall_s"],
        "audio_s": audio_s, "audio_s_per_wall_s": audio_s / run["wall_s"],
        "eager_first_chunk_s": eager["first_chunk_s"], "eager_wall_s": eager["wall_s"],
        "eager_audio_s_per_wall_s": audio_s / eager["wall_s"], "prefill_replays": replays,
        "prefill_captures": captures, "decode_steps_run_by_captured_stream": steps[0],
        "chunk_vocode_ms": vocode_ms, "chunk_vocode_device_busy_ms": vocode_profile.get("device_busy_ms"),
        "chunk_vocode_wall_ms_profiled": vocode_profile.get("wall_ms"),
        "chunk_vocode_device_busy_share": vocode_profile.get("device_busy_share"),
        "chunk_vocode_top_kernels_ms": vocode_profile.get("top_kernels_ms"),
        "k1_launches": launches, "k1_max_abs_err": err,
        "codes_equal_generate": as_generate, "codes_equal_eager_stream": bool(as_eager),
        "fp32_codec_same_codes": bool(np.array_equal(codes, fp32_codes)),
        "fp32_max_abs_diff_vs_one_shot_so_far": fp32[0], "tol": 1e-4,
        "fp32_max_abs_diff_vs_one_shot_whole": fp32[1], "fp32_one_shot_peak": fp32[2],
        "bf16_max_abs_diff_vs_one_shot_so_far": bf16[0], "bf16_max_abs_diff_vs_one_shot_whole": bf16[1],
        "bf16_one_shot_peak": bf16[2], "fp32_mel_vs_one_shot_whole": fp32[3], "bf16_mel_vs_one_shot_whole": bf16[3],
        "fp32_first_chunk_s": fp32_run["first_chunk_s"],
        "fp32_wall_s": fp32_run["wall_s"],
    }
    # fp32: each chunk equal to the one-shot vocode of the frames so far, absolutely and relative to the peak
    ok = (as_generate and as_eager and steps[0] == 0 and replays + captures == 1
          and summary["fp32_codec_same_codes"] and fp32[0] <= 1e-4 and fp32[0] <= 1e-4 * fp32[2] and len(chunks) > 1)
    emit({"phase": "stream", **summary, "ok": ok})
    if not ok:
        raise AssertionError("the captured stream's codes are not the eager stream's and generate's, it ran a "
                             "decode_step, or its fp32 audio is not a one-shot vocode's")
    return launches, err


def run_serving(cfg, model, pipe, fa, serving_mod, card: str) -> tuple[int, float]:
    """``BatchingEngine`` over the Mini pipeline (batch buckets 1, 2, 4, 8;
    length buckets 1 s and 2.5 s): ``warmup()`` of the burst's batch buckets
    (2 and 4 rows) at both lengths, then a burst of 6 requests
    from 6 threads, 4 of at most 1 s and 2 of 2.5 s.  Each engine call is
    replayed as a direct ``tts`` on the same padded rows with the same folded
    seed: the waveforms must agree within 1e-5.  Reports per-request
    latency, the batches and the pad rows.  Returns K1's launches and its
    largest error held."""
    import threading

    layers = cfg.decoder.num_hidden_layers
    calls = []

    class Recorder:
        """The pipeline, recording each call the engine makes."""
        cfg, gen = pipe.cfg, pipe.gen

        def tts(self, descs, prompts, *, seed=0, max_seconds=None):
            out = pipe.tts(descs, prompts, seed=seed, max_seconds=max_seconds)
            calls.append((list(descs), list(prompts), seed, max_seconds, out))
            return out

    def serve():
        engine = serving_mod.BatchingEngine(Recorder(), max_batch=8, batch_buckets=(1, 2, 4, 8),
                                            length_bucket_seconds=(1.0, 2.5))
        try:
            # the burst's buckets only (2 and 4 rows), to keep the smoke's time as later phases grow
            warm = engine.warmup(description=DESCRIPTIONS[3], prompt=_prompts(10)[0], batch_buckets=(2, 4),
                                 timeout=600)
            n_warm = len(calls)
            requests = [(DESCRIPTIONS[i % 4], _prompts(10)[i % 4], 1.0 if i < 4 else 2.5, SEED + i)
                        for i in range(6)]
            latency, failed = [None] * 6, []
            barrier = threading.Barrier(6)

            def client(i):
                desc, prompt, seconds, seed = requests[i]
                barrier.wait(timeout=60)
                t0 = time.perf_counter()
                try:
                    sr, wav = engine.tts(desc, prompt, max_seconds=seconds, seed=seed, timeout=600)
                except Exception as e:  # re-raised below, on the main thread
                    failed.append(e)
                    return
                latency[i] = {"max_seconds": seconds, "latency_s": time.perf_counter() - t0,
                              "audio_s": wav.size / sr}

            threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            if failed:
                raise failed[0]
            if any(th.is_alive() for th in threads) or None in latency:
                raise AssertionError("a serving request did not complete")
            return warm, n_warm, latency, engine.stats()
        finally:
            engine.shutdown()

    def replay(n_warm):
        errs = []
        for descs, prompts, seed, max_seconds, (sr, waves) in calls[n_warm:]:
            _, direct = pipe.tts(descs, prompts, seed=seed, max_seconds=max_seconds)
            errs.append(max(float(np.abs(a - b).max(initial=0.0)) if a.shape == b.shape else math.inf
                            for a, b in zip(waves, direct)))
        return errs

    replays = []

    def serve_and_replay():
        result = serve()
        replays.extend(replay(result[1]))
        return result

    (warm, n_warm, latency, stats), launches, _, err = counted(
        fa, layers, serve_and_replay, place="serving", calls=lambda: len(calls) + len(replays))
    batches = [{"rows": len(descs), "max_seconds": max_seconds, "seed": seed}
               for descs, _, seed, max_seconds, _ in calls[n_warm:]]
    summary = {"config": "mini_600m_config bf16, random weights (seed 0), top-k 50", "card": card,
               "warmup_s": warm, "requests": latency, "batches": batches, "stats": stats,
               "max_abs_diff_vs_direct_tts": replays, "tol": 1e-5, "k1_launches": launches, "k1_max_abs_err": err}
    ok = (all(e <= 1e-5 for e in replays) and stats["requests"] == 6 and stats["batched_requests"] == 6 + len(warm)
          and stats["padded_rows"] == stats["bucket_rows"] - stats["batched_requests"])
    emit({"phase": "serving", **summary, "ok": ok})
    if not ok:
        raise AssertionError("the batching engine's results are not those of direct tts calls on its rows")
    return launches, err


HTTP_REQUESTS = (0.25, 0.5, 0.25, 0.5, 1.0, 0.75)  # max_seconds of the burst's 6 requests
HTTP_LENGTH_BUCKETS = (0.5, 1.0)


def _http(url: str, fields: dict | None = None, timeout: float = 600) -> tuple[str, bytes, float]:
    """One request to the demo server on this host: POST of ``fields`` as a
    form, or GET; -> (Content-Type, body, seconds)."""
    import urllib.parse
    import urllib.request

    data = None if fields is None else urllib.parse.urlencode(fields).encode()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as resp:
        kind, body = resp.headers["Content-Type"], resp.read()
    return kind, body, time.perf_counter() - t0


def _wav_rate(body: bytes) -> tuple[int, int]:
    """(sampling rate, frames) of a mono 16-bit WAV body; raises otherwise."""
    import io
    import wave

    with wave.open(io.BytesIO(body), "rb") as f:
        if f.getnchannels() != 1 or f.getsampwidth() != 2:
            raise AssertionError(f"not a mono 16-bit WAV: {f.getnchannels()} channels, width {f.getsampwidth()}")
        return f.getframerate(), f.getnframes()


def run_http_serving(cfg, model, pipe, fa, serving_mod, ck, reader_mod, card: str, tmp: str):
    """The demo server (``helpers/gradio_demo/app_torch.py``) over phase 4's
    model with a ``pcm16`` pipeline.  In this process: ``make_http_server``
    on 127.0.0.1:0 over a ``BatchingEngine`` (batch buckets 1, 2, 4, 8;
    length buckets 0.5 s and 1 s) whose pipeline records its calls; a burst
    of 6 ``POST /api`` requests of 0.25-1 s from 6 threads, then ``GET
    /stats``.  Each response must be a 44.1 kHz WAV equal, byte for byte, to
    ``wav_bytes`` of its row of a direct ``tts`` replay of its batch; the
    counters must be the recorded calls'; K1 once per layer per prefill,
    held against its plain version.  Then the entry point as a user starts
    it: ``app_torch.py`` in a subprocess, with no ``--warmup``, on an
    artifact of this model (``ck.save_model``, the T5-shaped tokenizer
    fixture bundled, its generation length cut to 1 s, which caps every
    length bucket), answering one ``POST /api`` and one ``POST /``; the
    subprocess is stopped and the artifact deleted by the caller.  Returns
    K1's launches, its largest error held and its time row."""
    import base64
    import re
    import threading

    app = load_helper("helpers/gradio_demo/app_torch.py")
    layers = cfg.decoder.num_hidden_layers
    pipe16 = dataclasses.replace(pipe, pcm16=True)
    calls = []

    class Recorder:
        """The pcm16 pipeline, recording each call the engine makes."""
        cfg, gen = pipe16.cfg, pipe16.gen

        def tts(self, descs, prompts, *, seed=0, max_seconds=None):
            out = pipe16.tts(descs, prompts, seed=seed, max_seconds=max_seconds)
            calls.append((list(descs), list(prompts), seed, max_seconds, out))
            return out

    requests = [dict(description=DESCRIPTIONS[i % 4], prompt=f"{_prompts(10)[i % 4]} {WORDS[i]}",
                     seed=str(SEED + i), max_seconds=str(seconds)) for i, seconds in enumerate(HTTP_REQUESTS)]

    def serve():
        engine = serving_mod.BatchingEngine(Recorder(), max_batch=8, batch_buckets=(1, 2, 4, 8),
                                            length_bucket_seconds=HTTP_LENGTH_BUCKETS)
        server = app.make_http_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            responses, failed = [None] * len(requests), []
            barrier = threading.Barrier(len(requests))

            def client(i):
                barrier.wait(timeout=60)
                try:
                    responses[i] = _http(f"{url}/api", requests[i])
                except Exception as e:  # re-raised below, on the main thread
                    failed.append(e)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            if failed:
                raise failed[0]
            if any(th.is_alive() for th in threads) or None in responses:
                raise AssertionError("a request to the demo server did not complete")
            kind, body, stats_s = _http(f"{url}/stats")
            return responses, json.loads(body), engine.stats(), kind, stats_s
        finally:
            server.shutdown()
            server.server_close()
            engine.shutdown()
            thread.join(timeout=60)

    replays = []

    def serve_and_replay():
        result = serve()
        for descs, prompts, seed, max_seconds, _ in calls:
            replays.append(pipe16.tts(descs, prompts, seed=seed, max_seconds=max_seconds))
        return result

    (responses, served_stats, stats, stats_kind, stats_s), launches, spy, err = counted(
        fa, layers, serve_and_replay, place="http serving", calls=lambda: len(calls) + len(replays))
    checks, rows = [], []
    for req, (kind, body, latency) in zip(requests, responses):
        call = next(c for c, (descs, prompts, *_) in enumerate(calls)
                    if (req["description"], req["prompt"]) in zip(descs, prompts))
        row = list(zip(calls[call][0], calls[call][1])).index((req["description"], req["prompt"]))
        sr, waves = replays[call]
        t0 = time.perf_counter()
        want = app.wav_bytes(waves[row], sr)
        wav_ms = 1e3 * (time.perf_counter() - t0)
        rate, frames = _wav_rate(body)
        checks.append(kind == "audio/wav" and rate == 44100 and frames > 0 and body == want)
        rows.append({"max_seconds": float(req["max_seconds"]), "latency_s": latency, "batch": call,
                     "audio_s": frames / rate, "wav_bytes_ms": wav_ms, "equal_to_direct_tts": body == want})
    batches = [{"rows": len(descs), "max_seconds": max_seconds, "seed": seed,
                "requests": sum(r["batch"] == c for r in rows)} for c, (descs, _, seed, max_seconds, _)
               in enumerate(calls)]
    pads = sum(b["rows"] - b["requests"] for b in batches)
    stats_ok = (stats_kind == "application/json" and served_stats == stats and stats["requests"] == len(requests)
                and stats["batches"] == len(calls) and stats["batched_requests"] == len(requests)
                and stats["bucket_rows"] == sum(b["rows"] for b in batches) and stats["padded_rows"] == pads)
    (args, kw, _) = next(iter(spy.captured.values()))
    k1 = {"kernel": "flash_attention_fwd", "path": "http serving prefill", **k1_row(fa, *args, kw)}
    emit({"phase": "k1_time", **k1})

    # the entry point in its own process, as a user starts it
    art = os.path.join(tmp, "artifact")
    t0 = time.perf_counter()
    ck.save_model(art, model, cfg, dataclasses.replace(pipe.gen, max_length=pipe.max_length(1.0)),
                  tokenizer=reader_mod.Tokenizer.from_pretrained(os.path.join(TOKENIZER_FIXTURES, "t5_unigram")))
    save_s = time.perf_counter() - t0
    log = os.path.join(tmp, "app_torch.log")
    with open(log, "w") as err_file:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, os.path.join(REPO, "helpers", "gradio_demo", "app_torch.py"), art,
                                 "--port", "0"], cwd=REPO, stdout=subprocess.PIPE, stderr=err_file, text=True)
        try:
            lines = []

            def read_stdout():
                for line in proc.stdout:
                    lines.append(line)

            threading.Thread(target=read_stdout, daemon=True).start()
            port = None
            started = re.compile(r"serving on http://0\.0\.0\.0:(\d+)")
            while port is None and time.perf_counter() - t0 < 600 and proc.poll() is None:
                time.sleep(0.2)
                port = next((m.group(1) for line in list(lines) if (m := started.search(line))), None)
            if port is None:
                raise AssertionError(f"app_torch.py did not start serving (rc {proc.poll()}): "
                                     + open(log).read()[-4000:])
            started_s = time.perf_counter() - t0
            fields = dict(description=DESCRIPTIONS[1], prompt=_prompts(10)[0], seed="3", max_seconds="0.25")
            api_kind, api_body, api_s = _http(f"http://127.0.0.1:{port}/api", fields)
            first_response_s = time.perf_counter() - t0
            page_kind, page, page_s = _http(f"http://127.0.0.1:{port}/", fields)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    api_rate, api_frames = _wav_rate(api_body)
    tags = re.findall(r'<audio controls src="data:audio/wav;base64,([A-Za-z0-9+/=]+)"></audio>', page.decode())
    page_rate, page_frames = _wav_rate(base64.b64decode(tags[0])) if len(tags) == 1 else (0, 0)
    entry_ok = (api_kind == "audio/wav" and api_rate == 44100 and api_frames > 0
                and page_kind == "text/html; charset=utf-8" and page_rate == 44100 and page_frames > 0)
    ok = all(checks) and stats_ok and entry_ok
    emit({"phase": "http_serving", "config": "mini_600m_config bf16 pcm16, random weights (seed 0), top-k 50",
          "card": card, "requests": rows, "batches": batches, "pad_rows": pads, "stats": stats,
          "stats_equal_recorder": stats_ok, "stats_request_s": stats_s, "k1_launches": launches,
          "k1_max_abs_err": err,
          "entry_point": {"artifact_save_s": save_s, "serving_after_s": started_s, "first_response_s": first_response_s,
                          "api_s": api_s, "page_s": page_s, "api_audio_s": api_frames / max(api_rate, 1),
                          "page_audio_s": page_frames / max(page_rate, 1), "ok": entry_ok},
          "ok": ok})
    if not ok:
        raise AssertionError("the demo server's answers are not the direct tts calls' WAVs, its counters are not "
                             f"the recorder's, or its entry point did not answer (see the http_serving line; {log})")
    return launches, err, k1


def encodec_mini_config(cfg_mod):
    """Mini with ``facebook/encodec_24khz``'s geometry as its codec (32
    filters, ratios 8/5/4/2, a 2-layer 512-wide LSTM, 32 codebooks of 1024 x
    128, 24 kHz, 75 frames/s) and the decoder over 8 of its codebooks, as the
    reference's EnCodec assembly."""
    cfg = cfg_mod.mini_600m_config()
    return dataclasses.replace(cfg, audio_encoder=cfg_mod.EncodecConfig(num_codebooks=8),
                               decoder=dataclasses.replace(cfg.decoder, num_codebooks=8))


# a small 48 kHz-style EnCodec: stereo, normalized, time group norm, non-causal,
# chunks of 0.2 s overlapping by 10 %
SMALL_CHUNKED_ENCODEC = dict(target_bandwidths=(1.5, 3.0), sampling_rate=4800, audio_channels=2, normalize=True,
                             chunk_length_s=0.2, overlap=0.1, hidden_size=32, num_filters=8,
                             upsampling_ratios=(4, 4, 2), norm_type="time_group_norm", use_causal_conv=False,
                             codebook_size=64)


def sine_waves(freqs, seconds: float, sr: int, seed: int) -> np.ndarray:
    """(len(freqs), seconds * sr) seeded tones with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.size)
                     for f in freqs]).astype(np.float32)


def check_encodec_reference(cfg_mod, parler, generate_mod, codec_mod) -> None:
    """Phase 3, EnCodec: ``dummy_config``'s decoder over 8 codebooks with
    ``facebook/encodec_24khz``'s codec, greedy at fp32, the card against the
    CPU: composite generation and ``generate(input_values=...)`` from two
    1 s waveforms must give the same tokens and waveforms within 1e-4.  Then
    ``SMALL_CHUNKED_ENCODEC``: ``encode_chunked`` of 1 s of stereo (codes,
    the last chunk's pad, scales within 1e-5 relative) and
    ``decode_chunked`` (within 1e-4)."""
    base = cfg_mod.dummy_config(num_codebooks=8)
    cfg = dataclasses.replace(base, audio_encoder=cfg_mod.EncodecConfig(num_codebooks=8))
    cpu_model = parler.init(SEED, cfg, device="cpu")
    zero_special_heads(cpu_model)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gen = cfg_mod.GenerationConfig(max_length=30, do_sample=False)
    rng = torch.Generator().manual_seed(SEED + 3)
    batch = dict(input_ids=torch.randint(3, 1000, (2, 11), generator=rng),
                 prompt_input_ids=torch.randint(3, 1000, (2, 9), generator=rng))
    waves = sine_waves((150.0, 230.0), 1.0, cfg.sampling_rate, SEED + 3)
    frames = -(-waves.shape[1] // cfg.audio_encoder.hop_length)
    cases = {"encodec composite": {}, "encodec generate(input_values)": dict(input_values=waves,
                                                                            max_length=frames + 30)}
    for case, extra in cases.items():
        ref = generate_mod.generate(cpu_model, gen, device="cpu", **batch, **extra)
        out = generate_mod.generate(gpu_model, gen, device="cuda", **batch, **extra)
        same_tokens = bool((out.tokens.cpu() == ref.tokens).all())
        audio_err = (out.audio.cpu() - ref.audio).abs().max().item()
        ok = same_tokens and audio_err <= 1e-4 and bool(torch.isfinite(out.audio).all())
        emit({"phase": "reference", "case": case, "config": "dummy_config + encodec_24khz (8 codebooks) fp32",
              "same_tokens": same_tokens, "code_lengths": out.code_lengths.tolist(), "max_abs_err_audio": audio_err,
              "tol_audio": 1e-4, "ok": ok})
        if not ok:
            raise AssertionError(f"the card and the CPU disagree on the small EnCodec composite ({case})")

    small = cfg_mod.EncodecConfig(**SMALL_CHUNKED_ENCODEC)
    cpu_codec = codec_mod.build(small)
    cpu_codec.reset_parameters(torch.Generator().manual_seed(SEED))
    gpu_codec = copy.deepcopy(cpu_codec).cuda()
    sr = small.sampling_rate
    stereo = torch.from_numpy(np.stack([sine_waves((170.0, 260.0), 1.0, sr, SEED + 4),
                                        sine_waves((120.0, 310.0), 1.0, sr, SEED + 5)]).transpose(0, 2, 1).copy())
    ref_codes, ref_scales, ref_pad = cpu_codec.encode_chunked(stereo, bandwidth=3.0)
    codes, scales, pad = gpu_codec.encode_chunked(stereo.cuda(), bandwidth=3.0)
    ref_wav = cpu_codec.decode_chunked(ref_codes, scales=ref_scales, last_frame_pad_length=ref_pad)
    wav = gpu_codec.decode_chunked(codes, scales=scales, last_frame_pad_length=pad).cpu()
    same = bool(torch.equal(codes.cpu(), ref_codes)) and pad == ref_pad > 0
    scale_err = ((scales.cpu() - ref_scales).abs() / ref_scales.abs()).max().item()
    wav_err = (wav - ref_wav).abs().max().item()
    ok = same and scale_err <= 1e-5 and wav_err <= 1e-4 and bool(torch.isfinite(wav).all())
    emit({"phase": "reference", "case": "encodec chunked 48 kHz-style", "config": SMALL_CHUNKED_ENCODEC,
          "chunks": int(codes.shape[0]), "codes": list(codes.shape), "same_codes": same, "last_frame_pad": pad,
          "max_rel_err_scales": scale_err, "max_abs_err_audio": wav_err, "tol_audio": 1e-4, "ok": ok})
    if not ok:
        raise AssertionError("the card and the CPU disagree on the chunked EnCodec")


def run_encodec(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod, generate_mod, codec_mod, data_mod,
                card: str) -> tuple[int, float, dict]:
    """Phase 5: ``encodec_mini_config`` (bf16, random weights from seed 0,
    special-id heads zeroed, top-k 50): two ``tts`` calls of 4 requests at
    2.5 s (prompt buckets 16 and 64), then one more with each phase timed
    (decode ms/step, EnCodec decode ms); ``generate(input_values=...)``
    continuing two seeded 2 s 24 kHz waveforms (batch 2, CFG 3.0, 2.5 s of
    new audio), its prefill's K1 timed; each path with K1 once per layer per
    prefill, held against its plain version.  Then the EnCodec encode side
    at fp32 (``run_codec_encode``).  Returns K1's launches, its largest
    error held and its time row."""
    cfg = encodec_mini_config(cfg_mod)
    model = parler.init(SEED, cfg, device="cuda", dtype=torch.bfloat16)
    zero_special_heads(model)
    tok = tokenizer_mod.ToyTokenizer(vocab_size=cfg.vocab_size)
    pipe = pipeline_mod.ParlerTTSPipeline(model, cfg, cfg_mod.GenerationConfig(do_sample=True, top_k=50), tok, tok,
                                          dtype=torch.bfloat16)
    layers, hop, sr = cfg.decoder.num_hidden_layers, cfg.audio_encoder.hop_length, cfg.sampling_rate
    calls = []

    def tts_calls():
        for i, n_words in enumerate((10, 50)):
            (rate, wavs), wall = sync_time(lambda: pipe.tts(DESCRIPTIONS, _prompts(n_words), seed=SEED + i,
                                                            max_seconds=2.5))
            if not all(w.ndim == 1 and w.size and w.size % hop == 0 and np.isfinite(w).all() for w in wavs):
                raise AssertionError(f"EnCodec tts gave a bad waveform: {[w.shape for w in wavs]}")
            calls.append({"requests": len(wavs), "samples": [int(w.size) for w in wavs], "sampling_rate": rate,
                          "wall_s": wall, "audio_s_per_wall_s": sum(w.size for w in wavs) / rate / wall})
    _, tts_launches, _, tts_err = counted(fa, layers, tts_calls, place="encodec tts", calls=2)
    timings = time_phases(model, pipe, _prompts(50), 2.5)

    waves = sine_waves((140.0, 220.0), 2.0, sr, SEED + 6)
    codes, encode_s = sync_time(lambda: codec_mod.encode(model.audio_encoder, torch.from_numpy(waves).cuda()))
    frames = codes.shape[2]
    gen = dataclasses.replace(pipe.gen, guidance_scale=3.0)
    max_length = frames + pipe.max_length(2.5)
    ids = pipe.tokenize(DESCRIPTIONS[:2], _prompts(10)[:2])
    (out, wall), cont_launches, spy, cont_err = counted(fa, layers, lambda: sync_time(
        lambda: generate_mod.generate(model, gen, input_values=waves, max_length=max_length,
                                      generator=torch.Generator(device="cuda").manual_seed(SEED), **ids)),
        place="encodec generate(input_values)")
    kept = (bool((out.codes[:, :, :frames] == codes).all()) and bool(torch.isfinite(out.audio).all())
            and int(out.code_lengths.min()) > frames)
    (args, kw, _), = spy.captured.values()
    k1 = {"kernel": "flash_attention_fwd", "path": "encodec generate(input_values) prefill", **k1_row(fa, *args, kw)}
    emit({"phase": "k1_time", **k1})
    summary = {"config": "mini_600m_config + encodec_24khz (decoder over 8 codebooks) bf16, random weights (seed 0)",
               "card": card, "max_seconds": 2.5, "tts_calls": calls, **timings,
               "continuation": {"batch": 2, "cfg": 3.0, "prompt_frames": frames, "max_length": max_length,
                                "prefill_T": ids["prompt_input_ids"].shape[1] + 1 + frames, "wall_s": wall,
                                "code_lengths": out.code_lengths.tolist(), "encodec_encode_s": encode_s,
                                "prompt_codes_kept": kept},
               "k1_launches": tts_launches + cont_launches, "k1_max_abs_err": max(tts_err, cont_err),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               # whether the bf16 vocoder's LSTM could take cuDNN's RNN (else PyTorch's own cells)
               "cudnn_accepts_bf16": torch.backends.cudnn.is_acceptable(
                   torch.empty(1, dtype=torch.bfloat16, device="cuda"))}
    emit({"phase": "encodec", **summary, "ok": kept})
    if not kept:
        raise AssertionError("EnCodec generate(input_values) lost its audio prompt or gave non-finite audio")
    del model, pipe
    torch.cuda.empty_cache()
    run_codec_encode(cfg.audio_encoder, "encodec_24khz", codec_mod, data_mod, card)
    return tts_launches + cont_launches, max(tts_err, cont_err), k1


def reference_tensors(model) -> dict[str, torch.Tensor]:
    """The reverse of the import map, a fixture: a port Mini model's
    tensors (on the CPU) under the reference checkpoint's names, the DAC
    nested under ``audio_encoder.model.*`` as the reference's DAC wrapper
    nests it, with HF ``DacModel`` names and every conv as ``weight_g`` /
    ``weight_v`` (v = w; g = ||w|| over every dimension but 0, stored in
    float64 so that the import's float64 fold gives w back bit for bit)."""
    import re

    sd = {name: t.detach().cpu() for name, t in model.state_dict().items()}
    cfg, out = model.cfg, {}

    def lin(ours: str, theirs: str) -> None:
        out[f"{theirs}.weight"] = sd[ours].T.contiguous()

    def weight_norm(theirs: str, w: torch.Tensor) -> None:
        out[f"{theirs}.weight_g"] = w.double().square().sum(dim=(1, 2), keepdim=True).sqrt()
        out[f"{theirs}.weight_v"] = w.contiguous()

    out["text_encoder.shared.weight"] = sd["text_encoder.token_embed.embedding"]
    out["text_encoder.encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = sd[
        "text_encoder.rel_attn_bias.embedding"]
    out["text_encoder.encoder.final_layer_norm.weight"] = sd["text_encoder.final_ln.scale"]
    for i in range(cfg.text_encoder.num_layers):
        b, p = f"text_encoder.encoder.block.{i}", f"text_encoder.layers.{i}"
        for proj in "qkvo":
            lin(f"{p}.attn.{proj}.kernel", f"{b}.layer.0.SelfAttention.{proj}")
        for w in ("wi_0", "wi_1", "wo"):
            lin(f"{p}.ffn.{w}.kernel", f"{b}.layer.1.DenseReluDense.{w}")
        out[f"{b}.layer.0.layer_norm.weight"] = sd[f"{p}.ln_attn.scale"]
        out[f"{b}.layer.1.layer_norm.weight"] = sd[f"{p}.ln_ffn.scale"]
    d = "decoder.model.decoder"
    for k in range(cfg.decoder.num_codebooks):
        out[f"{d}.embed_tokens.{k}.weight"] = sd["decoder.embed_tokens.embedding"][k]
        out[f"decoder.lm_heads.{k}.weight"] = sd["decoder.lm_heads.kernel"][k].T.contiguous()
    for i in range(cfg.decoder.num_hidden_layers):
        b, p = f"{d}.layers.{i}", f"decoder.layers.{i}"
        for ours, theirs in (("self_attn", "self_attn"), ("cross_attn", "encoder_attn")):
            for proj, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
                lin(f"{p}.{ours}.{proj}.kernel", f"{b}.{theirs}.{name}")
        for ours, theirs in (("ln_self", "self_attn_layer_norm"), ("ln_cross", "encoder_attn_layer_norm"),
                             ("ln_ffn", "final_layer_norm")):
            out[f"{b}.{theirs}.weight"], out[f"{b}.{theirs}.bias"] = sd[f"{p}.{ours}.scale"], sd[f"{p}.{ours}.bias"]
        lin(f"{p}.fc1.kernel", f"{b}.fc1")
        lin(f"{p}.fc2.kernel", f"{b}.fc2")
    out[f"{d}.layer_norm.weight"] = sd["decoder.final_ln.scale"]
    out[f"{d}.layer_norm.bias"] = sd["decoder.final_ln.bias"]
    out["embed_prompts.weight"] = sd["embed_prompts.embedding"]
    lin("enc_to_dec_proj.kernel", "enc_to_dec_proj")
    out["enc_to_dec_proj.bias"] = sd["enc_to_dec_proj.bias"]
    renames = ((".conv_in.", ".conv1."), (".blocks.", ".block."), (".snake_out.", ".snake1."),
               (".conv_out.", ".conv2."), (".conv_down.", ".conv1."), (".conv_up.", ".conv_t1."),
               (".snake.", ".snake1."))
    for name, t in sd.items():
        if not name.startswith("audio_encoder.") or name.startswith("audio_encoder.quantizer."):
            continue
        theirs = "." + name.removeprefix("audio_encoder.")
        for a, b in renames:
            theirs = theirs.replace(a, b)
        theirs = "audio_encoder.model" + re.sub(r"\.res(\d)\.", r".res_unit\1.", theirs)
        if name.endswith(".weight"):
            weight_norm(theirs.removesuffix(".weight"), t)
        else:
            out[theirs] = t.reshape(1, -1, 1) if name.endswith(".alpha") else t
    q = sd["audio_encoder.quantizer.codebooks"]
    for k in range(q.shape[0]):
        base = f"audio_encoder.model.quantizer.quantizers.{k}"
        out[f"{base}.codebook.weight"] = q[k]
        for proj in ("in_proj", "out_proj"):
            weight_norm(f"{base}.{proj}", sd[f"audio_encoder.quantizer.{proj}.kernel"][k].T[:, :, None])
            out[f"{base}.{proj}.bias"] = sd[f"audio_encoder.quantizer.{proj}.bias"][k]
    return out


SAFETENSORS_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
                      torch.int64: "I64"}


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> int:
    """A minimal ``.safetensors`` writer (the card's machine has no
    ``safetensors`` package): an 8-byte little-endian header length, the
    JSON header padded to 8 bytes, then each tensor's bytes, widest dtype
    first so that every tensor is aligned.  Returns the file's bytes."""
    names = sorted(tensors, key=lambda n: -tensors[n].element_size())
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name in names:
        t = tensors[name]
        header[name] = {"dtype": SAFETENSORS_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + t.numel() * t.element_size()]}
        offset += t.numel() * t.element_size()
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name in names:
            f.write(tensors[name].contiguous().view(torch.uint8).numpy())
    return 8 + len(blob) + offset


def t5_config_json(te) -> dict:
    """An HF ``T5Config``'s fields for the text encoder ``te``."""
    return {"model_type": "t5", "vocab_size": te.vocab_size, "d_model": te.d_model, "d_kv": te.d_kv,
            "d_ff": te.d_ff, "num_layers": te.num_layers, "num_heads": te.num_heads,
            "relative_attention_num_buckets": te.relative_attention_num_buckets,
            "relative_attention_max_distance": te.relative_attention_max_distance,
            "layer_norm_epsilon": te.layer_norm_epsilon, "feed_forward_proj": "gated-gelu",
            "dense_act_fn": te.dense_act_fn, "is_gated_act": te.is_gated_act, "dropout_rate": te.dropout_rate}


def write_hf_encoders(tensors: dict[str, torch.Tensor], cfg, t5_dir: str, dac_dir: str) -> int:
    """A reference directory's T5 encoder and DAC (``reference_tensors``)
    as the two HF-format directories a user downloads: a
    ``T5EncoderModel`` (``text_encoder.`` stripped; with the T5-shaped
    tokenizer fixture beside it) and a ``DacModel`` (``audio_encoder.model.``
    stripped), each a ``config.json`` and a ``model.safetensors`` from
    ``write_safetensors``.  Returns the files' bytes."""
    ac = cfg.audio_encoder
    dac_config = {"model_type": "dac", "n_codebooks": ac.num_codebooks, "codebook_size": ac.codebook_size,
                  "codebook_dim": ac.codebook_dim, "hidden_size": ac.latent_dim, "sampling_rate": ac.sampling_rate,
                  "encoder_hidden_size": ac.encoder_hidden_size, "downsampling_ratios": list(ac.downsampling_ratios),
                  "decoder_hidden_size": ac.decoder_hidden_size, "upsampling_ratios": list(ac.upsampling_ratios),
                  "hop_length": ac.hop_length}
    nbytes = 0
    for path, prefix, config in ((t5_dir, "text_encoder.", t5_config_json(cfg.text_encoder)),
                                 (dac_dir, "audio_encoder.model.", dac_config)):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
        nbytes += write_safetensors(os.path.join(path, "model.safetensors"), {
            name.removeprefix(prefix): t for name, t in tensors.items() if name.startswith(prefix)})
    shutil.copytree(os.path.join(TOKENIZER_FIXTURES, "t5_unigram"), t5_dir, dirs_exist_ok=True)
    return nbytes


def load_helper(path: str):
    """A script of the repository (``helpers/...``) as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(os.path.basename(path).removesuffix(".py"), os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_reference_dir(path: str, model) -> int:
    """A reference-format Parler-TTS directory of ``model`` (Mini): nested
    ``config.json`` (a T5 config, the reference's DAC wrapper fields and the
    DAC's geometry, the decoder's fields), Mini's ``generation_config.json``, and its tensors
    (``reference_tensors``) in two safetensors shards behind an index.
    Returns the shards' bytes."""
    cfg = model.cfg
    ac, dc = cfg.audio_encoder, cfg.decoder
    config = {
        "model_type": "parler_tts", "vocab_size": cfg.vocab_size, "text_encoder": t5_config_json(cfg.text_encoder),
        "audio_encoder": {"model_type": "dac", **{k: getattr(ac, k) for k in (
            "num_codebooks", "model_bitrate", "codebook_size", "codebook_dim", "latent_dim", "frame_rate",
            "sampling_rate", "encoder_hidden_size", "downsampling_ratios", "decoder_hidden_size",
            "upsampling_ratios")}},
        "decoder": {"model_type": "parler_tts_decoder", **{k: getattr(dc, k) for k in (
            "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads", "ffn_dim", "num_codebooks",
            "max_position_embeddings", "activation_function", "scale_embedding", "pad_token_id", "bos_token_id",
            "eos_token_id")}},
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"max_length": 2580, "do_sample": True, "bos_token_id": dc.bos_token_id,
                   "pad_token_id": dc.pad_token_id, "eos_token_id": dc.eos_token_id,
                   "decoder_start_token_id": dc.bos_token_id}, f)
    tensors = reference_tensors(model)
    names = list(tensors)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    nbytes = sum(write_safetensors(os.path.join(path, fname), {n: tensors[n] for n in part})
                 for fname, part in shards.items())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": nbytes},
                   "weight_map": {n: fname for fname, part in shards.items() for n in part}}, f)
    return nbytes


def run_reference_import(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod, from_reference, ck, card: str,
                         tmp: str) -> tuple[int, float]:
    """Phase 6: a seeded random Mini written as a reference checkpoint
    directory in ``tmp`` (``write_reference_dir``), loaded by
    ``from_reference_pretrained`` on the card at fp32 (load s, GB/s): its
    config must be the source's and every tensor the source's bit for bit.
    Both then cast to bf16 and serve one ``tts`` call of 4 requests at 2.5 s
    with one generator seed (special-id heads zeroed, top-k 50): the loaded
    model's call launches K1 once per layer, held against its plain version,
    and its tokens must be the source's.  Then
    ``helpers/convert_reference_checkpoint_torch.py`` writes a port artifact,
    which ``from_pretrained`` serves with the same tokens.  Before the
    directory goes: ``helpers/quality_gate_torch.py`` runs on it
    (86 positions, the gate's default, so that its stream check holds the
    frames short of the last lookback window; each gate's line; the gate
    must pass; K1 once per layer per prefill); the
    source's T5 and DAC are written as HF-format directories
    (``write_hf_encoders``), ``init_model_600M_torch.py`` builds a fresh
    Mini artifact over them (its T5 and DAC tensors must be the source's bit
    for bit, the tokenizer bundled), and ``from_pretrained`` of it serves
    one ``tts`` with its own tokenizer.  Returns K1's launches and its
    largest error held."""
    cfg = cfg_mod.mini_600m_config()
    layers = cfg.decoder.num_hidden_layers
    source = parler.init(SEED + 7, cfg, device="cuda")
    ref_dir, art_dir = os.path.join(tmp, "reference"), os.path.join(tmp, "artifact")
    _, write_s = sync_time(lambda: write_reference_dir(ref_dir, source))
    nbytes = sum(os.path.getsize(os.path.join(ref_dir, f)) for f in os.listdir(ref_dir) if f.endswith(".safetensors"))
    (model, loaded_cfg, gen), load_s = sync_time(lambda: from_reference.from_reference_pretrained(ref_dir,
                                                                                                 device="cuda"))
    mine, theirs = model.state_dict(), source.state_dict()
    equal = set(mine) == set(theirs) and all(torch.equal(mine[k], theirs[k]) for k in theirs)
    tok = tokenizer_mod.ToyTokenizer(vocab_size=cfg.vocab_size)
    gen = dataclasses.replace(gen, top_k=50)  # the main path's sampler
    tokens = {}
    real_generate = pipeline_mod.generate

    def serve(name, pipe):
        zero_special_heads(pipe.model)
        pipe.gen = gen
        pipeline_mod.generate = lambda *a, **kw: tokens.setdefault(name, real_generate(*a, **kw))
        try:
            (_, wavs), wall = sync_time(lambda: pipe.tts(DESCRIPTIONS, _prompts(10), seed=SEED, max_seconds=2.5))
        finally:
            pipeline_mod.generate = real_generate
        if not all(w.size and np.isfinite(w).all() for w in wavs):
            raise AssertionError(f"{name} gave empty or non-finite audio")
        return wall

    def pipeline(m):
        return pipeline_mod.ParlerTTSPipeline(m, cfg, gen, tok, tok, dtype=torch.bfloat16)

    encoders = {part: {k: v.cpu().clone() for k, v in getattr(source, part).state_dict().items()}
                for part in ("text_encoder", "audio_encoder")}
    t5_dir, dac_dir = os.path.join(tmp, "flan_t5"), os.path.join(tmp, "dac")
    hf_bytes = write_hf_encoders(reference_tensors(source), cfg, t5_dir, dac_dir)
    tts_s, launches, _, err = counted(fa, layers, lambda: serve("loaded", pipeline(model)),
                                      place="reference_import tts")
    serve("source", pipeline(source))
    del model, source
    torch.cuda.empty_cache()
    convert = load_helper("helpers/convert_reference_checkpoint_torch.py")
    _, convert_s = sync_time(lambda: convert.main([ref_dir, art_dir, "--device", "cuda"]))
    artifact, artifact_load_s = sync_time(lambda: pipeline_mod.ParlerTTSPipeline.from_pretrained(
        art_dir, tokenizer=tok, dtype=torch.bfloat16))
    serve("artifact", artifact)
    del artifact
    torch.cuda.empty_cache()
    same = {name: bool(torch.equal(tokens[name].tokens, tokens["source"].tokens)) for name in ("loaded", "artifact")}

    # the port's quality gate on the reference directory
    gate_mod = load_helper("helpers/quality_gate_torch.py")
    box = {}

    def gate():
        box["report"] = gate_mod.run_quality_gate(ref_dir, tokenizer_name=t5_dir, device="cuda")
        return box["report"]

    def gate_prefills():  # fp32, serving and stream generations; the engine's batches and their direct replay
        engine = box["report"]["gates"]["serving_engine_vs_direct"]
        return 3 + (engine["batches"] + 1 if engine.get("ran") else 0)

    (report, gate_s), gate_launches, _, gate_err = counted(fa, layers, lambda: sync_time(gate),
                                                           place="quality gate", calls=gate_prefills)
    for name, verdict in report["gates"].items():
        emit({"phase": "quality_gate", "gate": name, **verdict})

    # a fresh Mini artifact over the HF-format T5 and DAC directories
    init_dir = os.path.join(tmp, "init_600m")
    init = load_helper("helpers/model_init_scripts/init_model_600M_torch.py")
    _, init_s = sync_time(lambda: init.main([init_dir, "--text-encoder", t5_dir, "--dac", dac_dir, "--seed",
                                             str(SEED + 8)]))
    weights = torch.load(os.path.join(init_dir, ck.WEIGHTS_FILE), map_location="cpu", weights_only=True, mmap=True)
    encoders_exact = all(set(k for k in weights if k.startswith(part + ".")) == {f"{part}.{k}" for k in want}
                         and all(torch.equal(weights[f"{part}.{k}"], v) for k, v in want.items())
                         for part, want in encoders.items())
    del weights
    init_pipe = pipeline_mod.ParlerTTSPipeline.from_pretrained(init_dir, dtype=torch.bfloat16)  # its own tokenizer
    zero_special_heads(init_pipe.model)
    ((_, init_wavs), init_tts_s), init_launches, _, init_err = counted(
        fa, layers, lambda: sync_time(lambda: init_pipe.tts(DESCRIPTIONS[:2], _prompts(10)[:2], seed=SEED,
                                                            max_seconds=1.0)), place="init_model_600M artifact tts")
    if not all(w.size and np.isfinite(w).all() for w in init_wavs):
        raise AssertionError("the init script's artifact gave empty or non-finite audio")
    del init_pipe
    torch.cuda.empty_cache()
    summary = {"config": "mini_600m_config fp32 -> bf16, random weights (seed 7)", "card": card,
               "safetensors_gb": nbytes / 1e9, "write_s": write_s, "load_s": load_s,
               "load_gb_per_s": nbytes / 1e9 / load_s,
               "config_equal": loaded_cfg == cfg, "tensors": len(theirs), "tensors_bit_exact": equal,
               "tts_wall_s": tts_s, "k1_launches": launches, "k1_max_abs_err": err, "same_tokens_as_source": same,
               "code_lengths": tokens["loaded"].code_lengths.tolist(), "convert_s": convert_s,
               "artifact_load_s": artifact_load_s,
               "quality_gate": {"pass": report["pass"], "wall_s": gate_s, "k1_launches": gate_launches,
                                "k1_max_abs_err": gate_err},
               "init_600m": {"hf_gb": hf_bytes / 1e9, "init_s": init_s, "t5_dac_bit_exact": encoders_exact,
                             "tokenizer_bundled": os.path.exists(os.path.join(init_dir, "tokenizer.json")),
                             "tts_wall_s": init_tts_s, "samples": [int(w.size) for w in init_wavs],
                             "k1_launches": init_launches, "k1_max_abs_err": init_err}}
    ok = (equal and loaded_cfg == cfg and all(same.values()) and report["pass"] and encoders_exact
          and summary["init_600m"]["tokenizer_bundled"])
    emit({"phase": "reference_import", **summary, "ok": ok})
    if not ok:
        raise AssertionError("the reference checkpoint did not load as its source, its quality gate failed or the "
                             "init script's artifact is not as it should be (see the reference_import line)")
    return launches + gate_launches + init_launches, max(err, gate_err, init_err)


@contextlib.contextmanager
def timed_decode(generate_mod):
    """Each decode loop of ``generate_mod`` (``_decode``, over the captured
    or the eager steps) with every segment synchronised and host-timed:
    yields a list that gets, per loop, a list of (ms, steps) per segment.
    Replays bypass ``ParlerDecoder.decode_step``, so segments are what can
    be timed; a segment's steps are its own, masked ones included."""
    loops: list[list[tuple[float, int]]] = []
    real = generate_mod._decode

    def timed(s, end, segment):
        spans = []
        loops.append(spans)

        def run(size, t_hi, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            segment(size, t_hi, n)
            torch.cuda.synchronize()
            spans.append((1e3 * (time.perf_counter() - t0), n))

        return real(s, end, run)

    generate_mod._decode = timed
    try:
        yield loops
    finally:
        generate_mod._decode = real


def time_phases(model, pipe, prompts, max_seconds, out: list | None = None) -> dict:
    """One more tts call with each phase synchronised and host-timed: the
    captured prefill (T5 encode, prompt, decoder prefill: a replay, or the
    warm-up and capture of a new shape), the T5 encode and decoder prefill
    where they run eagerly (not under a capture; not at all in a replay),
    the decode loop segment by segment (ms/step: the loop's time over its
    steps; the median over its segments), DAC vocode.  The call's result is
    appended to ``out`` when given."""
    from parler_tts_tpu_torch.generation import generate as generate_mod

    spans: dict[str, list[float]] = {"encode": [], "prefill": [], "captured_prefill": [], "vocode": []}
    targets = {"encode": (model, "encode_text"), "prefill": (model.decoder, "forward"),
               "vocode": (model.audio_encoder, "decode")}
    replays = counter("prefill.replays")

    def timed(name, fn):
        def run(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name].append(1e3 * (time.perf_counter() - t0))
            return result
        return run

    for name, (obj, attr) in targets.items():
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    real_prefill = generate_mod._captured_prefill
    generate_mod._captured_prefill = timed("captured_prefill", real_prefill)
    try:
        with timed_decode(generate_mod) as loops:
            t0 = time.perf_counter()
            result = pipe.tts(DESCRIPTIONS, prompts, seed=SEED, max_seconds=max_seconds)
            wall = time.perf_counter() - t0
        if out is not None:
            out.append(result)
    finally:
        generate_mod._captured_prefill = real_prefill
        for obj, attr in targets.values():
            delattr(obj, attr)
    segments = [span for loop in loops for span in loop]
    steps = sum(n for _, n in segments)
    return {"captured_prefill_ms": sum(spans["captured_prefill"]),
            "prefill_replayed": counter("prefill.replays") > replays,
            "encode_ms": sum(spans["encode"]), "prefill_ms": sum(spans["prefill"]),
            "decode_steps": steps, "decode_ms_per_step": sum(ms for ms, _ in segments) / steps,
            "decode_ms_per_step_median": sorted(ms / n for ms, n in segments)[len(segments) // 2],
            "vocode_ms": sum(spans["vocode"]), "synced_wall_s": wall}


# -- phase 12: several processes ---------------------------------------------------------------

MP_SEED = 42
MP_STEPS = 3
MP_ARGV = ["--train_dataset_name", "synthetic://12", "--max_steps", str(MP_STEPS), "--logging_steps", "1",
           "--save_steps", "0", "--warmup_steps", "1"]
# a run's losses may stand this far from the single-process run's, at least:
# the larger of MP_SPREAD_FACTOR x the single-process run's own run-to-run
# spread (K4's dq is summed by atomics) and MP_GAP_FLOOR (see PERF.md)
MP_SPREAD_FACTOR = 4.0
MP_GAP_FLOOR = 2e-3
MP_NORM_FLOOR = 2e-3  # the same on gradient norms, relative
MP_GEN_LEN = 40  # greedy positions of the model=2 generation, fp32
MP_CHUNK = 12  # stream chunk frames over the split model: 40 positions give 3 chunks
MP_ENGINE_SECONDS = 0.25  # the split engine's requests (30 positions)
MP_TIMEOUT = 300  # seconds for one torch.distributed.run launch


def mp_generate_inputs(cfg) -> dict:
    """Two requests for the model=2 generation check, drawn from a seed:
    right-padded descriptions, left-padded prompts."""
    rng = np.random.default_rng(MP_SEED)
    ids = rng.integers(3, cfg.text_encoder.vocab_size, (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    pids = rng.integers(3, cfg.vocab_size, (2, 8))
    pmask = np.ones((2, 8), np.int32)
    pmask[0, :3] = 0
    return dict(input_ids=ids, attention_mask=mask, prompt_input_ids=pids, prompt_attention_mask=pmask)


def mp_generation(generate_mod, model, gen) -> torch.Tensor:
    """Greedy tokens of ``model`` (split or not) on the check's inputs."""
    greedy = dataclasses.replace(gen, max_length=MP_GEN_LEN, do_sample=False)
    return generate_mod.generate(model, greedy, **mp_generate_inputs(model.cfg), vocode=False,
                                 device="cuda").tokens.cpu()


def hold_sharded_shape(fa, heads: int) -> dict[str, float]:
    """K1 and K4 on random bf16 tensors at the 3 x 10 s training shape with
    this rank's ``heads`` (BH = 3 * heads, T = 903, one left-padded row),
    against their plain versions; the largest error of each."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    b, t, d = 3, 903, 64
    q, k, v, do = (torch.randn((b * heads, t, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    kv_mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    kv_mask[0, :20] = 0
    start, end = fa.kv_bounds(kv_mask, b, heads, t, q.device)
    kw = dict(scale=0.125, causal=True, q_offset=0)
    meta = {"shape": [b, heads, t, d], "kind": "multiprocess, this rank's heads"}
    out, lse = fa.flash_attention_fwd(q, k, v, start, end, **kw)
    k1 = check_k1(fa, q, k, v, start, end, out, lse, kw, meta)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta, start, end)
    k4 = check_bwd("flash_attention_dqkv", fa.flash_attention_dqkv(*args, **kw), fa.flash_dqkv_plain(*args, **kw),
                   torch.bfloat16, meta)
    return {"flash_attention_fwd": k1, "flash_attention_dqkv": k4}


def int8_view_mismatches(split, full, index: int, size: int) -> tuple[int, list[str]]:
    """This model rank's int8 decode view against the slices of the
    unsplit model's, bit for bit: the column-split fused qkv projection by
    projection, cross q and fc1 by columns, the row-split o, cross o and fc2
    by rows with their whole scales, the LM heads by vocabulary.  Every
    model rank calls it together (the row-split scales are a collective).
    Returns the kernels compared and the names of those that differ."""
    mine, theirs = split.decoder.decode_params(True), full.decoder.decode_params(True)

    def cols(t, dim=-1):
        n = t.shape[dim] // size
        return t.narrow(dim, index * n, n)

    def want(name, w):
        if name == "qkv":
            return [torch.cat([cols(p) for p in x.chunk(3, dim=-1)], dim=-1) for x in (w.kernel, w.scale)]
        if name in ("o", "cross_o", "fc2"):
            return [cols(w.kernel, 0), w.scale]
        return [cols(w.kernel), cols(w.scale)]

    pairs = [(f"layers.{i}.{name}", getattr(a, name), getattr(b, name))
             for i, (a, b) in enumerate(zip(mine.layers, theirs.layers)) for name in a._fields]
    pairs.append(("lm_heads", mine.lm_heads, theirs.lm_heads))
    bad = [key for key, got, full_w in pairs
           if not all(torch.equal(g, w) for g, w in zip((got.kernel, got.scale), want(key.rsplit(".", 1)[-1], full_w)))]
    return len(pairs), bad


def split_inference(spec: dict, fa, model, gen, mesh, work: str, greedy_tokens: torch.Tensor) -> dict:
    """Phase 12's rest of the inference surface over the split model, on
    every model rank in lockstep: (a) int8 weights and int8 KV cache,
    greedy, fp32 compute, batch 2 (tokens; the int8 view against the
    unsplit one's slices; the cache's bytes on this rank); (b)
    ``stream_generate`` in chunks of ``MP_CHUNK`` frames (codes against the
    split greedy ``generate``'s ``greedy_tokens``; each chunk written to
    ``work`` for the parent);
    (c) ``BatchingEngine`` over a bf16 pipeline of the split model: rank 0
    takes a warmup and a burst of 4 requests from threads, rank 1
    ``follow()``s, and every rank replays each batch as a direct ``tts``.
    K1 once per layer per prefill in each, held against its plain version
    (phase 2 times it at these shapes).  The model is cast to bf16 at the
    end."""
    import threading

    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.generation import generate as generate_mod
    from parler_tts_tpu_torch.generation import streaming as streaming_mod
    from parler_tts_tpu_torch.models.delay_pattern import undelay_pattern
    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.serving import BatchingEngine
    from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer

    cfg, layers, rank = model.cfg, model.cfg.decoder.num_hidden_layers, mesh.model_index
    greedy = dataclasses.replace(gen, max_length=MP_GEN_LEN, do_sample=False)
    out = {}

    # (a) int8 weights and the int8 KV cache
    caches, real_init = [], generate_mod.init_cache

    def keep_cache(*args, **kw):
        caches.append(real_init(*args, **kw))
        return caches[-1]

    generate_mod.init_cache = keep_cache
    try:
        tokens, launches, _, err = counted(fa, layers, lambda: mp_generation(generate_mod, model, dataclasses.replace(
            gen, int8_weights=True, kv_cache_dtype="int8")), place="model=2 int8")
    finally:
        generate_mod.init_cache = real_init
    full, _, _ = ck.load_model(spec["artifact"], device="cuda")
    compared, mismatched = int8_view_mismatches(model, full, rank, mesh.model)
    del full
    torch.cuda.empty_cache()
    (cache,) = caches
    out["int8"] = {"tokens": tokens.tolist(), "kv_bytes": cache.nbytes, "kv_heads": cache.self_k.shape[2],
                   "kv_dtype": str(cache.self_k.dtype), "view_compared": compared, "view_mismatched": mismatched,
                   "k1_launches": launches, "k1_max_abs_err": err}

    # (b) the stream, against the split generate's codes
    ids = mp_generate_inputs(cfg)
    chunks, launches, _, err = counted(fa, layers, lambda: list(streaming_mod.stream_generate(
        model, greedy, chunk_frames=MP_CHUNK, lookback=48, device="cuda", **ids)), place="model=2 stream")
    codes = np.concatenate([c.codes for c in chunks], axis=2)
    np.savez(os.path.join(work, f"stream_r{rank}.npz"), codes=codes,
             audio=np.concatenate([c.audio for c in chunks], axis=1),
             offsets=np.array([c.frame_offset for c in chunks]), lengths=chunks[-1].valid_lengths)
    offline = undelay_pattern(greedy_tokens[:, :, 1:]).numpy()[:, :, :codes.shape[2]]
    out["stream"] = {"chunks": len(chunks), "codes_equal_generate": bool(np.array_equal(codes, offline)),
                     "k1_launches": launches, "k1_max_abs_err": err}

    # (c) the batching engine: rank 0 leads, the other ranks follow
    with torch.no_grad():  # the special ids' LM-head columns of this rank's vocabulary shard, as zero_special_heads
        heads = model.decoder.lm_heads.kernel
        heads[..., max(cfg.audio_encoder.codebook_size - rank * heads.shape[-1], 0):] = 0
    tok = ToyTokenizer(vocab_size=cfg.vocab_size)
    pipe = ParlerTTSPipeline(model, cfg, dataclasses.replace(gen, top_k=50), tok, tok, dtype=torch.bfloat16)
    calls, direct = [], pipe.tts

    def recorded(descs, prompts, *, seed=0, max_seconds=None):
        result = direct(descs, prompts, seed=seed, max_seconds=max_seconds)
        calls.append((list(descs), list(prompts), seed, max_seconds, result[1]))
        return result

    pipe.tts = recorded
    replays = []

    def serve():
        engine = BatchingEngine(pipe, max_batch=4, max_wait_ms=200.0, batch_buckets=(2, 4),
                                length_bucket_seconds=(MP_ENGINE_SECONDS,))
        if engine.following:
            stats, latency = engine.follow(), None
        else:
            try:
                engine.warmup(description=DESCRIPTIONS[3], prompt=_prompts(10)[0], batch_buckets=(2,), timeout=600)
                latency, failed = [None] * 4, []
                barrier = threading.Barrier(4)

                def client(i):
                    barrier.wait(timeout=60)
                    t0 = time.perf_counter()
                    try:
                        engine.tts(DESCRIPTIONS[i], _prompts(10)[i], max_seconds=MP_ENGINE_SECONDS, seed=SEED + i,
                                   timeout=600)
                    except Exception as e:  # re-raised below, on the main thread
                        failed.append(e)
                        return
                    latency[i] = time.perf_counter() - t0

                threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=900)
                if failed:
                    raise failed[0]
            finally:
                engine.shutdown()
            stats = engine.stats()
        for descs, prompts, seed, max_seconds, _ in calls[:]:
            replays.append(direct(descs, prompts, seed=seed, max_seconds=max_seconds)[1])
        return stats, latency, engine.following

    (stats, latency, following), launches, _, err = counted(fa, layers, serve, place="model=2 engine",
                                                              calls=lambda: len(calls) + len(replays))
    equal = [all(np.array_equal(a, b) for a, b in zip(call[4], replay)) for call, replay in zip(calls, replays)]
    out["engine"] = {"following": following, "stats": stats, "latency_s": latency,
                     "batches": [{"rows": len(c[0]), "seed": c[2], "max_seconds": c[3],
                                  "descs_md5": hashlib.md5(json.dumps(c[:2]).encode()).hexdigest()} for c in calls],
                     "bit_equal_direct_tts": equal, "k1_launches": launches, "k1_max_abs_err": err}
    return out


def multiprocess_worker(spec_path: str) -> int:
    """One rank of phase 12, started by ``torch.distributed.run``: joins gloo
    on this card when the spec says so (``run_training.main`` joins NCCL
    itself from torchrun's variables otherwise), runs ``run_training.main``
    with its kernel launches counted per step and K1 and K4 held against
    their plain versions on the first call at each shape, and, for the
    model=2 run, greedy generation over the split artifact and K1 and K4 at
    the 10 s shape with this rank's heads.  Writes its result as JSON."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, REPO)
    import torch.distributed as tdist

    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.generation import generate as generate_mod
    from parler_tts_tpu_torch.ops import flash_attention as fa
    from parler_tts_tpu_torch.parallel import distributed as dist
    from parler_tts_tpu_torch.parallel import mesh as pmesh
    from parler_tts_tpu_torch.training import run_training as run_mod
    from parler_tts_tpu_torch.training import step as step_mod

    if spec["backend"] == "gloo":
        dist.initialize("gloo", device="cuda")
    steps, make = [], step_mod.make_train_step

    def make_spy(*args, **kwargs):
        inner = make(*args, **kwargs)

        def step(state, batch, timings=None):
            before = counts()
            metrics = inner(state, batch, timings)
            after = counts()
            steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                          "rows": int(batch["labels"].shape[0]), "launches": {k: after[k] - before[k] for k in after}})
            return metrics
        return step

    spy = KernelSpy(fa, ("flash_attention_fwd", "flash_attention_dqkv"), place="train step")
    step_mod.make_train_step = make_spy
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        with spy:
            out = run_mod.main(spec["argv"], device="cuda")
    finally:
        step_mod.make_train_step = make
    rank = dist.process_index()
    result = {"rank": rank, "world": dist.process_count(), "backend": tdist.get_backend(),
              "device": torch.cuda.current_device(), "steps": steps, "step_ms": out["timings"]["step_ms"],
              "launches": counts(), "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "held": sorted({(name, tuple(shapes[0])) for _, name, shapes, _ in spy.captured}),
              "max_abs_err": spy.hold(f"multiprocess {spec['name']} rank {rank}")}
    if spec.get("generate"):
        mesh = pmesh.make_mesh(data=1, model=dist.process_count())
        model, _, gen = ck.load_model(spec["artifact"], device="cuda", mesh=mesh)
        reset_counts()
        gspy = KernelSpy(fa, place="model=2 generation prefill")
        with gspy:
            tokens = mp_generation(generate_mod, model, gen)
        result["generation"] = {"tokens": tokens.tolist(), "k1_launches": counts()["flash_attention_fwd"],
                                "max_abs_err": gspy.hold("multiprocess")["flash_attention_fwd"],
                                "local_heads": model.decoder.num_heads}
        result["sharded_10s"] = hold_sharded_shape(fa, model.decoder.num_heads)
        t0 = time.perf_counter()
        result["split_inference"] = split_inference(spec, fa, model, gen, mesh, os.path.dirname(spec["result"]),
                                                    tokens)
        result["split_inference"]["wall_s"] = time.perf_counter() - t0
    with open(spec["result"].format(rank=rank), "w") as f:
        json.dump(result, f)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def launch(nproc: int, spec: dict, work: str) -> list[dict]:
    """``python -m torch.distributed.run`` with ``nproc`` ranks of this
    script's worker on ``spec``; the ranks' results (their output goes to a
    log in ``work``, whose end is raised with a failure)."""
    spec = {**spec, "result": os.path.join(work, f"{spec['name']}_r{{rank}}.json")}
    spec_path = os.path.join(work, f"{spec['name']}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(work, f"{spec['name']}.log")
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}",
           os.path.abspath(__file__), "--multiprocess-worker", spec_path]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            code = proc.wait(timeout=MP_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            code = "timeout"
    if code != 0:
        with open(log_path) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"multiprocess run {spec['name']} ended with {code}:\n{tail}")
    results = []
    for rank in range(nproc):
        with open(spec["result"].format(rank=rank)) as f:
            results.append(json.load(f))
    return results


def single_run(run_mod, step_mod, argv: list[str]) -> list[dict]:
    """``run_training.main`` in this process; each step's loss and norm."""
    steps, make = [], step_mod.make_train_step

    def make_spy(*args, **kwargs):
        inner = make(*args, **kwargs)

        def step(state, batch, timings=None):
            metrics = inner(state, batch, timings)
            steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])})
            return metrics
        return step

    step_mod.make_train_step = make_spy
    try:
        run_mod.main(argv, device="cuda")
    finally:
        step_mod.make_train_step = make
    return steps


def check_split_inference(ranks: list[dict], work: str, unsplit: dict, layers: int, heads: int) -> dict:
    """The model=2 ranks' ``split_inference`` results against each other
    and the unsplit model's: int8 tokens equal to the unsplit int8 run's and
    every int8 kernel and scale the unsplit view's slice; the stream's codes
    equal to the split ``generate``'s and the unsplit stream's, in more than
    one chunk, and its chunks equal on both ranks; the engine's batches (the
    warmup's and the burst's 4 requests) the same on both ranks and each
    equal to its direct ``tts``; K1 once per layer per prefill.  Returns the
    row to emit, with ``ok``."""
    res = [r["split_inference"] for r in ranks]
    streams = [np.load(os.path.join(work, f"stream_r{i}.npz")) for i in range(len(ranks))]
    int8, stream, engine = ([x[k] for x in res] for k in ("int8", "stream", "engine"))
    row = {
        "int8": {"same_tokens_as_unsplit_int8": [x["tokens"] == unsplit["int8"] for x in int8],
                 "view_compared": [x["view_compared"] for x in int8], "view_mismatched": [x["view_mismatched"]
                                                                                           for x in int8],
                 "kv_bytes_per_rank": [x["kv_bytes"] for x in int8], "kv_heads": [x["kv_heads"] for x in int8],
                 "kv_bytes_unsplit": unsplit["kv_bytes"], "k1_launches": [x["k1_launches"] for x in int8]},
        "stream": {"chunks": [x["chunks"] for x in stream], "codes_equal_split_generate": [
            x["codes_equal_generate"] for x in stream],
                   "codes_equal_unsplit_stream": [bool(np.array_equal(z["codes"], unsplit["codes"])) for z in streams],
                   "chunks_equal_across_ranks": all(np.array_equal(z[k], streams[0][k]) for z in streams
                                                    for k in ("codes", "audio", "offsets", "lengths")),
                   "audio_max_abs_diff_vs_unsplit": max(float(np.abs(z["audio"] - unsplit["audio"]).max())
                                                        if z["audio"].shape == unsplit["audio"].shape else math.inf
                                                        for z in streams),
                   "k1_launches": [x["k1_launches"] for x in stream]},
        "engine": {"following": [x["following"] for x in engine], "stats": [x["stats"] for x in engine],
                   "latency_s": engine[0]["latency_s"], "batches": engine[0]["batches"],
                   "same_batches_on_every_rank": all(x["batches"] == engine[0]["batches"] for x in engine),
                   "bit_equal_direct_tts": [x["bit_equal_direct_tts"] for x in engine],
                   "k1_launches": [x["k1_launches"] for x in engine]},
        "wall_s": [x["wall_s"] for x in res],
    }
    calls = len(engine[0]["batches"])
    row["ok"] = (all(row["int8"]["same_tokens_as_unsplit_int8"]) and not any(row["int8"]["view_mismatched"])
                 and all(n == 6 * layers + 1 for n in row["int8"]["view_compared"])
                 and all(h == heads for h in row["int8"]["kv_heads"])
                 and all(x["k1_launches"] == layers for x in int8 + stream)
                 and min(row["stream"]["chunks"]) > 1 and all(row["stream"]["codes_equal_split_generate"])
                 and all(row["stream"]["codes_equal_unsplit_stream"]) and row["stream"]["chunks_equal_across_ranks"]
                 and [x["following"] for x in engine] == [False] + [True] * (len(ranks) - 1)
                 and row["engine"]["same_batches_on_every_rank"] and calls >= 2
                 and all(all(x["bit_equal_direct_tts"]) and x["k1_launches"] == 2 * calls * layers for x in engine)
                 and all(x["stats"]["batches"] == calls and x["stats"]["batched_requests"] == 5 for x in engine))
    return row


def run_multiprocess(cfg_mod, parler, ck, run_mod, step_mod, generate_mod, streaming_mod, fa, work: str, card: str):
    """Phase 12: ``run_training.main`` over several processes on this one
    card, at Mini width on ``synthetic://12`` (fused T <= 91), 3 steps from a
    seeded Mini artifact with dropout off (masks differ by data rank, so
    only a run without dropout can equal the single-process one):
    (a) one rank under ``torch.distributed.run`` on NCCL at batch 2; (b) two
    gloo ranks, data=2 at per-device batch 1; (c) two gloo ranks, model=2 at
    batch 2, then greedy generation over the split artifact (fp32) whose
    tokens must equal the unsplit model's, and ``split_inference`` held by
    ``check_split_inference`` against the unsplit model's int8 tokens, KV
    bytes and stream.  Each run's losses and gradient norms against the
    single-process run at batch 2, run twice here for its own spread, within
    the bound (``MP_*``); K1 and K4 once per layer per step on every rank,
    held against their plain versions at each rank's shapes.  Step ms and
    peak GB are one card's, shared by two processes over gloo: not a scaling
    figure.  Returns the launches and largest errors."""
    t_phase = time.perf_counter()
    base = cfg_mod.mini_600m_config()
    cfg = dataclasses.replace(base, decoder=dataclasses.replace(base.decoder, dropout=0.0))
    art = os.path.join(work, "artifact")
    model = parler.init(MP_SEED, cfg, device="cuda")
    gen = cfg_mod.GenerationConfig(decoder_start_token_id=cfg.decoder.bos_token_id,
                                   pad_token_id=cfg.decoder.pad_token_id, bos_token_id=cfg.decoder.bos_token_id,
                                   eos_token_id=cfg.decoder.eos_token_id)
    ck.save_model(art, model, cfg, gen)
    unsplit_tokens = mp_generation(generate_mod, model, gen)
    unsplit_kv, real_init = [], generate_mod.init_cache

    def keep_cache(*args, **kw):
        cache = real_init(*args, **kw)
        unsplit_kv.append(cache.nbytes)
        return cache

    generate_mod.init_cache = keep_cache
    try:
        unsplit_int8 = mp_generation(generate_mod, model, dataclasses.replace(gen, int8_weights=True,
                                                                              kv_cache_dtype="int8"))
    finally:
        generate_mod.init_cache = real_init
    unsplit_stream = list(streaming_mod.stream_generate(
        model, dataclasses.replace(gen, max_length=MP_GEN_LEN, do_sample=False), chunk_frames=MP_CHUNK, lookback=48,
        device="cuda", **mp_generate_inputs(cfg)))
    unsplit_codes = np.concatenate([c.codes for c in unsplit_stream], axis=2)
    unsplit_audio = np.concatenate([c.audio for c in unsplit_stream], axis=1)
    del model, unsplit_stream
    gc.collect()
    torch.cuda.empty_cache()
    argv = MP_ARGV + ["--model_name_or_path", art]
    singles = [single_run(run_mod, step_mod, argv + ["--per_device_train_batch_size", "2", "--output_dir",
                                                     os.path.join(work, f"single{i}")]) for i in range(2)]
    gc.collect()
    torch.cuda.empty_cache()
    ref = singles[0]
    spread = max(abs(a["loss"] - b["loss"]) for a, b in zip(*singles))
    norm_spread = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"] for a, b in zip(*singles))
    bound = max(MP_SPREAD_FACTOR * spread, MP_GAP_FLOOR)
    norm_bound = max(MP_SPREAD_FACTOR * norm_spread, MP_NORM_FLOOR)
    layers = cfg.decoder.num_hidden_layers
    text_norms = 2 * cfg.text_encoder.num_layers + 1  # T5's RMSNorms, on K9 on every rank
    want_step = {"flash_attention_fwd": layers, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                 "flash_attention_dqkv": layers, "decode_attention": 0, "snake": 0,
                 "dac_conv": 0, "ssm_step": 0, "norm": text_norms}
    runs = {"nccl": (1, "nccl", ["--per_device_train_batch_size", "2"], 2),
            "data2": (2, "gloo", ["--per_device_train_batch_size", "1"], 1),
            "model2": (2, "gloo", ["--per_device_train_batch_size", "2", "--model_parallel_size", "2"], 2)}
    summary, launches, errs, ok = {}, dict.fromkeys(counts(), 0), {}, True
    for name, (nproc, backend, extra, rows) in runs.items():
        t0 = time.perf_counter()
        ranks = launch(nproc, {"name": name, "backend": backend, "artifact": art, "generate": name == "model2",
                               "argv": argv + extra + ["--output_dir", os.path.join(work, name)]}, work)
        wall = time.perf_counter() - t0
        losses = [[s["loss"] for s in r["steps"]] for r in ranks]
        gaps = [abs(g["loss"] - s["loss"]) for r in ranks for g, s in zip(r["steps"], ref)]
        norm_gaps = [abs(g["grad_norm"] - s["grad_norm"]) / s["grad_norm"] for r in ranks
                     for g, s in zip(r["steps"], ref)]
        run_ok = (all(r["backend"] == backend and r["world"] == nproc and r["device"] == 0 for r in ranks)
                  and all(len(r["steps"]) == MP_STEPS and all(s["rows"] == rows and s["launches"] == want_step
                                                              for s in r["steps"]) for r in ranks)
                  and all(x == losses[0] for x in losses) and all(math.isfinite(x) for x in losses[0])
                  and max(gaps) <= bound and max(norm_gaps) <= norm_bound)
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] += v
            for k, v in r["max_abs_err"].items():
                errs[k] = max(errs.get(k, 0.0), v)
        row = {"ranks": nproc, "backend": backend, "losses": losses[0], "single_losses": [s["loss"] for s in ref],
               "max_loss_gap": max(gaps), "loss_bound": bound, "max_grad_norm_gap_rel": max(norm_gaps),
               "grad_norm_bound_rel": norm_bound,
               "per_rank": [{"rank": r["rank"], "k1_launches": r["launches"]["flash_attention_fwd"],
                             "k4_launches": r["launches"]["flash_attention_dqkv"], "held": r["held"],
                             "max_abs_err": r["max_abs_err"], "step_ms": r["step_ms"], "peak_gb": r["peak_gb"]}
                            for r in ranks],
               "wall_s": wall, "timing_note": "one card, gloo, not a scaling figure" if backend == "gloo"
               else "one card, one rank"}
        if name == "model2":
            gens = [r["generation"] for r in ranks]
            same = all(g["tokens"] == unsplit_tokens.tolist() for g in gens)
            row["generation"] = {"positions": MP_GEN_LEN, "same_tokens_as_unsplit": same,
                                 "local_heads": [g["local_heads"] for g in gens],
                                 "k1_launches": [g["k1_launches"] for g in gens],
                                 "k1_max_abs_err": max(g["max_abs_err"] for g in gens)}
            row["sharded_10s_max_abs_err"] = {k: max(r["sharded_10s"][k] for r in ranks)
                                              for k in ("flash_attention_fwd", "flash_attention_dqkv")}
            heads = cfg.decoder.num_attention_heads // 2
            run_ok = run_ok and same and all(g["k1_launches"] == layers and g["local_heads"] == heads for g in gens)
            errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], row["generation"]["k1_max_abs_err"])
            launches["flash_attention_fwd"] += sum(g["k1_launches"] for g in gens)
            split = check_split_inference(ranks, work, {"int8": unsplit_int8.tolist(), "codes": unsplit_codes,
                                                        "audio": unsplit_audio, "kv_bytes": unsplit_kv[0]},
                                          layers, heads)
            emit({"phase": "split_inference", "config": "mini_600m_config, model=2 over gloo on one card; int8 "
                  "and stream greedy fp32 compute, engine bf16 top-k 50", "card": card, **split})
            run_ok = run_ok and split["ok"]
            for r in ranks:
                for path in r["split_inference"].values():
                    if isinstance(path, dict) and "k1_launches" in path:
                        launches["flash_attention_fwd"] += path["k1_launches"]
                        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], path["k1_max_abs_err"])

        row["ok"] = run_ok
        summary[name] = row
        emit({"phase": "multiprocess_run", "run": name, **row})
        ok = ok and run_ok
    emit({"phase": "multiprocess", "config": "mini_600m_config, dropout 0, fp32 parameters, bf16 compute, random "
          "weights (seed 42); generation fp32", "card": card, "single_losses": singles,
          "single_spread": spread, "single_grad_norm_spread_rel": norm_spread, "launches": launches,
          "max_abs_err": errs, "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise AssertionError("the multiprocess phase is not as it should be (see its lines)")
    return launches, errs


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
    from parler_tts_tpu_torch import serving as serving_mod
    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.core import config as cfg_mod
    from parler_tts_tpu_torch.core import from_jax, from_reference
    from parler_tts_tpu_torch.generation import generate as generate_mod
    from parler_tts_tpu_torch.generation import streaming as streaming_mod
    from parler_tts_tpu_torch.models import codec as codec_mod
    from parler_tts_tpu_torch.models import dac as dac_mod
    from parler_tts_tpu_torch.models import parler
    from parler_tts_tpu_torch.ops import cuda_build
    from parler_tts_tpu_torch.ops import dac_conv as dac_conv_mod
    from parler_tts_tpu_torch.ops import decode_attention as da
    from parler_tts_tpu_torch.ops import flash_attention as fa
    from parler_tts_tpu_torch.ops import moe as moe_mod
    from parler_tts_tpu_torch.ops import norm as norm_mod
    from parler_tts_tpu_torch.ops import snake as snake_mod
    from parler_tts_tpu_torch.ops import ssm as ssm_mod
    from parler_tts_tpu_torch.training import data as data_mod
    from parler_tts_tpu_torch.training import run_training as run_mod
    from parler_tts_tpu_torch.training import step as step_mod
    from parler_tts_tpu_torch.utils import mel as mel_mod
    from parler_tts_tpu_torch.utils import tokenizer as reader_mod
    from parler_tts_tpu_torch.utils import toy_tokenizer as tokenizer_mod

    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_defaults": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                            "cudnn": torch.backends.cudnn.allow_tf32}})

    t0 = time.perf_counter()
    logs = cuda_build.build(["flash_attention_fwd", "flash_attention_bwd", "decode_attention", "snake", "dac_conv",
                             "ssm_step", "norm"])
    kernels_built = ptxas_report("\n".join(logs.values()))
    spills = {name: r for name, r in kernels_built.items()
              if ("mma_kernel" in name or "decode_attn" in name or "snake_kernel" in name or "dac_conv" in name
                  or "ssm_step" in name or "norm_kernel" in name)
              and r["spill_bytes"]}
    # each tensor-core instance and each K5 instance (the mangled name holds the head dim) must be in the report
    missing = [f"{kernel}<{d}>" for kernel in MMA_KERNELS for d in (32, 64)
               if not any(f"{kernel}ILi{d}E" in name and r["registers"] for name, r in kernels_built.items())]
    missing += [f"{kernel}<{t}, {d}>" for kernel in DECODE_KERNELS for t in ("13__nv_bfloat16", "f") for d in (32, 64)
                if not any(f"{kernel}I{t}Li{d}E" in name and r["registers"] for name, r in kernels_built.items())]
    missing += [kernel for kernel in SNAKE_KERNELS + DAC_CONV_KERNELS + NEMOTRON_H_KERNELS + NORM_KERNELS
                if not any(kernel in name and r["registers"] for name, r in kernels_built.items())]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "flags": " ".join(cuda_build.NVCC_FLAGS),
          "ptxas": kernels_built, "missing_from_ptxas": missing, "ok": not spills and not missing})
    if spills or missing:
        raise AssertionError(f"ptxas reports spills in the tensor-core kernels ({spills}) or misses {missing}")

    with exact_fp32():
        k1 = check_kernels(fa)
        bwd = check_backward(fa)
        k5 = check_decode_kernel(da)
        k6 = check_snake(dac_mod, snake_mod)
        k7 = check_dac_conv(dac_mod, dac_conv_mod, codec_mod, cfg_mod)
        k9 = check_norm(norm_mod)
        experts = check_experts(moe_mod)
        nemotron_h = check_nemotron_h_kernels(ssm_mod, da, fa)
        check_reference(cfg_mod, parler, generate_mod, streaming_mod)
        check_encodec_reference(cfg_mod, parler, generate_mod, codec_mod)
        check_train_reference(cfg_mod, parler, fa, step_mod, run_mod, data_mod, from_jax)
    # from here on, the flags a user gets (the DAC pins its own fp32 convolutions)
    tts_launches, model, pipe = run_main_path(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod, card)
    new_paths = {
        "decoder_only": run_decoder_only(model.cfg, model, pipe, fa, generate_mod, card),
        "int8": run_int8(model.cfg, model, pipe, fa, generate_mod, mel_mod, card),
        "decode_graph": run_decode_graph(model.cfg, model, pipe, fa, generate_mod, card),
        "stream": run_stream(model.cfg, model, pipe, fa, generate_mod, streaming_mod, mel_mod, card),
        "serving": run_serving(model.cfg, model, pipe, fa, serving_mod, card),
    }
    http_tmp = tempfile.mkdtemp(prefix="parler_http_")
    try:
        new_paths["http_serving"] = run_http_serving(model.cfg, model, pipe, fa, serving_mod, ck, reader_mod, card,
                                                     http_tmp)
    finally:
        shutil.rmtree(http_tmp, ignore_errors=True)
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    new_paths["encodec"] = run_encodec(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod, generate_mod, codec_mod,
                                       data_mod, card)
    gc.collect()
    torch.cuda.empty_cache()
    ref_tmp = tempfile.mkdtemp(prefix="parler_reference_")
    try:
        new_paths["reference_import"] = run_reference_import(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod,
                                                             from_reference, ck, card, ref_tmp)
    finally:
        shutil.rmtree(ref_tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train_path(cfg_mod, parler, fa, step_mod, data_mod, card)
    train_launches = train["launches"]
    del train
    torch.cuda.empty_cache()
    run_codec_encode(cfg_mod.mini_600m_config().audio_encoder, "mini_600m_config DAC", codec_mod, data_mod, card)
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="parler_train_cli_")
    try:
        torch.cuda.reset_peak_memory_stats()
        cli_launches, cli_errs = run_train_cli(cfg_mod, run_mod, ck, step_mod, fa, out_dir, card)
        gc.collect()
        torch.cuda.empty_cache()
        run_from_pretrained(cfg_mod, pipeline_mod, tokenizer_mod, ck, out_dir, card)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    text_dir = tempfile.mkdtemp(prefix="parler_text_")
    try:
        text_launches, text_errs = run_text(cfg_mod, run_mod, fa, pipeline_mod, generate_mod, codec_mod,
                                            data_mod, reader_mod, text_dir, card)
    finally:
        shutil.rmtree(text_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    mp_dir = tempfile.mkdtemp(prefix="parler_multiprocess_")
    try:
        mp_launches, mp_errs = run_multiprocess(cfg_mod, parler, ck, run_mod, step_mod, generate_mod, streaming_mod,
                                                fa, mp_dir, card)
    finally:
        shutil.rmtree(mp_dir, ignore_errors=True)

    head = next(r for r in k1["per_shape"] if r["shape"][2] == 257)
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "parler_tts_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": REPLACES["flash_attention_fwd"],
        "launches": sum(p["flash_attention_fwd"] for p in (tts_launches, train_launches, cli_launches, text_launches,
                                                            mp_launches))
        + sum(path[0] for path in new_paths.values()),
        "launches_by_path": {"tts": tts_launches["flash_attention_fwd"],
                             **{name: path[0] for name, path in new_paths.items()},
                             "train": train_launches["flash_attention_fwd"],
                             "train_cli": cli_launches["flash_attention_fwd"],
                             "text": text_launches["flash_attention_fwd"],
                             "multiprocess": mp_launches["flash_attention_fwd"]},
        "max_abs_err": max(k1["max_abs_err"], cli_errs["flash_attention_fwd"], text_errs["flash_attention_fwd"],
                           mp_errs["flash_attention_fwd"], *(path[1] for path in new_paths.values())),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"], "shape": head["shape"],
        "per_shape": k1["per_shape"] + [new_paths["decoder_only"][2], new_paths["encodec"][2],
                                        new_paths["http_serving"][2]]
        + bwd["flash_attention_fwd"]["per_shape"],
    }]
    for name in BWD_NAMES:
        row = next(r for r in bwd[name]["per_shape"] if r["path"])
        kernels.append({
            "name": name, "route": "cuda", "source": "parler_tts_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": REPLACES[name],
            "launches": train_launches[name] + cli_launches[name] + text_launches[name] + mp_launches[name],
            "launches_by_path": {"tts": tts_launches[name], **{path: 0 for path in new_paths},  # checked 0
                                 "train": train_launches[name], "train_cli": cli_launches[name],
                                 "text": text_launches[name], "multiprocess": mp_launches[name]},
            "max_abs_err": max(bwd[name]["max_abs_err"], cli_errs.get(name, 0.0), text_errs.get(name, 0.0),
                               mp_errs.get(name, 0.0)),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_call": row["library_call"], "shape": row["shape"], "per_shape": bwd[name]["per_shape"],
        })
    head = next(r for r in k5["per_shape"] if r["shape"][2] == 558)
    grouped = next(r for r in k5["per_shape"] if r["group"] == 4 and r["shape"][2] == 448)
    kernels.append({
        "name": "decode_attention", "route": "cuda", "source": "parler_tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "no TPU kernel: XLA's fusion of parler_tts_tpu/models/decoder.py _self_attention_decode / "
                    "_cross_attention_decode",
        # each path's own count, set to 0 just before it (the inference paths beside tts count K1 only)
        "launches": sum(p["decode_attention"] for p in (tts_launches, train_launches, cli_launches, text_launches,
                                                         mp_launches)),
        "launches_by_path": {"tts": tts_launches["decode_attention"], "train": train_launches["decode_attention"],
                             "train_cli": cli_launches["decode_attention"],
                             "text": text_launches["decode_attention"],
                             "multiprocess": mp_launches["decode_attention"]},
        "max_abs_err": k5["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": "bytes", "library_ms": head["library_ms"],
        "library_call": "scaled_dot_product_attention", "shape": head["shape"], "per_shape": k5["per_shape"],
        # the LFM2 cell's grouped queries: 8 K/V heads of 4, each block reading its K/V head once
        "group_4": {key: grouped[key] for key in ("shape", "ms", "bound_ms", "share_of_bound", "library_ms")},
    })
    head = next(r for r in k6["per_shape"] if r["shape"][1] == 96)
    kernels.append({
        "name": "snake", "route": "cuda", "source": "parler_tts_tpu_torch/csrc/snake.cu",
        "replaces": "no TPU kernel: XLA's fusion of parler_tts_tpu/models/dac.py snake_fast",
        # each path's own count, set to 0 just before it; checked: SNAKES_PER_DECODE per DAC decode group in
        # tts, none in a train step
        "launches": sum(p["snake"] for p in (tts_launches, train_launches, cli_launches, text_launches,
                                              mp_launches)),
        "launches_by_path": {"tts": tts_launches["snake"], "train": train_launches["snake"],
                             "train_cli": cli_launches["snake"], "text": text_launches["snake"],
                             "multiprocess": mp_launches["snake"]},
        "bit_for_bit": all(r["bit_for_bit"] for r in k6["per_shape"]), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": "bytes", "shape": head["shape"],
        "per_shape": k6["per_shape"],
        "per_audio_s": {key: k6[key] for key in ("ms_per_audio_s", "plain_ms_per_audio_s", "bound_ms_per_audio_s",
                                                 "share_of_bound")},
    })
    head = next(r for r in k7["per_shape"] if r["shape"][1] == 384 and r["taps"] == 7 and r["dilation"] == 1)
    kernels.append({
        "name": "dac_conv", "route": "cuda", "source": "parler_tts_tpu_torch/csrc/dac_conv.cu",
        "replaces": "no TPU kernel: XLA's convolutions in parler_tts_tpu/models/dac.py",
        # each path's own count, set to 0 just before it; checked: DAC_CONVS_PER_DECODE per DAC decode group in
        # tts, none in a train step
        "launches": sum(p["dac_conv"] for p in (tts_launches, train_launches, cli_launches, text_launches,
                                                 mp_launches)),
        "launches_by_path": {"tts": tts_launches["dac_conv"], "train": train_launches["dac_conv"],
                             "train_cli": cli_launches["dac_conv"], "text": text_launches["dac_conv"],
                             "multiprocess": mp_launches["dac_conv"]},
        "max_err_over_tol": max(r["max_err_over_tol"] for r in k7["per_shape"]), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library_call": "nn.Conv1d (cuDNN) then the residual add",
        "shape": head["shape"], "per_shape": k7["per_shape"],
        "per_audio_s": {key: k7[key] for key in ("ms_per_audio_s", "plain_ms_per_audio_s", "library_ms_per_audio_s",
                                                 "channels_last_ms_per_audio_s", "bound_ms_per_audio_s",
                                                 "share_of_bound")},
    })
    head = k9["per_shape"][0]
    kernels.append({
        "name": "norm", "route": "cuda", "source": "parler_tts_tpu_torch/csrc/norm.cu",
        "replaces": "no TPU kernel: XLA's fusion of parler_tts_tpu/ops/nn.py layer_norm / rms_norm",
        # each path's own count, set to 0 just before it; checked: 73 per decode step and 98 per prefill in tts,
        # T5's 25 per train step
        "launches": sum(p["norm"] for p in (tts_launches, train_launches, cli_launches, text_launches,
                                             mp_launches)),
        "launches_by_path": {"tts": tts_launches["norm"], "train": train_launches["norm"],
                             "train_cli": cli_launches["norm"], "text": text_launches["norm"],
                             "multiprocess": mp_launches["norm"]},
        "max_ulps": max(r["max_ulps"] for r in k9["per_shape"]),
        "min_equal_share": min(r["equal_share"] for r in k9["per_shape"]), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": "bytes",
        "library_ms": head["library_ms"], "library_call": "F.layer_norm on the bf16 tensors", "shape": head["shape"],
        "per_shape": k9["per_shape"], "per_step": k9["per_step"],
    })
    emit({"kernels": kernels, "grouped_experts": experts["per_shape"], "nemotron_h": nemotron_h})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multiprocess-worker"]:
        sys.exit(multiprocess_worker(sys.argv[2]))
    sys.exit(main())
