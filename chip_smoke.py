#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``parler_tts_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and power
   limit; build the hand-written CUDA kernels from ``parler_tts_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together);
2. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at the CPU tests' odd shapes, in bf16 and fp32, with
   the tolerances stated below; device times (CUDA-graph replay) of the
   kernel, its plain version and the one PyTorch call computing the same
   function (timed as a yardstick only, never called by the port);
3. reference: a small config (``dummy_config``) generated greedily at fp32 on
   the card (kernel path) and on the CPU (plain path) must give the same
   tokens and waveforms;
4. main path: ``ParlerTTSPipeline.tts`` at full Parler-TTS Mini v0.1 width
   (random weights from a seed, bf16), three calls of four requests whose
   prompt buckets give prefill lengths 17, 65 and 257; each call must launch
   the flash-attention kernel once per decoder layer.  Then one more call with
   each phase synchronised and timed, and a short call under torch.profiler
   for the device's busy time.

Output: a JSON line per phase, then the kernels line, then ``nvidia-smi``'s
``name, power.limit``, then the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # non-tensor fp32
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # on `out`; fp32 sums in another order, bf16 one output ulp
LSE_TOL = 1e-3

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


def k1_bound(kv_mask: torch.Tensor, heads: int, t: int, d: int, elem: int, causal: bool, peak: float):
    """Least time for this call: q, k, v read once, out and lse written once,
    against 4*D operations per (query, valid key) pair that this mask leaves."""
    m = kv_mask.int().cpu()
    start = m.argmax(dim=1)
    end = start + m.sum(dim=1)
    rows = torch.arange(t)[None, :]
    hi = torch.minimum(end[:, None], rows + 1) if causal else end[:, None].expand(-1, t)
    pairs = heads * int((hi - start[:, None]).clamp(min=0).sum())
    bh = m.shape[0] * heads
    nbytes = 4 * bh * t * d * elem + bh * t * 4 + 2 * bh * 4
    flops = 4 * d * pairs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
            ref_out, ref_lse = fa.flash_attention_plain(q3, k3, v3, start, end, scale=0.125, causal=causal)
            err = (out.float() - ref_out.reshape(out.shape).float()).abs().max().item()
            lse_err = (lse - ref_lse.reshape(lse.shape)).abs().max().item()
            ok = err <= TOL[dtype] and lse_err <= LSE_TOL and math.isfinite(err)
            emit({"phase": "k1_check", "shape": [b, h, t, d], "pad": pad, "causal": causal,
                  "dtype": str(dtype).removeprefix("torch."), "kind": kind, "max_abs_err_out": err,
                  "tol_out": TOL[dtype], "max_abs_err_lse": lse_err, "tol_lse": LSE_TOL, "ok": ok})
            if not ok:
                raise AssertionError(f"flash_attention_fwd disagrees with its plain version at {(b, h, t, d)} {dtype}")
            if kind != "main path" or dtype != torch.bfloat16:
                continue
            worst = max(worst, err)
            valid = kv_mask.bool()[:, None, None, :]
            sdpa_mask = valid & torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
            row = {
                "shape": [b, h, t, d], "pad": pad,
                "ms": graph_ms(lambda: fa.flash_attention(q3, k3, v3, start, end, scale=0.125, causal=True)),
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
    fa.LAUNCHES = 0
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
    launches = fa.LAUNCHES

    timings = time_phases(model, pipe, _prompts(50), max_seconds)
    emit({"phase": "main_path", "config": "mini_600m_config bf16, random weights (seed 0)",
          "card": card, "max_seconds": max_seconds, **timings,
          "wall_s_per_call": [c["wall_s"] for c in calls],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # a short call: the profiler's event processing costs seconds per 100k kernels
    emit({"phase": "profile", "card": card, "max_seconds": 0.5, **profile_call(pipe, _prompts(50), 0.5)})
    return launches


def profile_call(pipe, prompts, max_seconds) -> dict:
    """One warm tts call under torch.profiler: the device's busy time (sum
    of kernel durations) against the call's wall time, which the profiler
    itself lengthens, the kernel count, and the kernels that take the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.tts(DESCRIPTIONS, prompts, seed=SEED, max_seconds=max_seconds)
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name: dict[str, float] = {}
    count = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += 1
    if not count:
        return {"device_busy_share": None, "note": "the profiler recorded no device time"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": sum(by_name.values()) / 1e3,
            "device_busy_share": sum(by_name.values()) / wall_us, "device_events": count,
            "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top]}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from parler_tts_tpu_torch import pipeline as pipeline_mod
    from parler_tts_tpu_torch.core import config as cfg_mod
    from parler_tts_tpu_torch.generation import generate as generate_mod
    from parler_tts_tpu_torch.models import parler
    from parler_tts_tpu_torch.ops import cuda_build
    from parler_tts_tpu_torch.ops import flash_attention as fa
    from parler_tts_tpu_torch.utils import toy_tokenizer as tokenizer_mod

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons below are exact-fp32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = cuda_build.build(["flash_attention_fwd"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "flags": " ".join(cuda_build.NVCC_FLAGS),
          "ptxas": [ln.strip() for log in logs.values() for ln in log.splitlines() if "Used" in ln]})

    k1 = check_kernels(fa)
    check_reference(cfg_mod, parler, generate_mod)
    launches = run_main_path(cfg_mod, parler, fa, pipeline_mod, tokenizer_mod, card)

    head = next(r for r in k1["per_shape"] if r["shape"][2] == 257)
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "parler_tts_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "parler_tts_tpu/ops/pallas/flash_attention.py:69",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": head["shape"], "per_shape": k1["per_shape"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
