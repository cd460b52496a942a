"""Offline generation: one closed-loop caller sends back-to-back
``ParlerTTSPipeline.tts`` calls of a mix's rows until the window has passed
and the last round of greedy and sampled calls is whole; the last call
started in it runs to its end.

Set-up builds the model on the card from the configuration file, loads the
benchmark's weights (``perfbench/weights.py``) in the served dtype, and runs
the mix's ``warmup_rounds`` rounds of greedy and sampled calls: the first
builds the kernels and captures every graph the window replays, the later
ones let the first calls' slower state pass (PERF.md, §2).

End to end: ``audio_s_per_s``, the audio seconds of every call over the
time from the first call's start to the last call's end; ``setup_s``, from
process start to the window's start.  Traced (``--trace 1``): spans around
``generate_tokens`` and the codec's ``decode`` in every call of the window,
then one more sampled call under the profiler.

Correct: a sample of rows of the window's greedy calls and one of its
sampled calls, drawn from the seed, judged by the reference once the
program is freed (``reference/tts.py``): a greedy row's mean gap of a
chosen token's reference logit below the reference's best, a sampled row's
mean excess of the reference's k-th best over a chosen token's logit (0
inside the reference's top k), each over every step the delay pattern
leaves to the model, and every row's waveform's relative error against the
reference's decode of the same tokens; the largest of each over the rows,
against the cell's limits.  A row a call did not return, or returned too
short, fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from perfbench import flops, harness, traffic, weights
from perfbench.reference import Weights
from perfbench.reference import tts as reference
from perfbench.trace import Spans, profile

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Done:
    """A finished call: what the check and the metrics need of it."""

    call: traffic.Call
    start: float
    end: float
    audio_s: float
    rows: int  # the rows the call asked for
    returned: int  # the waveforms it returned
    t_end: int
    tokens: torch.Tensor | None  # the delayed tokens, kept for the window's calls
    audio: list | None  # the waveforms the call returned, kept for the window's calls


def build(plan, seed: int, device: torch.device):
    """The program's model on ``device`` in the served dtype, with the
    benchmark's weights for ``seed``; returns (config, model, layout)."""
    from parler_tts_tpu_torch.core.config import ParlerTTSConfig
    from parler_tts_tpu_torch.models.parler import ParlerTTSModel

    cfg = ParlerTTSConfig.from_dict(plan.config["model"])
    dtype = DTYPES[plan.config["dtype"]]
    with torch.device(device):
        model = ParlerTTSModel(cfg)
    model = model.to(dtype).eval().requires_grad_(False)
    spec = weights.layout(model)
    w = weights.make(seed, spec, codebook_size=cfg.audio_encoder.codebook_size, device=device, dtype=dtype)
    model.load_state_dict(w, strict=True)
    del w
    return cfg, model, spec


def pipelines(plan, cfg, model, device: torch.device):
    """(sampled, greedy) pipelines over one model, tokenized one id per
    word."""
    from parler_tts_tpu_torch.core.config import GenerationConfig
    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer

    sampling = plan.traffic["sampling"]
    gen = GenerationConfig(do_sample=True, top_k=sampling["top_k"], temperature=sampling["temperature"])
    desc_tok, prompt_tok = ToyTokenizer(cfg.text_encoder.vocab_size), ToyTokenizer(cfg.vocab_size)
    dtype = DTYPES[plan.config["dtype"]]

    def pipe(g):
        return ParlerTTSPipeline(model, cfg, g, desc_tok, prompt_tok, dtype=dtype, device=device)

    return pipe(gen), pipe(dataclasses.replace(gen, do_sample=False))


@contextlib.contextmanager
def recording(spans: Spans, sr: int):
    """Keeps each ``generate_tokens`` result (tokens, stop position) and, when
    traced, times it and the codec's decode."""
    from parler_tts_tpu_torch.generation import generate as gen_mod
    from parler_tts_tpu_torch.models import codec as codec_mod

    kept = {}
    real = gen_mod.generate_tokens

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        kept["tokens"], kept["t_end"] = out
        return out

    gen_mod.generate_tokens = keep
    try:
        with spans.wrap(gen_mod, "generate_tokens", "decode", lambda a, k, out: out[1] - 1), \
                spans.wrap(codec_mod, "decode", "vocode", lambda a, k, out: out.shape[0] * out.shape[1] / sr):
            yield kept
    finally:
        gen_mod.generate_tokens = real


def call_once(pipe, c: traffic.Call, max_seconds: float, kept: dict, keep_outputs: bool) -> Done:
    start = time.perf_counter()
    sr, audio = pipe.tts(c.descriptions, c.prompts, seed=c.seed, max_seconds=max_seconds)
    end = time.perf_counter()
    return Done(c, start, end, sum(a.shape[0] for a in audio) / sr, len(c.descriptions), len(audio),
                int(kept["t_end"]),
                kept["tokens"] if keep_outputs else None, audio if keep_outputs else None)


def model_flops(config: dict, done: list[Done], max_length: int) -> float:
    total = 0.0
    for d in done:
        for desc, prompt in zip(d.call.descriptions, d.call.prompts):
            total += flops.tts_row(config, len(desc.split()), len(prompt.split()), max_length)
    return total


def attn_fwd_bound(config: dict, c: traffic.Call) -> float:
    """Seconds K1 needs at least in one call: the decoder prefill's causal
    self-attention over the fused prompt and BOS frame, every layer."""
    d = config["decoder"]
    heads, dim = d["num_attention_heads"], d["hidden_size"] // d["num_attention_heads"]
    _, mask = traffic.ids(c.prompts, config["vocab_size"], left=True)
    fused = [list(row) + [1] for row in mask.tolist()]
    t = len(fused[0])
    pairs = heads * sum(flops.causal_pairs(row) for row in fused)
    ops, nbytes = flops.attention_fwd(heads * len(fused), t, t, dim, pairs)
    return d["num_hidden_layers"] * flops.bound_seconds(ops, nbytes)


def pick_rows(done: list[Done], n: int, seed: int, greedy: bool = True) -> list[tuple[int, int]]:
    """``n`` (call, row) pairs of the greedy calls, or of the sampled ones,
    drawn from the seed."""
    pool = [(i, r) for i, d in enumerate(done) if d.call.greedy == greedy for r in range(d.rows)]
    rng = np.random.default_rng([seed, 7 if greedy else 8])
    return [pool[j] for j in sorted(rng.choice(len(pool), size=min(n, len(pool)), replace=False))]


def judge(plan, seed: int, spec, done: list[Done], picked, device, block: int) -> list[dict]:
    """The reference's readings of the picked rows, in blocks of rows of one
    kind (greedy or sampled); the raw weights made again from the seed."""
    model_cfg = plan.config["model"]
    dtype = DTYPES[plan.config["dtype"]]
    raw = weights.make(seed, spec, codebook_size=model_cfg["audio_encoder"]["codebook_size"], device=device,
                       dtype=dtype)
    w = Weights(raw)
    picked = [(i, r) for i, r in picked if r < len(done[i].audio)]  # a row the call did not return is failed
    sampling = plan.traffic["sampling"]
    blocks = [[p for p in picked if done[p[0]].call.greedy == g] for g in (True, False)]
    out = []
    for rows in [b[i:i + block] for b in blocks for i in range(0, len(b), block)]:
        greedy = done[rows[0][0]].call.greedy
        calls = [done[i].call for i, _ in rows]
        desc = [traffic.ids(c.descriptions, model_cfg["text_encoder"]["vocab_size"], left=False) for c in calls]
        prompt = [traffic.ids(c.prompts, model_cfg["vocab_size"], left=True) for c in calls]

        def stack(parts, which):
            return torch.as_tensor(np.stack([p[which][r] for p, (_, r) in zip(parts, rows)]), device=device)

        out += reference.judge(
            w, model_cfg, desc_ids=stack(desc, 0), desc_mask=stack(desc, 1), prompt_ids=stack(prompt, 0),
            prompt_mask=stack(prompt, 1), tokens=torch.stack([done[i].tokens[r] for i, r in rows]).to(device),
            audio=[torch.as_tensor(done[i].audio[r], device=device) for i, r in rows],
            top_k=0 if greedy else sampling["top_k"], temperature=sampling["temperature"])
    return out


def run(plan, *, seed: int, seconds: float, trace: bool, device: torch.device, process_start: float) -> dict:
    mix = plan.traffic
    cfg, model, spec = build(plan, seed, device)
    sampled, greedy = pipelines(plan, cfg, model, device)
    max_seconds = mix["max_seconds"]
    max_length = sampled.max_length(max_seconds)
    spans = Spans(device, on=False)
    with recording(spans, cfg.sampling_rate) as kept:
        for i in range(mix["warmup_rounds"] * mix["greedy_every"]):  # calls from another stream
            c = traffic.call(mix, seed ^ 0x5EED, i)
            call_once(greedy if c.greedy else sampled, c, max_seconds, kept, False)
        sync(device)
        setup_s = time.perf_counter() - process_start

        spans.on = trace
        done: list[Done] = []
        window_start = time.perf_counter()
        # whole rounds of greedy and sampled calls, so every window has the same mix
        while len(done) % mix["greedy_every"] or time.perf_counter() - window_start < seconds:
            c = traffic.call(mix, seed, len(done))
            done.append(call_once(greedy if c.greedy else sampled, c, max_seconds, kept, True))
        spans.on = False
        print("calls (s): " + " ".join(f"{'g' if d.call.greedy else 's'}{d.end - d.start:.4f}" for d in done),
              file=sys.stderr)
        window_s = done[-1].end - done[0].start

        facts, breakdown, profiled = {}, None, None
        if trace:
            c = dataclasses.replace(traffic.call(mix, seed, len(done)), greedy=False)
            profiled = profile(lambda: call_once(sampled, c, max_seconds, kept, False), device)
            facts = {"root": plan.root, "spans": spans.facts(), "trace": profiled, "window_s": window_s,
                     "model_flops": model_flops(plan.config["model"], done, max_length),
                     "bounds": {"attn_fwd": attn_fwd_bound(plan.config["model"], c)},
                     "kernels": {"attn_fwd": harness.kernel_names(plan.root, "attn_fwd")}}
            breakdown = profiled.breakdown()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    for d in done:  # the kept outputs to the host, the program's state freed
        if d.tokens is not None:
            d.tokens = d.tokens.cpu()
    del sampled, greedy, model, kept
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    picked = pick_rows(done, mix["check_rows"], seed) + pick_rows(done, mix["check_sampled_rows"], seed, False)
    readings = judge(plan, seed, spec, done, picked, device, mix["check_block"]) if picked else []
    # rows a call did not return, and returned rows of the wrong length
    failed = sum(d.rows - d.returned for d in done) + sum(r["wave_err"] is None for r in readings)
    gaps = [r["mean_gap"] for r in readings if r["topk_excess"] is None]
    excess = [r["topk_excess"] for r in readings if r["topk_excess"] is not None]
    errs = [r["wave_err"] for r in readings if r["wave_err"] is not None]
    limits = plan.limits

    def worst(values, name):
        return {"value": max(values) if values else None, "limit": limits[name]}

    checks = {
        "rows_checked": {"value": len(gaps), "limit": mix["check_rows"]},
        "sampled_rows_checked": {"value": len(excess), "limit": mix["check_sampled_rows"]},
        "mean_logit_gap": worst(gaps, "mean_logit_gap"),
        "topk_excess": worst(excess, "topk_excess"),
        "wave_rel_err": worst(errs, "wave_rel_err"),
    }
    correct = (len(gaps) == mix["check_rows"] and len(excess) == mix["check_sampled_rows"] and failed == 0
               and len(errs) == len(readings)
               and all(c["value"] <= c["limit"] for name, c in checks.items() if not name.endswith("checked")))
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "count": 1,
                   "memory_peak_bytes": peak}
    if profiled is not None:
        device_info.update(busy_s=profiled.busy_s(), window_s=profiled.window_s)
    return {"correct": correct, "attempted": sum(d.rows for d in done), "failed": failed,
            "end_to_end": {"audio_s_per_s": sum(d.audio_s for d in done) / window_s, "setup_s": setup_s},
            "facts": facts, "breakdown": breakdown, "device": device_info, "checks": checks}
