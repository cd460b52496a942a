"""Offline generation through the LFM2 decoder: ``offline.py``'s calls,
window, metrics and checks, with what differs for this decoder.

* The model is built in the served dtype directly (8.7 B decoder
  parameters: building in float32 first would hold 35 GB more in set-up).
* The weights are ``weights.make``'s with T5's query kernels at T5's
  published init, std (d_model * d_kv)^-1/2 (``make``: the fan-in draw
  times d_kv^-1/2, a power of two, so exact in bfloat16).  At the fan-in
  std the encoder's attention logits have a std of about 8: the softmax
  picks nearly one key, bfloat16 rounding picks another, and the served
  encoder's states differ from float32's by about 35 % (the fp8 control's by
  97 %), which the cross-attention of all 24 layers then carries into the
  logits.  At the published std the served encoder is within about 1.5 %.
* The judge is ``reference/tts_lfm2.py``, given the prompts as the
  program's prefill lays them out: each row's tokens moved against its BOS
  frame (``traffic.ids`` pads the texts right, then the batch left; the
  LFM2 decoder's convolution and RoPE read the moved sequence).
* The model FLOPs and K1's bound are ``flops_lfm2.py``'s.
* A ``--trace 1`` run adds the program's counters over the profiled call
  (``facts["counters"]``: ``decode.replays``, ``moe.*``), the experts'
  bound (``bounds["moe_experts"]``) and their kernels
  (``kernels["moe_experts"]``: ``perfbench/kernels/moe_experts/``).

A program without the LFM2 block family fails at once, before any work.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from perfbench import flops_lfm2, harness, traffic, weights
from perfbench.reference import Weights
from perfbench.reference import tts_lfm2

base = harness.load_module(Path(__file__).with_name("offline.py"), "perfbench_offline_base_lfm2")
DTYPES, Spans, recording, call_once, pick_rows, pipelines = (base.DTYPES, base.Spans, base.recording, base.call_once,
                                                            base.pick_rows, base.pipelines)
#: the program's counters over the profiled call
PROFILED: dict[str, float] = {}


def supported() -> bool:
    from parler_tts_tpu_torch.core.config import DecoderConfig

    return "block_type" in {f.name for f in dataclasses.fields(DecoderConfig)}


def build(plan, seed: int, device: torch.device):
    """``offline.build``, the model made in the served dtype."""
    from parler_tts_tpu_torch.core.config import ParlerTTSConfig
    from parler_tts_tpu_torch.models.parler import ParlerTTSModel

    cfg = ParlerTTSConfig.from_dict(plan.config["model"])
    dtype = DTYPES[plan.config["dtype"]]
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.device(device):
            model = ParlerTTSModel(cfg)
    finally:
        torch.set_default_dtype(default)
    model = model.to(dtype).eval().requires_grad_(False)
    spec = weights.layout(model)
    w = make(seed, spec, text_encoder=plan.config["model"]["text_encoder"],
             codebook_size=cfg.audio_encoder.codebook_size, device=device, dtype=dtype)
    model.load_state_dict(w, strict=True)
    del w
    return cfg, model, spec


def t5_queries(w: dict[str, torch.Tensor], text_encoder: dict) -> dict[str, torch.Tensor]:
    """``w`` with T5's query kernels scaled in place by d_kv^-1/2, from the
    fan-in std to T5's published one."""
    for name, t in w.items():
        if name.startswith("text_encoder.") and name.endswith(".q.kernel"):
            t.mul_(text_encoder["d_kv"] ** -0.5)
    return w


def make(seed: int, spec, *, text_encoder: dict, **kwargs) -> dict[str, torch.Tensor]:
    """``weights.make``'s weights, T5's queries at T5's published init."""
    return t5_queries(weights.make(seed, spec, **kwargs), text_encoder)


def left_flush(ids: np.ndarray, mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each row's valid ids moved, in order, to the row's end."""
    order = np.argsort(mask != 0, axis=1, kind="stable")
    return np.take_along_axis(ids, order, axis=1), np.take_along_axis(mask, order, axis=1)


def prompt_ids(texts: list[str], vocab_size: int) -> tuple[np.ndarray, np.ndarray]:
    return left_flush(*traffic.ids(texts, vocab_size, left=True))


def judge(plan, seed: int, spec, done, picked, device, block: int) -> list[dict]:
    """``offline.judge`` with the LFM2 reference and the program's prompt
    layout."""
    model_cfg = plan.config["model"]
    raw = make(seed, spec, text_encoder=model_cfg["text_encoder"],
               codebook_size=model_cfg["audio_encoder"]["codebook_size"], device=device,
                       dtype=DTYPES[plan.config["dtype"]])
    w = Weights(raw)
    picked = [(i, r) for i, r in picked if r < len(done[i].audio)]
    sampling = plan.traffic["sampling"]
    blocks = [[p for p in picked if done[p[0]].call.greedy == g] for g in (True, False)]
    out = []
    for rows in [b[i:i + block] for b in blocks for i in range(0, len(b), block)]:
        greedy = done[rows[0][0]].call.greedy
        calls = [done[i].call for i, _ in rows]
        desc = [traffic.ids(c.descriptions, model_cfg["text_encoder"]["vocab_size"], left=False) for c in calls]
        prompt = [prompt_ids(c.prompts, model_cfg["vocab_size"]) for c in calls]

        def stack(parts, which):
            return torch.as_tensor(np.stack([p[which][r] for p, (_, r) in zip(parts, rows)]), device=device)

        out += tts_lfm2.judge(
            w, model_cfg, desc_ids=stack(desc, 0), desc_mask=stack(desc, 1), prompt_ids=stack(prompt, 0),
            prompt_mask=stack(prompt, 1), tokens=torch.stack([done[i].tokens[r] for i, r in rows]).to(device),
            audio=[torch.as_tensor(done[i].audio[r], device=device) for i, r in rows],
            top_k=0 if greedy else sampling["top_k"], temperature=sampling["temperature"])
    return out


def model_flops(config: dict, done, max_length: int) -> float:
    return sum(flops_lfm2.tts_row(config, len(desc.split()), len(prompt.split()), max_length)
               for d in done for desc, prompt in zip(d.call.descriptions, d.call.prompts))


def attn_fwd_bound(config: dict, c: traffic.Call) -> float:
    _, mask = prompt_ids(c.prompts, config["vocab_size"])
    return flops_lfm2.attn_fwd_bound(config, [list(row) + [1] for row in mask.tolist()])


_profile = base.profile


def profile(fn, device):
    """``offline.profile`` with the program's counters over the call kept."""
    from parler_tts_tpu_torch.utils import profiling

    before = profiling.counters()
    out = _profile(fn, device)
    after = profiling.counters()
    PROFILED.clear()
    PROFILED.update({name: n - before.get(name, 0) for name, n in after.items()})
    return out


base.build, base.judge, base.model_flops, base.attn_fwd_bound, base.profile = (build, judge, model_flops,
                                                                             attn_fwd_bound, profile)


def run(plan, *, seed: int, seconds: float, trace: bool, device: torch.device, process_start: float) -> dict:
    if not supported():
        print("perfbench: this program has no LFM2 block family (DecoderConfig.block_type)", file=sys.stderr)
        raise SystemExit(2)
    result = base.run(plan, seed=seed, seconds=seconds, trace=trace, device=device, process_start=process_start)
    facts = result["facts"]
    if trace and facts:
        facts["counters"] = dict(PROFILED)
        facts["kernels"]["moe_experts"] = harness.kernel_names(plan.root, "moe_experts")
        facts["bounds"]["moe_experts"] = flops_lfm2.experts_bound(
            plan.config["model"], PROFILED.get("moe.experts_touched", 0), PROFILED.get("moe.assignments", 0))
    return result
