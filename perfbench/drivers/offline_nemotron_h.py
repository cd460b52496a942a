"""Offline generation through the Nemotron-H decoder: ``offline.py``'s calls,
window, metrics and checks, with what differs for this decoder.

* The model is built in the served dtype directly, as
  ``drivers/offline_lfm2.py`` builds it (5.9 B parameters).
* The weights are ``weights.make``'s with T5's query kernels at T5's
  published init (``offline_lfm2.t5_queries``) and the Mamba layers at the
  published Mamba-2 init, drawn here from the seed (``mamba_init``): ``A_log
  = log(A)``, A uniform in [1, 16]; ``dt_bias`` the inverse softplus of a dt
  log-uniform in [``time_step_min``, ``time_step_max``], floored at
  ``time_step_floor``; D = 1; the convolution's taps at PyTorch's default,
  uniform within +-``conv_kernel``^-1/2.  ``weights.make``'s normal draw of
  ``A_log`` would make the state blow up or vanish within a few steps, and
  its 0.02 taps would leave the state a thousandth of the skip ``D x``.
* The judge is ``reference/tts_nemotron_h.py``, given the prompts as the
  program's prefill lays them out (``offline_lfm2.prompt_ids``).
* The model FLOPs and K1's bound are ``flops_nemotron_h.py``'s.
* A ``--trace 1`` run adds the program's counters over the profiled call
  (``facts["counters"]``: ``decode.replays``, ``decode.positions``,
  ``decode.ssm_state_bytes``, ``moe.*``), K8's bound (``bounds["ssm_step"]``)
  and its kernels (``kernels["ssm_step"]``: ``perfbench/kernels/ssm_step/``).

A program without the Nemotron-H block family fails at once, before any work.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import torch

from perfbench import flops_nemotron_h, harness, traffic, weights
from perfbench.reference import Weights
from perfbench.reference import tts_nemotron_h

base = harness.load_module(Path(__file__).with_name("offline.py"), "perfbench_offline_base_nemotron_h")
lfm2 = harness.load_module(Path(__file__).with_name("offline_lfm2.py"), "perfbench_offline_lfm2_for_nemotron_h")
DTYPES, Spans, recording, call_once, pick_rows, pipelines = (base.DTYPES, base.Spans, base.recording, base.call_once,
                                                            base.pick_rows, base.pipelines)
prompt_ids = lfm2.prompt_ids
#: the program's counters over the profiled call
PROFILED: dict[str, float] = {}


def supported() -> bool:
    from parler_tts_tpu_torch.core.config import DecoderConfig

    return "mamba_num_heads" in {f.name for f in dataclasses.fields(DecoderConfig)}


@torch.no_grad()
def mamba_init(w: dict[str, torch.Tensor], config: dict, seed: int) -> dict[str, torch.Tensor]:
    """``w``'s Mamba parameters redrawn in place at the published Mamba-2
    init, from a generator seeded from ``seed``; ``config`` is the
    configuration file (its ``time_step_*`` keys)."""
    names = sorted(n for n in w if n.rsplit(".", 1)[-1] in ("A_log", "dt_bias", "D")
                   or n.endswith("mixer.conv.kernel"))
    if not names:
        return w
    device = w[names[0]].device
    generator = torch.Generator(device=device).manual_seed((seed * 1000003 + 0x4D42) % 2**63)
    lo, hi = math.log(config["time_step_min"]), math.log(config["time_step_max"])
    for name in names:
        t, leaf = w[name], name.rsplit(".", 1)[-1]
        u = torch.rand(t.shape, generator=generator, device=device, dtype=torch.float32)
        if leaf == "A_log":
            value = torch.log(1.0 + 15.0 * u)
        elif leaf == "dt_bias":
            dt = torch.exp(lo + (hi - lo) * u).clamp(min=config["time_step_floor"])
            value = dt + torch.log(-torch.expm1(-dt))
        elif leaf == "D":
            value = torch.ones_like(u)
        else:  # the convolution's (taps, channels)
            value = (2.0 * u - 1.0) * t.shape[0] ** -0.5
        t.copy_(value)
    return w


def make(seed: int, spec, *, config: dict, **kwargs) -> dict[str, torch.Tensor]:
    """``weights.make``'s weights, T5's queries at T5's published init, the
    Mamba layers at Mamba-2's."""
    w = lfm2.t5_queries(weights.make(seed, spec, **kwargs), config["model"]["text_encoder"])
    return mamba_init(w, config, seed)


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
    w = make(seed, spec, config=plan.config, codebook_size=cfg.audio_encoder.codebook_size, device=device,
             dtype=dtype)
    model.load_state_dict(w, strict=True)
    del w
    return cfg, model, spec


def judge(plan, seed: int, spec, done, picked, device, block: int) -> list[dict]:
    """``offline.judge`` with the Nemotron-H reference and the program's
    prompt layout."""
    model_cfg = plan.config["model"]
    raw = make(seed, spec, config=plan.config, codebook_size=model_cfg["audio_encoder"]["codebook_size"],
               device=device, dtype=DTYPES[plan.config["dtype"]])
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

        out += tts_nemotron_h.judge(
            w, model_cfg, desc_ids=stack(desc, 0), desc_mask=stack(desc, 1), prompt_ids=stack(prompt, 0),
            prompt_mask=stack(prompt, 1), tokens=torch.stack([done[i].tokens[r] for i, r in rows]).to(device),
            audio=[torch.as_tensor(done[i].audio[r], device=device) for i, r in rows],
            top_k=0 if greedy else sampling["top_k"], temperature=sampling["temperature"])
    return out


def model_flops(config: dict, done, max_length: int) -> float:
    return sum(flops_nemotron_h.tts_row(config, len(desc.split()), len(prompt.split()), max_length)
               for d in done for desc, prompt in zip(d.call.descriptions, d.call.prompts))


def attn_fwd_bound(config: dict, c: traffic.Call) -> float:
    _, mask = prompt_ids(c.prompts, config["vocab_size"])
    return flops_nemotron_h.attn_fwd_bound(config, [list(row) + [1] for row in mask.tolist()])


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
        print("perfbench: this program has no Nemotron-H block family (DecoderConfig.mamba_num_heads)",
              file=sys.stderr)
        raise SystemExit(2)
    result = base.run(plan, seed=seed, seconds=seconds, trace=trace, device=device, process_start=process_start)
    facts = result["facts"]
    if trace and facts:
        facts["counters"] = dict(PROFILED)
        facts["kernels"]["ssm_step"] = harness.kernel_names(plan.root, "ssm_step")
        facts["bounds"]["ssm_step"] = flops_nemotron_h.ssm_step_bound(
            plan.config["model"], PROFILED.get("decode.ssm_state_bytes", 0), PROFILED.get("decode.positions", 0),
            PROFILED.get("decode.replays", 0))
    return result
