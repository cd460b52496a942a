"""The controls of an offline cell's comparison, run on the card at the
cell's own size (never by the benchmark's runs).

    python perfbench/control.py --workload <name> --seeds 1 2 3 [--seconds S]

For each seed, as a run of the cell does: the model with the seed's
weights, the cell's traffic and a short window of calls.  Then, the program
freed, on the same rows of its greedy and its sampled calls that a run
draws, the program's readings (the lower ones) beside the control's: the
reference put in the program's place one precision below the
configuration's bfloat16, its weights rounded to float8 e4m3 and computed
in bfloat16.  Teacher-forced on the program's tokens, the control's token
at each chosen step (its best on a greedy row; on a sampled row its
Gumbel-max sample over its own top k, the noise drawn from the seed) is
read by the float32 reference as the program's are (``mean_gap``, the
widest ``logit_gap``, ``topk_excess``); its decode of the same codes gives
its ``wave_rel_err``.  One JSON line per seed on standard output: the
program's largest reading over the rows and the control's smallest.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def fp8(name: str, t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(t.dtype)


@torch.no_grad()
def control_rows(raw: dict, cfg: dict, rows: list[dict], sampling: dict, seed: int) -> list[dict]:
    """The fp8 control's readings of single rows (``desc_ids``,
    ``desc_mask``, ``prompt_ids``, ``prompt_mask``, ``tokens``, each with a
    batch of one, and ``greedy``); a sampled row's token is drawn at the
    mix's ``sampling``."""
    from perfbench.reference import Weights, decoder, exact_fp32, t5
    from perfbench.reference import tts as reference

    def run(w, r):
        with exact_fp32():
            enc = decoder.text_states(w, t5.encode(w.sub("text_encoder."), cfg["text_encoder"], r["desc_ids"],
                                                   r["desc_mask"]), r["desc_mask"])
            logits = decoder.logits(w, cfg, enc, r["desc_mask"], r["prompt_ids"], r["prompt_mask"],
                                    r["tokens"][:, :, :-1]).float()
            return logits, reference.vocode(w, cfg, decoder.undelay(r["tokens"]))[0].float()

    exact_w, low_w = Weights(raw), Weights(raw, dtype=torch.bfloat16, transform=fp8)
    out = []
    for n, r in enumerate(rows):
        exact, exact_audio = run(exact_w, r)
        low, low_audio = run(low_w, r)
        k, t = r["tokens"].shape[1], r["tokens"].shape[2]
        chosen = decoder.delay_pattern(k, t, low.device)
        if r["greedy"]:
            token = low.argmax(-1)
        else:
            scaled = low / sampling["temperature"]
            kth = torch.topk(scaled, sampling["top_k"], dim=-1).values[..., -1:]
            u = torch.rand(scaled.shape, generator=torch.Generator(low.device).manual_seed(seed * 1000 + n),
                           device=low.device).clamp_min(torch.finfo(torch.float32).tiny)
            token = torch.where(scaled < kth, float("-inf"), scaled - torch.log(-torch.log(u))).argmax(-1)
        tokens = torch.cat([r["tokens"][:, :, :1], token.to(r["tokens"].dtype)], dim=2)
        reading = {"wave_err": float((low_audio - exact_audio).norm() / exact_audio.norm())}
        if r["greedy"]:
            gap = decoder.token_gaps(exact, tokens, chosen)
            reading.update(gap=float(gap.max()), mean_gap=float(gap.sum() / chosen[:, 1:].sum()))
        else:
            excess = decoder.topk_excess(exact, tokens, chosen, sampling["top_k"], sampling["temperature"])
            reading.update(topk_excess=float(excess.sum() / chosen[:, 1:].sum()))
        out.append(reading)
    return out


def readings(plan, seed: int, seconds: float, device: torch.device) -> dict:
    from perfbench import harness, traffic, weights

    off = harness.load_module(plan.driver)
    mix = plan.traffic
    cfg, model, spec = off.build(plan, seed, device)
    sampled, greedy = off.pipelines(plan, cfg, model, device)
    done = []
    with off.recording(off.Spans(device, on=False), cfg.sampling_rate) as kept:
        start = time.perf_counter()
        while len(done) % mix["greedy_every"] or not done or time.perf_counter() - start < seconds:
            c = traffic.call(mix, seed, len(done))
            done.append(off.call_once(greedy if c.greedy else sampled, c, mix["max_seconds"], kept, True))
    for d in done:
        if d.tokens is not None:
            d.tokens = d.tokens.cpu()
    del sampled, greedy, model, kept
    gc.collect()
    torch.cuda.empty_cache()
    picked = off.pick_rows(done, mix["check_rows"], seed) + off.pick_rows(done, mix["check_sampled_rows"], seed,
                                                                          False)
    program = off.judge(plan, seed, spec, done, picked, device, mix["check_block"])

    model_cfg = plan.config["model"]
    raw = weights.make(seed, spec, codebook_size=model_cfg["audio_encoder"]["codebook_size"], device=device,
                       dtype=off.DTYPES[plan.config["dtype"]])
    rows = []
    for i, r in picked:
        c = done[i].call
        desc = traffic.ids(c.descriptions, model_cfg["text_encoder"]["vocab_size"], left=False)
        prompt = traffic.ids(c.prompts, model_cfg["vocab_size"], left=True)
        rows.append({"desc_ids": torch.as_tensor(desc[0][r:r + 1], device=device),
                     "desc_mask": torch.as_tensor(desc[1][r:r + 1], device=device),
                     "prompt_ids": torch.as_tensor(prompt[0][r:r + 1], device=device),
                     "prompt_mask": torch.as_tensor(prompt[1][r:r + 1], device=device),
                     "tokens": done[i].tokens[r:r + 1].to(device), "greedy": c.greedy})
    control = control_rows(raw, model_cfg, rows, mix["sampling"], seed)
    out = {"seed": seed, "calls": len(done), "rows": len(picked), "device": torch.cuda.get_device_name(device)}
    # a greedy row's gaps, a sampled row's excess (its gaps are the sampler's), every row's waveform
    greedy = [r["greedy"] for r in rows]
    for key, name, kind in (("gap", "logit_gap", (True,)), ("mean_gap", "mean_gap", (True,)),
                            ("topk_excess", "topk_excess", (False,)), ("wave_err", "wave_rel_err", (True, False))):
        out[name] = max(x[key] for x, g in zip(program, greedy) if g in kind)
        out[name + "_control"] = min(x[key] for x, g in zip(control, greedy) if g in kind)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    plan = harness.plan(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("perfbench: the controls need a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(plan, seed, args.seconds, torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
