"""``control.py`` for a cell of the LFM2 decoder: the fp8-e4m3-weight
control computed by ``reference/lfm2.py`` in place of the MusicGen
decoder's reference (run on the card, never by the benchmark's runs).

    python perfbench/control_lfm2.py --workload lfm2moe-offline-b192-10s --seeds 1 2 3 [--seconds S]
    python perfbench/control_lfm2.py --workload lfm2moe-offline-b192-10s --depth --seeds 1 [--rows 4]

The program's readings come from the cell's own driver (``drivers/
offline_lfm2.py``), as a run of the cell judges, and the control reads the
driver's weights (T5's query kernels at T5's published init).  The control
reads the rows in ``traffic.ids``'s layout; the reference and the control
read the same one, so their comparison is of precision alone.

``--depth`` looks for the cause of the program's gap at the cell's full
depth: one greedy call of the cell, then on ``--rows`` of its rows the
reference's logits beside the program's own teacher-forced forward over the
served tokens (eager, one row at a time) in the served dtype with the
grouped experts (``grouped``; a CPU tensor takes the loop), in the served
dtype with the loop over experts (``loop``), and in float32 with TF32 off
and the loop (``fp32_loop``).  For each: the relative error of the text
states the decoder attends to (``text_states_rel_err``), the mean gap of its
best tokens below the reference's best (``mean_gap``, as the judge reads a
greedy row), the share of chosen steps where it picks the served token, and
at each MoE layer the share of valid tokens whose four experts differ from
the reference's and the relative error of the layer's normed input.  One
JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import control, harness, traffic  # noqa: E402
from perfbench.reference import Weights, decoder, exact_fp32, lfm2, t5  # noqa: E402


@torch.no_grad()
def depth(plan, seed: int, device: torch.device, n_rows: int) -> dict:
    from parler_tts_tpu_torch.ops import moe

    off = harness.load_module(plan.driver)
    mix, model_cfg = plan.traffic, plan.config["model"]
    cfg, model, spec = off.build(plan, seed, device)
    _, greedy = off.pipelines(plan, cfg, model, device)
    c = traffic.call(mix, seed, 0)
    with off.recording(off.Spans(device, on=False), cfg.sampling_rate) as kept:
        done = [off.call_once(greedy, c, mix["max_seconds"], kept, True)]
    del greedy
    picked = off.pick_rows(done, n_rows, seed)
    served = off.judge(plan, seed, spec, done, picked, device, mix["check_block"])

    desc = traffic.ids(c.descriptions, model_cfg["text_encoder"]["vocab_size"], left=False)
    prompt = off.prompt_ids(c.prompts, model_cfg["vocab_size"])
    rows = []
    for _, r in picked:
        di, dm, pi, pm = (torch.as_tensor(a[r:r + 1], device=device) for a in (*desc, *prompt))
        tokens = done[0].tokens[r:r + 1].to(device)
        valid = torch.cat([pm.bool(), torch.ones(1, tokens.shape[2] - 1, dtype=torch.bool, device=device)], 1)
        rows.append(dict(di=di, dm=dm, pi=pi, pm=pm, tokens=tokens, valid=valid.reshape(-1).cpu()))

    seen: list[tuple[torch.Tensor, torch.Tensor]] = []  # each MoE layer's (normed input, sorted experts)
    real_route, real_ref, real_grouped = moe.route, lfm2.experts, moe.experts_grouped

    def route(x, router, bias, k, **kw):
        w, e = real_route(x, router, bias, k, **kw)
        seen.append((x.float().cpu(), e.sort(-1).values.cpu()))
        return w, e

    def ref_experts(lw, d, x):
        flat = x.reshape(-1, x.shape[-1])
        s = torch.sigmoid(flat @ lw("feed_forward.router.kernel"))
        choice = s + lw("feed_forward.expert_bias") if d["use_expert_bias"] else s
        e = torch.topk(choice, d["num_experts_per_tok"], dim=-1).indices
        seen.append((flat.float().cpu(), e.sort(-1).values.cpu()))
        return real_ref(lw, d, x)

    w = Weights(off.make(seed, spec, text_encoder=model_cfg["text_encoder"],
                         codebook_size=model_cfg["audio_encoder"]["codebook_size"], device=device,
                         dtype=off.DTYPES[plan.config["dtype"]]))
    lfm2.experts = ref_experts
    try:
        for row in rows:
            seen.clear()
            with exact_fp32():
                row["enc"] = decoder.text_states(w, t5.encode(w.sub("text_encoder."), model_cfg["text_encoder"],
                                                              row["di"], row["dm"]), row["dm"])
                row["ref"] = lfm2.logits(w, model_cfg, row["enc"], row["dm"], row["pi"], row["pm"],
                                         row["tokens"][:, :, :-1]).float()
            row["ref_moe"] = list(seen)
    finally:
        lfm2.experts = real_ref
    del w

    def program(name: str) -> dict:
        enc_errs, gaps, agree, swaps, errs = [], [], [], [], []
        for row in rows:
            seen.clear()
            ids, t = row["tokens"][:, :, :-1], row["tokens"].shape[2] - 1
            enc = model.encode_text(row["di"], row["dm"])
            enc_errs.append(float((enc.float() - row["enc"]).norm() / row["enc"].norm()))
            hidden = model.decoder(ids, encoder_hidden_states=enc, encoder_attention_mask=row["dm"],
                                   prompt_hidden_states=model.embed_prompts(row["pi"]),
                                   attention_mask=torch.cat([row["pm"], torch.ones_like(ids[:, 0])], 1))
            logits = model.decoder.logits(hidden, num_labels=t).float()
            chosen = decoder.delay_pattern(ids.shape[1], t + 1, device)
            best = torch.cat([row["tokens"][:, :, :1], logits.argmax(-1).to(row["tokens"].dtype)], 2)
            gaps.append(float(decoder.token_gaps(row["ref"], best, chosen).sum() / chosen[:, 1:].sum()))
            agree.append(float((best == row["tokens"])[0][:, 1:][chosen[:, 1:]].float().mean()))
            v = row["valid"]
            swaps.append([float((pe[v] != re[v]).any(-1).float().mean()) for (_, pe), (_, re) in zip(seen, row["ref_moe"])])
            errs.append([float((px[v] - rx[v]).norm() / rx[v].norm()) for (px, _), (rx, _) in zip(seen, row["ref_moe"])])
        layers = range(len(swaps[0]))
        return {f"{name}.text_states_rel_err": enc_errs, f"{name}.mean_gap": gaps,
                f"{name}.served_token_share": agree,
                f"{name}.expert_swap_share": [max(s[i] for s in swaps) for i in layers],
                f"{name}.input_rel_err": [max(e[i] for e in errs) for i in layers]}

    out = {"seed": seed, "rows": len(rows),
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "served.mean_gap": [s["mean_gap"] for s in served]}
    moe.route = route
    try:
        out.update(program("grouped"))
        moe.experts_grouped = moe.experts_plain
        out.update(program("loop"))
        model.float()
        with exact_fp32():
            out.update(program("fp32_loop"))
    finally:
        moe.route, moe.experts_grouped = real_route, real_grouped
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--depth", action="store_true")
    ap.add_argument("--rows", type=int, default=4)
    args, rest = ap.parse_known_args(argv)
    plan = harness.plan(ROOT, args.workload)
    decoder.logits = lfm2.logits
    if not args.depth:
        off, rows = harness.load_module(plan.driver), control.control_rows
        t5_cfg = plan.config["model"]["text_encoder"]
        control.control_rows = lambda raw, *a: rows(off.t5_queries(raw, t5_cfg), *a)  # the driver's weights
        return control.main(["--workload", args.workload, "--seeds", *map(str, args.seeds), *rest])
    if not torch.cuda.is_available():
        print("perfbench: the controls need a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(depth(plan, seed, torch.device("cuda"), args.rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
