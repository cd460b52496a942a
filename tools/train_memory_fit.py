#!/usr/bin/env python3
"""Peak device memory of Mini's train step against its shape, and the fit
``peak = F + a * batch * fused_len`` that ``training/autotune.py`` uses.

    python3 tools/train_memory_fit.py

Mini at full width (fp32 parameters, bf16 compute, AdamW with the smoke
run's recipe, dropout 0.1; batches from ``chip_smoke.mini_batch``: fused
length = 32 prompt positions + seconds x 86 frames + 11), without and with
per-layer recompute.  After one warm-up step (AdamW's moments exist from
then on), each shape runs two steps after ``reset_peak_memory_stats`` and
records ``max_memory_allocated`` and the second step's synchronised wall
time (host included: the eager step is host-bound at small shapes).  A
shape that runs out of memory is recorded as such and left out of the fit.
Prints ``nvidia-smi``'s name and power limit, the card's ``total_memory``,
a JSON line per shape and one per mode with the least-squares F and a and
each point's residual.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SHAPES = ((3, 10), (1, 30), (8, 10), (4, 30), (16, 10), (8, 30))  # (batch, seconds of audio per row)


def main() -> int:
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from parler_tts_tpu_torch.core import config as cfg_mod
    from parler_tts_tpu_torch.models import parler
    from parler_tts_tpu_torch.training import data as data_mod
    from parler_tts_tpu_torch.training import step as step_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"total_memory": torch.cuda.get_device_properties(0).total_memory}), flush=True)
    cfg = cfg_mod.mini_600m_config()
    rng = np.random.default_rng(0)
    for remat in (False, True):
        model = parler.init(0, cfg, device="cuda")
        state = step_mod.create_state(model, learning_rate=9.5e-4, warmup_steps=1, b1=0.9, b2=0.99,
                                      weight_decay=0.01, max_grad_norm=1.0)
        train_step = step_mod.make_train_step(cfg, dtype=torch.bfloat16, dropout_seed=0, remat=remat)
        points = []
        for i, (b, seconds) in enumerate(((1, 10),) + SHAPES):
            batch = cs.mini_batch(cfg, data_mod, seconds=seconds, prompt_lens=rng.integers(20, 33, b),
                                  desc_lens=rng.integers(30, 49, b), seed=seconds)
            tokens = b * (32 + batch["labels"].shape[2])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            try:
                for _ in range(1 if i == 0 else 2):
                    t0 = time.perf_counter()
                    loss = train_step(state, batch)["loss"].item()
                    step_ms = 1e3 * (time.perf_counter() - t0)
            except torch.cuda.OutOfMemoryError:
                print(json.dumps({"remat": remat, "batch": b, "seconds": seconds, "tokens": tokens, "oom": True}),
                      flush=True)
                torch.cuda.empty_cache()
                continue
            peak = torch.cuda.max_memory_allocated()
            if i == 0:
                continue  # warm-up: AdamW's moments are allocated in it
            points.append((tokens, peak))
            print(json.dumps({"remat": remat, "batch": b, "seconds": seconds, "tokens": tokens, "peak_bytes": peak,
                              "peak_gb": peak / 1e9, "loss": loss, "step_ms": step_ms}), flush=True)
        x, y = np.array([p[0] for p in points], float), np.array([p[1] for p in points], float)
        a, f = np.polyfit(x, y, 1)
        print(json.dumps({"remat": remat, "fixed_bytes": f, "bytes_per_token": a, "fixed_gb": f / 1e9,
                          "mb_per_token": a / 1e6, "residual_gb": ((y - (f + a * x)) / 1e9).tolist()}), flush=True)
        del model, state, train_step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
