#!/usr/bin/env python3
"""Train-step times of several trees of this repository on one card, in turns.

    git archive <parent commit> | tar -x -C tmp/parent   # tmp/ is git-ignored
    python3 tools/train_step_pair.py tmp/parent . .:eager . tmp/parent

Each tree runs in a process of its own, with its own ``parler_tts_tpu_torch``
and ``chip_smoke.py`` (kernels built from its own sources): Mini at full
width with the smoke run's recipe and batches, 3 x 10 s then 1 x 30 s; at
each shape 2 warm-up steps, 8 timed steps (synchronised), one step under
torch.profiler and one more for the host's launch calls.  A tree written
``PATH:eager`` runs its train step on the eager route (``core/graphs.capturable``
set false; a tree without that rule cannot be asked for it).  Prints
``nvidia-smi``'s name and power limit, then a JSON line per tree and shape:
the step times, their median (the 5th of 8 sorted), the device's busy ms,
the port attention kernels' ms and the host's launch calls per step.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def run_tree(root: str, eager: bool = False) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from parler_tts_tpu_torch.core import config as cfg_mod
    from parler_tts_tpu_torch.core import graphs as graphs_mod
    from parler_tts_tpu_torch.models import parler
    from parler_tts_tpu_torch.training import data as data_mod
    from parler_tts_tpu_torch.training import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    if eager:
        if not hasattr(graphs_mod, "capturable"):
            raise SystemExit(f"{root}: no core/graphs.capturable to turn the captured route off")
        graphs_mod.capturable = lambda device, groups=(): False
    cfg = cfg_mod.mini_600m_config()
    model = parler.init(0, cfg, device="cuda")
    state = step_mod.create_state(model, learning_rate=9.5e-4, warmup_steps=1, b1=0.9, b2=0.99,
                                  weight_decay=0.01, max_grad_norm=1.0)
    train_step = step_mod.make_train_step(cfg, dtype=torch.bfloat16, dropout_seed=0)
    for seconds, prompt_lens, desc_lens in ((10, (32, 20, 27), (48, 31, 40)), (30, (26,), (48,))):
        batch = cs.mini_batch(cfg, data_mod, seconds=seconds, prompt_lens=prompt_lens, desc_lens=desc_lens,
                              seed=seconds)
        for _ in range(2):
            train_step(state, batch)
        times = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batch)["loss"].item()
            times.append(1e3 * (time.perf_counter() - t0))
        prof = cs.profile_call(lambda: train_step(state, batch))
        launches = cs.launch_profile(lambda: train_step(state, batch), 1)
        print(json.dumps({"tree": root + (":eager" if eager else ""), "seconds": seconds, "step_ms": times,
                          "median_step_ms": sorted(times)[4], "device_busy_ms": prof["device_busy_ms"],
                          "attention_ms": prof["by_category_ms"].get("port attention kernels"),
                          "host_launches_per_step": launches["host_launches_per_step"]}), flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--tree":
        run_tree(sys.argv[2], eager=sys.argv[3:] == ["--eager"])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    for tree in sys.argv[1:]:
        path, _, route = tree.partition(":")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", os.path.realpath(path)]
                       + (["--eager"] if route == "eager" else []), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
