#!/usr/bin/env python3
"""Time the demo server's ``--warmup`` on the card: every (batch, length)
bucket of ``helpers/gradio_demo/app_torch.py``'s engine, up to 64 x 30 s.

    python3 tools/serve_warmup_torch.py

Writes an artifact of Mini at full width (random weights from seed 0,
bf16, the special ids' LM-head columns zeroed as ``chip_smoke.py`` does so
that every sample runs the length of its bucket, top-k 50, the 30 s
generation length, the T5-shaped tokenizer fixture bundled) into a
temporary directory, starts ``app_torch.py <artifact> --warmup --port 0``
as a user starts it, and reads its printed bucket times.  Once it serves,
one ``POST /api`` of 1 s is timed and the server is stopped.  Prints
``nvidia-smi``'s name and power limit, the server's output, and one JSON
line: each bucket's seconds, the time to ``serving on``, the request's
latency, and ``nvidia-smi``'s peak memory.used seen while it ran (polled
every 0.5 s).  Exits 1 if the server ends before it serves.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.core import config as cfg_mod
    from parler_tts_tpu_torch.models import parler
    from parler_tts_tpu_torch.utils.tokenizer import Tokenizer

    card = cs.nvidia_smi()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="parler_serve_warmup_")
    try:
        cfg = cfg_mod.mini_600m_config()
        model = parler.init(cs.SEED, cfg, device="cuda", dtype=torch.bfloat16)
        cs.zero_special_heads(model)
        art = os.path.join(tmp, "artifact")
        ck.save_model(art, model, cfg, cfg_mod.GenerationConfig(do_sample=True, top_k=50),
                      tokenizer=Tokenizer.from_pretrained(os.path.join(cs.TOKENIZER_FIXTURES, "t5_unigram")))
        del model
        torch.cuda.empty_cache()

        peak = {"mib": 0}
        done = threading.Event()

        def poll_memory():
            while not done.wait(0.5):
                out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, timeout=30)
                if out.returncode == 0:
                    peak["mib"] = max(peak["mib"], int(out.stdout.split()[0]))

        lines: list[str] = []
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, os.path.join(REPO, "helpers", "gradio_demo", "app_torch.py"), art,
                                 "--warmup", "--port", "0"], cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=poll_memory, daemon=True).start()

        def read_stdout():
            for line in proc.stdout:
                lines.append(line)
                print(line, end="", flush=True)

        reader = threading.Thread(target=read_stdout, daemon=True)
        reader.start()
        try:
            port = None
            while port is None and proc.poll() is None:
                time.sleep(0.5)
                port = next((m.group(1) for line in list(lines)
                             if (m := re.search(r"serving on http://0\.0\.0\.0:(\d+)", line))), None)
            serving_s = time.perf_counter() - t0
            if port is None:
                reader.join(timeout=30)
                print(json.dumps({"ok": False, "rc": proc.returncode, "after_s": serving_s}), flush=True)
                return 1
            kind, body, latency = cs._http(f"http://127.0.0.1:{port}/api", dict(
                description=cs.DESCRIPTIONS[0], prompt=cs._prompts(10)[0], seed="0", max_seconds="1"))
            rate, frames = cs._wav_rate(body)
        finally:
            done.set()
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
        buckets = {m.group(1): float(m.group(2)) for line in lines
                   if (m := re.match(r"\s+bucket (\S+): ([\d.]+)s", line))}
        print(json.dumps({"card": card, "config": "mini_600m_config bf16, random weights (seed 0), top-k 50",
                          "bucket_s": buckets, "warmup_s": sum(buckets.values()), "serving_after_s": serving_s,
                          "request": {"max_seconds": 1.0, "latency_s": latency, "content_type": kind,
                                      "rate": rate, "audio_s": frames / rate},
                          "peak_memory_used_mib": peak["mib"], "ok": len(buckets) == 12 and rate == 44100}),
              flush=True)
        return 0 if len(buckets) == 12 else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
