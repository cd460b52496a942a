"""Metric logging: JSONL and stdout always, wandb when it imports.

The port's own copy of ``parler_tts_tpu/training/logging_utils.py``: the
same ``metrics.jsonl`` records with ``train/`` and ``eval/`` prefixes, the
same ``predictions.jsonl`` rows and WAVs under ``predictions/step-N/``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np

from parler_tts_tpu_torch.utils.audio_io import write_wav


class MetricLogger:
    def __init__(self, output_dir: str, *, report_to: str = "jsonl", run_name: str | None = None,
                 config: dict | None = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.wandb = None
        if report_to == "wandb":
            try:
                import wandb  # type: ignore

                self.wandb = wandb.init(project="parler-tts-tpu", name=run_name, config=config or {})
            except Exception:
                self.wandb = None

    def log(self, metrics: dict[str, Any], *, step: int, prefix: str = "train") -> None:
        """One record of ``{prefix}/{name}`` scalars plus ``step`` and
        ``time``."""
        rec = {f"{prefix}/{k}": _scalar(v) for k, v in metrics.items()}
        rec["step"] = int(step)
        rec["time"] = time.time()
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.wandb is not None:
            self.wandb.log(rec, step=step)
        shown = ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in rec.items()
                          if k not in ("time",))
        print(f"[{prefix}] {shown}", flush=True)

    def log_predictions(self, *, step: int, prompts, descriptions, audio,
                        sampling_rate: int, max_audios: int = 100) -> None:
        """Rows to ``predictions.jsonl``; up to ``max_audios`` non-empty
        waveforms as WAVs under ``predictions/step-{step}/`` (and to wandb
        as a table and audio when it is on)."""
        out_dir = os.path.dirname(self.path)
        rows = []
        wav_dir = os.path.join(out_dir, "predictions", f"step-{step}")
        for i, (p, d) in enumerate(zip(prompts, descriptions)):
            rec = {"step": int(step), "i": i, "prompt": p, "description": d}
            if i < len(audio) and i < max_audios and np.asarray(audio[i]).size:
                os.makedirs(wav_dir, exist_ok=True)
                wav_path = os.path.join(wav_dir, f"sample_{i}.wav")
                write_wav(wav_path, np.asarray(audio[i], np.float32), sampling_rate)
                rec["audio"] = wav_path
            rows.append(rec)
        with open(os.path.join(out_dir, "predictions.jsonl"), "a") as f:
            for rec in rows:
                f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            try:
                import wandb

                table = wandb.Table(columns=["prompt", "description"],
                                    data=[[r.get("prompt"), r.get("description")] for r in rows])
                payload: dict[str, Any] = {"eval/predictions": table}
                for i, r in enumerate(rows[:max_audios]):
                    if "audio" in r:
                        payload[f"eval/audio_{i}"] = wandb.Audio(r["audio"])
                self.wandb.log(payload, step=step)
            except Exception:
                pass

    def close(self) -> None:
        self._f.close()
        if self.wandb is not None:
            self.wandb.finish()


def _scalar(v) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
