"""The controls on the card: each offline cell's lower-precision control
fails its comparison, and the served path passes it, on one seed at the
cell's own size (``perfbench/control.py`` reads a dozen)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from perfbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    plan = harness.plan(ROOT, cell)
    r = control.readings(plan, 2**31 + 17, 1.0, torch.device("cuda"))
    limits = plan.limits
    assert r["mean_gap"] <= limits["mean_logit_gap"] and r["wave_rel_err"] <= limits["wave_rel_err"], r
    assert r["topk_excess"] <= limits["topk_excess"], r
    assert r["mean_gap_control"] > limits["mean_logit_gap"], r
    assert r["topk_excess_control"] > limits["topk_excess"], r
    assert r["wave_rel_err_control"] > limits["wave_rel_err"], r
