"""The Nemotron-H cell's benchmark code on the CPU: its driver end to end at
a tiny size (``tests/test_torch_nemotron_h.py``'s configuration, one card's
share of the experts), whole and with its timed path broken underneath;
``flops_nemotron_h``'s counts by hand; K8's bound and its two readers."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import flops, flops_nemotron_h, harness
from tests.test_torch_nemotron_h import file_config, tiny, unit_projections

ROOT = Path(__file__).resolve().parents[2]
CELL = "nemotronh-offline-b128-10s"
CONFIG_FILE = ROOT / "perfbench/configs/nemotron-3-nano-30b-a3b-ep8-encodec24k.json"


def test_the_new_cell_driver_is_correct_on_the_cpu():
    """``perfbench/drivers/offline_nemotron_h.py`` end to end on the CPU at
    the tiny size (one card's share of the experts), prompts of different
    lengths: every judged row correct."""
    r = _run_tiny()
    assert r["correct"], r["checks"]
    assert r["checks"]["mean_logit_gap"]["value"] < 1e-5 and r["checks"]["topk_excess"]["value"] < 1e-5
    assert r["checks"]["wave_rel_err"]["value"] < 1e-5 and r["failed"] == 0


def _run_tiny():
    cell = harness.plan(ROOT, CELL)
    mix = {**cell.traffic, "rows": 4, "max_seconds": 0.2, "prompt_words": [2, 9], "description_words": [2, 7],
           "check_rows": 3, "check_sampled_rows": 3, "check_block": 2}
    plan = dataclasses.replace(cell, config=file_config(tiny(experts_held=8, first_expert=4)), traffic=mix)
    run_driver = harness.load_module(plan.driver, "perfbench_offline_nemotron_h_run")
    run_driver.make = unit_projections(run_driver.make)
    return run_driver.run(plan, seed=2**31 + 99, seconds=0.5, trace=False, device=torch.device("cpu"),
                          process_start=time.perf_counter())


def _unwritten_state(real):
    """The step computed on a copy of the state: the cache is never
    written, every step reads the prefill's state."""
    def broken(state, *args):
        return real(state.clone(), *args)
    return broken


def _absent_experts(real):
    """The layer's share given the absent experts too: every routed pair
    computed, the held experts by their own weights and the absent ones by
    the held weights repeated over the router's other experts."""
    def broken(x, w_in, w_out, wts, exps, stats=None, *, act, first=None):
        reps = 16 // w_in.shape[0]

        def every(w):
            return torch.roll(w.repeat(reps, 1, 1), first, 0)

        return real(x, every(w_in), every(w_out), wts, exps, stats, act=act, first=0)
    return broken


@pytest.mark.parametrize("fault", ["unwritten_state", "absent_experts"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from parler_tts_tpu_torch.ops import moe, ssm

    """The cell's correctness check at the tiny size refuses a step whose SSM state
    the cache never keeps, and an expert layer that adds the experts held
    elsewhere to its share."""
    target = {"unwritten_state": (ssm, "ssm_step", _unwritten_state),
              "absent_experts": (moe, "experts", _absent_experts)}[fault]
    monkeypatch.setattr(target[0], target[1], target[2](getattr(target[0], target[1])))
    r = _run_tiny()
    assert not r["correct"], r["checks"]


def test_flops_count_by_hand():
    """``flops_nemotron_h``'s counts at a hand-sized configuration: one
    block of each kind."""
    cfg = {"decoder": {"mamba_num_heads": 2, "mamba_head_dim": 3, "ssm_state_size": 4, "mamba_n_groups": 1,
                       "experts_held": 2, "num_experts": 4, "num_experts_per_tok": 2, "hidden_size": 5,
                       "num_attention_heads": 2, "num_key_value_heads": 1, "attention_head_dim": 6,
                       "conv_kernel": 4, "moe_intermediate_size": 7, "moe_shared_expert_intermediate_size": 8,
                       "layer_types": ["mamba", "moe", "attention"], "vocab_size": 9, "num_codebooks": 2},
           "text_encoder": {"d_model": 5}}
    inner, conv = 6, 6 + 8
    mamba = 2 * 5 * (inner + conv + 2) + 2 * 4 * conv + 4 * 2 * 3 * 4 + 2 * inner * 5
    expert = 2 * 5 * 4 + 4 * 5 * 8 + 4 * (2 * 2 / 4) * 5 * 7
    attention = 2 * 5 * (2 * 12 + 2 * 6) + 2 * 2 * 5 * 12
    per_token = mamba + expert + attention
    # one step at context 3 with 2 encoder tokens: the blocks, attention 4 q ctx, cross 4 q enc, heads 2 H V K
    assert flops_nemotron_h.decode_steps(cfg, 3, 1, 2) == per_token + 4 * 12 * 3 + 4 * 12 * 2 + 2 * 5 * 9 * 2
    assert flops_nemotron_h.decoder_prefill(cfg, 2, 3) == (2 * per_token + 4 * 12 * 3 + 4 * 3 * 5 * 12
                                                           + 4 * 12 * 2 * 3 + 2 * 5 * 9 * 2)


@pytest.mark.parametrize("replays,positions", [(758, 758), (768, 758)])
def test_k8_bound_reads_100_percent_at_its_bound_and_never_more(replays, positions):
    """K8's bound from the program's state bytes: the state of the kept
    steps, per step times the launches' steps, plus the step's inputs and
    outputs; a kernel that takes exactly that long reads 100 %, a slower
    one less."""
    cfg = json.loads(CONFIG_FILE.read_text())["model"]
    state = 23 * 128 * 64 * 64 * 128 * 4
    bound = flops_nemotron_h.ssm_step_bound(cfg, 2 * state * positions, positions, replays)
    assert bound == pytest.approx(replays * (2 * state + 23 * 128 * (2 * 4096 + 2 * 1024 + 64) * 2)
                                  / flops.PEAK_HBM_BYTES_PER_S)
    reader = harness.load_module(ROOT / "perfbench/metrics/ssm_roofline.offline.py")

    class Trace:
        def __init__(self, seconds):
            self.seconds = seconds

        def kernel_seconds(self, names):
            return self.seconds if names == ["ssm_step_kernel"] else 0.0

    facts = {"bounds": {"ssm_step": bound}, "kernels": {"ssm_step": ["ssm_step_kernel"]}}
    assert reader.read({**facts, "trace": Trace(bound)}) == pytest.approx(100.0)
    assert reader.read({**facts, "trace": Trace(1.2 * bound)}) < 100.0
    per_step = harness.load_module(ROOT / "perfbench/metrics/ssm_ms_per_step.offline.py")
    assert per_step.read({**facts, "trace": Trace(0.758), "counters": {"decode.replays": replays}}) == \
        pytest.approx(1e3 * 0.758 / replays)
    assert reader.read({"trace": Trace(1.0)}) is None and per_step.read({"trace": Trace(1.0)}) is None
