"""The harness on the CPU: what its modules import, a cell added by files
alone, the FLOP and byte counts, and the offline driver run end to end at a
tiny size, whole and with its timed path broken underneath."""

from __future__ import annotations

import ast
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import flops, harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``parler_tts_tpu_torch`` is the
    program, ``parler_tts_tpu`` the JAX package."""
    found = imported_roots(path) & {"jax", "jaxlib", "flax", "parler_tts_tpu"}
    if path.is_relative_to(BENCH / "reference"):
        found |= imported_roots(path) & {"parler_tts_tpu_torch"}
    assert not found, f"{path} imports {found}"


def test_a_cell_config_mix_metric_and_kernel_list_are_added_by_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "parler-tts-mini-v0.1.json").read_text())
    (tmp_path / "perfbench/configs/tiny.json").write_text(json.dumps(config))
    mix = json.loads((BENCH / "traffic" / "offline_b96_10s.json").read_text())
    (tmp_path / "perfbench/traffic/tiny_mix.json").write_text(json.dumps({**mix, "rows": 2}))
    (tmp_path / "perfbench/metrics/rows_per_call.tiny.py").write_text("def read(facts):\n    return 2.0\n")
    (tmp_path / "perfbench/kernels/attn_fwd/other.json").write_text(json.dumps({"kernels": ["other_fwd"]}))
    (tmp_path / "perfbench/limits/tiny-cell.json").write_text(json.dumps({"mean_logit_gap": 1, "wave_rel_err": 1}))
    bench["configs"].append({"name": "tiny", "source": "x", "file": "perfbench/configs/tiny.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny", "traffic": "tiny_mix", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("tiny-cell")
    bench["per_layer"].append({"name": "rows_per_call.tiny", "unit": "rows", "better": "higher",
                               "source": "host_clock", "layer": "whole call", "moves": "audio_s_per_s",
                               "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    p = harness.plan(tmp_path, "tiny-cell")
    assert p.traffic["rows"] == 2 and p.config["name"] == "tiny"
    assert [m["name"] for m in p.per_layer] == ["rows_per_call.tiny"]
    assert harness.read_per_layer(p, {}) == {"rows_per_call.tiny": {"value": 2.0, "unit": "rows"}}
    assert harness.kernel_names(tmp_path, "attn_fwd")[-1] == "other_fwd"
    assert [m["name"] for m in harness.plan(tmp_path, CELLS[0]).per_layer] == \
        [m["name"] for m in harness.plan(ROOT, CELLS[0]).per_layer]
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "tiny-cell", "--dry"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1])["per_layer"] == ["rows_per_call.tiny"]


def test_a_checkout_without_a_card_or_the_program_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files(cell):
    p = harness.plan(ROOT, cell)
    assert {"mean_logit_gap", "wave_rel_err"} <= set(p.limits)
    assert p.per_layer and p.end_to_end


def test_causal_pairs_and_attention_counts_by_hand():
    assert flops.causal_pairs([1, 1, 1]) == 6
    assert flops.causal_pairs([0, 0, 1, 1, 0, 1]) == 1 + 2 + 3
    ops, nbytes = flops.attention_fwd(bh=2, tq=3, tk=3, d=4, pairs=12)
    assert ops == 4 * 4 * 12
    assert nbytes == 2 * 4 * 2 * (2 * 3 + 2 * 3) + 4 * 2 * 3


def test_model_counts_by_hand():
    cfg = {"d_model": 2, "num_heads": 1, "d_kv": 2, "d_ff": 3, "num_layers": 1, "is_gated_act": True}
    # q, k, v, o: 4 * 2 * 2; wi_0, wi_1, wo: 3 * 2 * 3; per token x 2 FLOPs; attention 4 * 2 * L^2
    assert flops.t5(cfg, 5) == 2 * 5 * (16 + 18) + 4 * 2 * 25
    full = {"decoder": {"num_hidden_layers": 1, "hidden_size": 2, "ffn_dim": 4, "vocab_size": 3, "num_codebooks": 2},
            "text_encoder": {"d_model": 2}}
    # one step at context 3 with 2 encoder tokens: 6 H^2 + 2 H F per token, 4 H (ctx + enc), heads 2 H V K
    assert flops.decode_steps(full, 3, 1, 2) == 2 * (6 * 4 + 2 * 2 * 4) + 4 * 2 * 2 + 2 * 2 * 3 * 2 + 4 * 2 * 3
    assert flops.decode_steps(full, 3, 2, 2) - flops.decode_steps(full, 3, 1, 2) == \
        flops.decode_steps(full, 4, 1, 2)
    dac = {"latent_dim": 2, "decoder_hidden_size": 4, "codebook_dim": 1, "upsampling_ratios": [2]}
    # out-proj 2*K*1*2*F, conv_in 2*2*4*7*F, conv_up 2*4*2*4*F, 3 units at 2 channels over 2F, conv_out 2*2*7*2F
    f = 3
    assert flops.dac_decode(dac, f, 1) == (2 * 1 * 2 * f + 2 * 2 * 4 * 7 * f + 2 * 4 * 2 * 4 * f
                                           + 3 * (2 * 4 * 7 * 2 * f + 2 * 4 * 2 * f) + 2 * 2 * 7 * 2 * f)


@pytest.mark.parametrize("ops,nbytes", [(1e12, 1.0), (1.0, 1e9), (5e11, 2e9)])
def test_a_kernel_at_its_bound_reads_100_percent_and_never_more(ops, nbytes):
    bound = flops.bound_seconds(ops, nbytes)
    assert flops.share(bound, bound) == pytest.approx(100.0)
    assert flops.share(bound, bound * 1.5) < 100.0
    assert bound >= ops / flops.PEAK_BF16_FLOPS and bound >= nbytes / flops.PEAK_HBM_BYTES_PER_S


def test_traffic_sends_the_same_sizes_in_another_order():
    mix = json.loads((BENCH / "traffic" / "offline_b96_10s.json").read_text())
    a, b = traffic.call(mix, 2**31 + 7, 0), traffic.call(mix, 3**20, 0)
    assert sorted(len(t.split()) for t in a.descriptions) == sorted(len(t.split()) for t in b.descriptions)
    assert a.descriptions != b.descriptions
    for texts, vocab, left in ((a.prompts, 32128, True), (a.descriptions, 32128, False)):
        assert traffic.ids(texts, vocab, left=left)[0].shape == (mix["rows"], 64)
    assert traffic.call(mix, 5, 0) == traffic.call(mix, 5, 0)


# -- the offline driver end to end on the CPU, whole and broken -----------------


def tiny_plan(codec: str = "dac") -> harness.Plan:
    from parler_tts_tpu_torch.core import config as C

    cfg = C.dummy_config(4)
    if codec == "encodec":
        cfg = dataclasses.replace(cfg, audio_encoder=C.EncodecConfig(num_codebooks=4, num_filters=4, hidden_size=16,
                                                                    codebook_dim=16, target_bandwidths=(1.5, 3.0)))
    else:
        cfg = dataclasses.replace(cfg, audio_encoder=dataclasses.replace(
            cfg.audio_encoder, num_codebooks=4, decoder_hidden_size=32, latent_dim=16))
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_hidden_layers=2, hidden_size=64,
                                                               ffn_dim=128, num_attention_heads=4))
    cell = harness.plan(ROOT, CELLS[0])
    # prompts of one length: a shorter prompt's mask would meet the prefill's
    # contiguous key bounds (PERF.md, Open questions), which fp32 shows here
    mix = {**cell.traffic, "rows": 4, "max_seconds": 0.2, "prompt_words": [6, 6], "description_words": [2, 7],
           "check_rows": 3, "check_sampled_rows": 3, "check_block": 2}
    return dataclasses.replace(cell, config={"name": "tiny", "dtype": "float32",
                                             "model": json.loads(json.dumps(cfg.to_dict()))}, traffic=mix)


def run_tiny(plan, seconds=0.5):
    driver = harness.load_module(plan.driver)
    return driver.run(plan, seed=2**31 + 99, seconds=seconds, trace=False, device=torch.device("cpu"),
                      process_start=time.perf_counter())


@pytest.mark.parametrize("codec", ["dac", "encodec"])
def test_the_driver_is_correct_on_the_cpu(codec):
    r = run_tiny(tiny_plan(codec))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 4
    assert r["checks"]["mean_logit_gap"]["value"] < 1e-5
    assert r["checks"]["topk_excess"]["value"] < 1e-5
    assert r["checks"]["sampled_rows_checked"]["value"] == 3
    assert r["end_to_end"]["audio_s_per_s"] > 0


def _alter_tokens(real):
    """Tokens altered where they are produced: every token of codebook 0
    moved to the next code."""
    def broken(*args, **kwargs):
        tokens, t = real(*args, **kwargs)
        tokens = tokens.clone()
        tokens[:, 0, 1:-1] = (tokens[:, 0, 1:-1] + 1) % 1024
        return tokens, t
    return broken


def _alter_audio(real):
    """An answer altered where it is produced: the waveform at half its level."""
    def broken(*args, **kwargs):
        return real(*args, **kwargs) * 0.5
    return broken


def _drop_half(real):
    """Half of the batch left out: the call returns its first half of rows."""
    def broken(self, *args, **kwargs):
        sr, audio = real(self, *args, **kwargs)
        return sr, audio[: len(audio) // 2]
    return broken


def _no_top_k(real):
    """The sampler's top-k filter dropped: every token of the vocabulary
    can be drawn."""
    def broken(logits, k):
        return logits
    return broken


def _other_row(real):
    """A sampled token drawn from the logits of the sampler's next row (its
    rows are the (batch, codebook) pairs)."""
    def broken(logits, gen, *, noise=None):
        out = real(logits, gen, noise=noise)
        return out.flatten().roll(1).view_as(out) if gen.do_sample else out
    return broken


@pytest.mark.parametrize("fault", ["token", "audio", "half", "top_k", "row"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from parler_tts_tpu_torch import pipeline
    from parler_tts_tpu_torch.generation import generate as gen_mod
    from parler_tts_tpu_torch.generation import sampling
    from parler_tts_tpu_torch.models import codec as codec_mod

    target = {"token": (gen_mod, "generate_tokens", _alter_tokens), "audio": (codec_mod, "decode", _alter_audio),
              "half": (pipeline.ParlerTTSPipeline, "tts", _drop_half),
              "top_k": (sampling, "apply_top_k", _no_top_k),
              "row": (sampling, "select_tokens", _other_row)}[fault]
    monkeypatch.setattr(target[0], target[1], target[2](getattr(target[0], target[1])))
    r = run_tiny(tiny_plan())
    assert not r["correct"], r["checks"]
