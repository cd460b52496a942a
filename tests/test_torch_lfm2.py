"""The LFM2 block family as the codec decoder (``models/lfm2.py``,
``ops/moe.py``) against the plain reference (``perfbench/reference/
lfm2.py``) on the CPU in float32, at a size that keeps every kind of layer:
conv and attention layers, a dense and three MoE layers of 8 experts with 2
a token and the expert bias on, GQA groups of 2, prompts of different
lengths in one batch (each padded on the left).  The weights are the
benchmark's (``perfbench/weights.py``), at small widths.

Tolerances: the program and the reference compute the same float32
arithmetic in another order (fused projections, flash attention's
online softmax, the grouped experts' sums), so logits (about 1 in size)
agree to a few 1e-7; 2e-5 leaves room for that and catches any changed
term, which moves them by 1e-3 or more here.  A greedy token's gap below
the reference's best is 0 exactly when it is the reference's argmax."""

from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.core import config as C
from parler_tts_tpu_torch.generation import generate as G
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from parler_tts_tpu_torch.ops import moe
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils import profiling
from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer
from perfbench import harness, traffic, weights
from perfbench.reference import Weights, decoder, lfm2, t5, tts_lfm2

ROOT = Path(__file__).resolve().parents[1]
CELL = "lfm2moe-offline-b192-10s"
ATOL = 2e-5
SMALL_ENCODEC = dict(num_codebooks=4, num_filters=4, hidden_size=16, codebook_dim=16, target_bandwidths=(1.5, 3.0))


def flush(ids, mask):
    """Each row's valid ids moved, in order, to the row's end: the layout
    ``generate``'s prefill gives a prompt, which the reference is given."""
    order = np.argsort(mask != 0, axis=1, kind="stable")
    return np.take_along_axis(ids, order, axis=1), np.take_along_axis(mask, order, axis=1)


def tiny() -> C.ParlerTTSConfig:
    base = C.dummy_config(4)
    dec = C.DecoderConfig(vocab_size=1088, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                          num_codebooks=4, max_position_embeddings=1024, block_type="lfm2",
                          layer_types=("conv", "full_attention", "conv", "full_attention"), num_key_value_heads=2,
                          num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, num_dense_layers=1,
                          intermediate_size=96, use_expert_bias=True)
    return dataclasses.replace(base, vocab_size=512, audio_encoder=C.EncodecConfig(**SMALL_ENCODEC), decoder=dec)


def build(cfg, seed=11):
    model = ParlerTTSModel(cfg).eval().requires_grad_(False)
    raw = weights.make(seed, weights.layout(model), codebook_size=cfg.audio_encoder.codebook_size, device="cpu",
                       dtype=torch.float32)
    model.load_state_dict(raw)
    return model, Weights(raw), json.loads(json.dumps(cfg.to_dict()))


def inputs(cfg, rows=3, seed=5, prompt_words=(2, 9)):
    """Description ids right-padded, prompts of different lengths each
    padded on the left."""
    mix = {"rows": rows, "prompt_words": list(prompt_words), "description_words": [2, 8], "greedy_every": 1}
    c = traffic.call(mix, seed, 0)
    di, dm = traffic.ids(c.descriptions, cfg.text_encoder.vocab_size, left=False)
    pi, pm = flush(*traffic.ids(c.prompts, cfg.vocab_size, left=True))
    out = [torch.as_tensor(x) for x in (di, dm, pi, pm)]
    assert len(set(out[3].sum(1).tolist())) == rows  # every prompt length differs
    return out


@pytest.fixture(scope="module")
def built():
    cfg = tiny()
    return (cfg, *build(cfg))


def _text_states(w, d, di, dm):
    return decoder.text_states(w, t5.encode(w.sub("text_encoder."), d["text_encoder"], di, dm), dm)


def test_full_forward_logits_match_the_reference(built):
    cfg, model, w, d = built
    di, dm, pi, pm = inputs(cfg)
    ids = torch.randint(0, 1024, (3, 4, 12), generator=torch.Generator().manual_seed(1))
    ref = lfm2.logits(w, d, _text_states(w, d, di, dm), dm, pi, pm, ids)
    hidden = model.decoder(ids, encoder_hidden_states=model.encode_text(di, dm), encoder_attention_mask=dm,
                           prompt_hidden_states=model.embed_prompts(pi),
                           attention_mask=torch.cat([pm, torch.ones(3, 12, dtype=pm.dtype)], 1))
    prog = model.decoder.logits(hidden, num_labels=12)
    assert ref.abs().max() > 0.1
    torch.testing.assert_close(prog, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("do_sample,max_length", [(False, 24), (True, 24), (False, 300)])
def test_prefill_and_every_cached_step_match_the_full_forward(built, do_sample, max_length):
    """The prefill's logits, then each decode step's through the cache (the
    conv state and the GQA K/V), against the reference's full forward over
    the tokens the steps produced, at every position; greedy and sampled,
    and over several KV-read buckets."""
    cfg, model, w, d = built
    di, dm, pi, pm = inputs(cfg)
    gen = C.GenerationConfig(do_sample=do_sample, top_k=50)
    s = G.prefill(model, gen, max_length=max_length, input_ids=di, attention_mask=dm, prompt_input_ids=pi,
                  prompt_attention_mask=pm)
    assert len(s.limits) == (1 if max_length == 24 else 2)
    assert s.cache.conv.shape == (2, 3, 2, 64) and s.cache.self_k.shape == (2, 3, 2, 16 + max_length, 16)
    assert s.cache.cross_k.shape[:3] == (4, 3, 4)
    logits, generator = [s.logits.clone()], torch.Generator().manual_seed(3)
    while not s.done:
        G.decode_step(model, gen, s, generator=generator)
        logits.append(s.logits.clone())
    ref = lfm2.logits(w, d, _text_states(w, d, di, dm), dm, pi, pm, s.tokens[:, :, :-1])
    torch.testing.assert_close(torch.stack(logits[:-1], dim=2), ref, atol=ATOL, rtol=0)


def test_grouped_experts_match_the_loop_over_experts():
    """The grouped route (pairs sorted by expert, one grouped product per
    projection) gives the per-expert loop's outputs and counts, with some
    experts given no token; nothing is dropped."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 16, generator=g)
    router = torch.randn(16, 8, generator=g)
    bias = torch.zeros(8)
    bias[5:] = -10.0  # experts 5-7 never chosen
    w13, w2 = torch.randn(8, 16, 24, generator=g) / 4, torch.randn(8, 12, 16, generator=g) / 4
    weights_, experts = moe.route(x, router, bias, 2)
    assert set(experts.unique().tolist()) <= set(range(5))
    torch.testing.assert_close(weights_.sum(-1), torch.ones(37), atol=1e-5, rtol=0)
    stats = [torch.zeros(3, dtype=torch.int64) for _ in range(2)]
    plain = moe.experts_plain(x, w13, w2, weights_, experts, stats[0])
    grouped = moe.experts_grouped(x, w13, w2, weights_, experts, stats[1])
    torch.testing.assert_close(grouped, plain, atol=1e-5, rtol=0)
    assert stats[0].tolist() == stats[1].tolist() == [74, 5, 0]
    # by hand: one token through its two experts
    t = 3
    manual = sum(weights_[t, j] * (torch.nn.functional.silu(x[t] @ w13[e][:, :12]) * (x[t] @ w13[e][:, 12:])) @ w2[e]
                 for j, e in enumerate(experts[t].tolist()))
    torch.testing.assert_close(plain[t], manual, atol=1e-5, rtol=0)


def test_tts_rows_of_one_batch_at_different_lengths(built):
    """``tts`` over the LFM2 decoder (the eager CPU loop), prompts of 1-9
    words in one batch (the tokenizer pads them right, the batch left; the
    prefill moves each against its BOS frame, as the reference is given
    them): every greedy token is the reference's argmax on its row, and
    every waveform the reference's decode of its tokens.  The MoE
    counters count the call's routed pairs, with none dropped."""
    cfg, model, w, d = built
    tok_d, tok_p = ToyTokenizer(cfg.text_encoder.vocab_size), ToyTokenizer(cfg.vocab_size)
    pipe = ParlerTTSPipeline(model, cfg, C.GenerationConfig(do_sample=False), tok_d, tok_p, dtype=torch.float32,
                             device="cpu")
    mix = {"rows": 4, "prompt_words": [1, 9], "description_words": [2, 8], "greedy_every": 1}
    c = traffic.call(mix, 9, 0)
    kept, real = {}, G.generate_tokens

    def keep(*args, **kwargs):
        kept["tokens"], kept["t"] = real(*args, **kwargs)
        return kept["tokens"], kept["t"]

    before = profiling.counters()
    G.generate_tokens = keep
    try:
        _, audio = pipe.tts(c.descriptions, c.prompts, max_seconds=0.2)
    finally:
        G.generate_tokens = real
    after = profiling.counters()
    di, dm = traffic.ids(c.descriptions, cfg.text_encoder.vocab_size, left=False)
    pi, pm = flush(*traffic.ids(c.prompts, cfg.vocab_size, left=True))
    assert len(set(pm.sum(1).tolist())) == 4
    rows = tts_lfm2.judge(w, d, desc_ids=torch.as_tensor(di), desc_mask=torch.as_tensor(dm),
                          prompt_ids=torch.as_tensor(pi), prompt_mask=torch.as_tensor(pm), tokens=kept["tokens"],
                          audio=[torch.as_tensor(a) for a in audio])
    assert [r["gap"] for r in rows] == [0.0] * 4
    assert all(r["wave_err"] is not None and r["wave_err"] < 1e-5 for r in rows)
    steps = kept["t"] - 1  # the prefill's first frame, then one step a position
    fused = 16 + 1
    layers, routed = 3, 2  # MoE layers, experts a token
    assert after["moe.assignments"] - before.get("moe.assignments", 0) == layers * routed * 4 * (fused + steps)
    assert after["moe.dropped"] == before.get("moe.dropped", 0)
    assert 0 < after["moe.experts_touched"] - before.get("moe.experts_touched", 0) <= layers * 8 * (1 + steps)


def test_the_new_cell_driver_is_correct_on_the_cpu():
    """``perfbench/drivers/offline_lfm2.py`` end to end on the CPU at the
    tiny size, prompts of different lengths: every judged row correct."""
    cell = harness.plan(ROOT, CELL)
    mix = {**cell.traffic, "rows": 4, "max_seconds": 0.2, "prompt_words": [2, 9], "description_words": [2, 7],
           "check_rows": 3, "check_sampled_rows": 3, "check_block": 2}
    plan = dataclasses.replace(cell, config={"name": "tiny", "dtype": "float32",
                                             "model": json.loads(json.dumps(tiny().to_dict()))}, traffic=mix)
    driver = harness.load_module(plan.driver)
    r = driver.run(plan, seed=2**31 + 99, seconds=0.5, trace=False, device=torch.device("cpu"),
                   process_start=time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["checks"]["mean_logit_gap"]["value"] < 1e-5 and r["checks"]["topk_excess"]["value"] < 1e-5
    assert r["checks"]["wave_rel_err"]["value"] < 1e-5 and r["failed"] == 0


def test_the_cell_is_planned_and_its_files_import_no_jax():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELL, "--dry"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    plan = json.loads(out.stdout.splitlines()[-1])
    assert plan["driver"] == "perfbench/drivers/offline_lfm2.py" and plan["chips"] == 1
    assert {"moe_roofline.offline", "moe_ms_per_step.offline", "mfu.offline"} <= set(plan["per_layer"])
    for name in ("reference/lfm2.py", "reference/tts_lfm2.py", "drivers/offline_lfm2.py", "flops_lfm2.py"):
        tree = ast.parse((ROOT / "perfbench" / name).read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        forbidden = {"jax", "jaxlib", "flax", "parler_tts_tpu"}
        if name.startswith("reference/"):
            forbidden.add("parler_tts_tpu_torch")
        assert not roots & forbidden, (name, roots & forbidden)


def test_config_round_trips_and_mini_json_is_unchanged():
    from parler_tts_tpu.core import config as jcfg

    cfg = C.lfm2_8b_a1b_config()
    d = json.loads(json.dumps(cfg.to_dict()))
    assert C.ParlerTTSConfig.from_dict(d) == cfg
    assert C.DecoderConfig.from_dict(d["decoder"]) == cfg.decoder
    assert d["decoder"]["layer_types"][2] == "full_attention" and cfg.decoder.layer_types.count("conv") == 18
    file = json.loads((ROOT / "perfbench/configs/lfm2-8b-a1b-encodec24k.json").read_text())
    assert C.ParlerTTSConfig.from_dict(file["model"]) == cfg
    for name in ("mini_600m_config", "large_2b_config", "dummy_config"):
        assert json.dumps(getattr(C, name)().to_dict()) == json.dumps(getattr(jcfg, name)().to_dict())
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(cfg.decoder, layer_types=("conv",))


def test_what_the_family_does_not_build_raises(built):
    cfg, model, _, _ = built
    with pytest.raises(NotImplementedError, match="int8 weights"):
        model.decoder.decode_params(True)
    with pytest.raises(NotImplementedError, match="int8 cache"):
        from parler_tts_tpu_torch.models.decoder import init_cache
        init_cache(cfg.decoder, 1, 8, 4, dtype=torch.float32, device=torch.device("cpu"), kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="training"):
        model.decoder(torch.zeros((1, 4, 3), dtype=torch.long), generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="training"):
        model.train_forward(input_ids=None, attention_mask=None, prompt_input_ids=None, prompt_attention_mask=None,
                            labels=torch.zeros((1, 4, 3), dtype=torch.long))
    from parler_tts_tpu_torch.parallel import mesh as M

    class Split:
        model_group = object()

    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        M.shard_params(model, Split())


def test_the_depth_diagnosis_reads_no_gap_in_float32():
    """``perfbench/control_lfm2.py --depth`` on the CPU at the tiny size in
    float32: the served rows, the program's teacher-forced forward on each
    route and the reference agree (no gap, no expert chosen otherwise, text
    states and MoE inputs equal to a few 1e-7), one reading per MoE layer."""
    from perfbench import control_lfm2

    cell = harness.plan(ROOT, CELL)
    mix = {**cell.traffic, "rows": 4, "max_seconds": 0.2, "prompt_words": [2, 9], "description_words": [2, 7],
           "check_rows": 3, "check_sampled_rows": 3, "check_block": 2}
    plan = dataclasses.replace(cell, config={"name": "tiny", "dtype": "float32",
                                             "model": json.loads(json.dumps(tiny().to_dict()))}, traffic=mix)
    out = control_lfm2.depth(plan, 2**31 + 5, torch.device("cpu"), 3)
    assert out["rows"] == 3 and out["served.mean_gap"] == [0.0] * 3
    for route in ("grouped", "loop", "fp32_loop"):
        assert out[f"{route}.mean_gap"] == [0.0] * 3 and out[f"{route}.served_token_share"] == [1.0] * 3
        assert out[f"{route}.expert_swap_share"] == [0.0] * 3  # three MoE layers
        assert max(out[f"{route}.input_rel_err"] + out[f"{route}.text_states_rel_err"]) < 1e-5
