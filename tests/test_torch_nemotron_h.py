"""The Nemotron-H block family as the codec decoder (``models/nemotron_h.py``,
``ops/ssm.py``, ``ops/moe.py``) against the plain reference
(``perfbench/reference/nemotron_h.py``) on the CPU in float32, at a size
that keeps every kind of block in the published pattern's order (a 7-block
``MEM*EME`` stack at hidden 64): Mamba-2 mixers of 4 heads x 8 over a state
of 16 in 2 groups, a chunk of 4 positions, GQA of 8 query heads over 2 K/V
heads at head dim 16 (not hidden / heads), MoE layers routing 3 of 16 relu2
experts plus a shared one, prompts of different lengths in one batch (each
padded on the left).  The weights are the benchmark's
(``drivers/offline_nemotron_h.make``: ``perfbench/weights.py`` with the
Mamba layers at the published Mamba-2 init), at small widths, the
projections at the output scale of the published widths (``unit_projections``).

Tolerances: the program and the reference compute the same float32
arithmetic in another order (fused projections, the chunked scan against the
step-by-step recurrence, flash attention's online softmax, the experts'
sums), so logits (about 1 in size) agree to a few 1e-7; 2e-5 leaves room for
that and catches any changed term, which moves them by 1e-3 or more here.
A greedy token's gap below the reference's best is 0 exactly when it is the
reference's argmax."""

from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.core import config as C
from parler_tts_tpu_torch.generation import generate as G
from parler_tts_tpu_torch.models.decoder import init_cache
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from parler_tts_tpu_torch.ops import moe, ssm
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils import profiling
from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer
from perfbench import harness, traffic, weights
from perfbench.reference import Weights, decoder, nemotron_h, t5, tts_nemotron_h

ROOT = Path(__file__).resolve().parents[1]
CELL = "nemotronh-offline-b128-10s"
CONFIG_FILE = ROOT / "perfbench/configs/nemotron-3-nano-30b-a3b-ep8-encodec24k.json"
ATOL = 2e-5
SMALL_ENCODEC = dict(num_codebooks=4, num_filters=4, hidden_size=16, codebook_dim=16, target_bandwidths=(1.5, 3.0))
#: the configuration file's Mamba init keys
TIME_STEPS = {"time_step_min": 0.001, "time_step_max": 0.1, "time_step_floor": 0.0001}
driver = harness.load_module(ROOT / "perfbench/drivers/offline_nemotron_h.py", "perfbench_offline_nemotron_h_test")


def flush(ids, mask):
    """Each row's valid ids moved, in order, to the row's end: the layout
    ``generate``'s prefill gives a prompt, which the reference is given."""
    order = np.argsort(mask != 0, axis=1, kind="stable")
    return np.take_along_axis(ids, order, axis=1), np.take_along_axis(mask, order, axis=1)


def tiny(experts_held: int = 0, first_expert: int = 0) -> C.ParlerTTSConfig:
    base = C.dummy_config(4)
    dec = C.DecoderConfig(vocab_size=1088, hidden_size=64, num_hidden_layers=7, num_attention_heads=8,
                          num_codebooks=4, max_position_embeddings=1024, block_type="nemotron_h",
                          layer_types=C.nemotron_h_layer_types("MEM*EME"), num_key_value_heads=2, num_experts=16,
                          num_experts_per_tok=3, moe_intermediate_size=32, use_expert_bias=True,
                          routed_scaling_factor=2.5, attention_head_dim=16, mamba_num_heads=4, mamba_head_dim=8,
                          ssm_state_size=16, mamba_n_groups=2, conv_kernel=4, use_conv_bias=True, chunk_size=4,
                          moe_shared_expert_intermediate_size=48, experts_held=experts_held,
                          first_expert=first_expert)
    return dataclasses.replace(base, vocab_size=512, audio_encoder=C.EncodecConfig(**SMALL_ENCODEC), decoder=dec)


def file_config(cfg: C.ParlerTTSConfig) -> dict:
    return {"name": "tiny", "dtype": "float32", **TIME_STEPS, "model": json.loads(json.dumps(cfg.to_dict()))}


def unit_projections(make):
    """The cell driver's ``make`` with the decoder's projections (kernels,
    experts, LM heads; not the convolution's taps) scaled to the output
    scale the published widths give them (std 0.02 over 2688 or 4096
    inputs: about 1), so that at hidden 64 the state carries as large a
    share of a Mamba layer's output, and the logits spread as widely, as at
    full size."""
    def scaled(seed, spec, **kwargs):
        w = make(seed, spec, **kwargs)
        for name, t in w.items():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("decoder.") and (leaf in ("up", "down") or leaf == "kernel" and ".conv." not in name):
                t.mul_((0.02 * t.shape[-2] ** 0.5) ** -1)
        return w
    return scaled


make = unit_projections(driver.make)


def build(cfg, seed=11):
    model = ParlerTTSModel(cfg).eval().requires_grad_(False)
    raw = make(seed, weights.layout(model), config=file_config(cfg), codebook_size=cfg.audio_encoder.codebook_size,
               device="cpu", dtype=torch.float32)
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
    cfg = tiny(experts_held=8, first_expert=4)  # one card's share: experts 4-11 of 16
    return (cfg, *build(cfg))


def _text_states(w, d, di, dm):
    return decoder.text_states(w, t5.encode(w.sub("text_encoder."), d["text_encoder"], di, dm), dm)


def _forward(model, di, dm, pi, pm, ids):
    hidden = model.decoder(ids, encoder_hidden_states=model.encode_text(di, dm), encoder_attention_mask=dm,
                           prompt_hidden_states=model.embed_prompts(pi),
                           attention_mask=torch.cat([pm, torch.ones(ids.shape[0], ids.shape[2], dtype=pm.dtype)], 1))
    return model.decoder.logits(hidden, num_labels=ids.shape[2])


def test_full_forward_logits_match_the_reference(built):
    cfg, model, w, d = built
    di, dm, pi, pm = inputs(cfg)
    ids = torch.randint(0, 1024, (3, 4, 13), generator=torch.Generator().manual_seed(1))
    ref = nemotron_h.logits(w, d, _text_states(w, d, di, dm), dm, pi, pm, ids)
    assert ref.abs().max() > 0.1
    torch.testing.assert_close(_forward(model, di, dm, pi, pm, ids), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("do_sample,max_length", [(False, 24), (True, 24), (False, 300)])
def test_prefill_and_every_cached_step_match_the_full_forward(built, do_sample, max_length):
    """The prefill's logits, then each decode step's through the cache (the
    conv and SSM states, the GQA K/V), against the reference's full forward
    over the tokens the steps produced, at every position; greedy and
    sampled, and over several KV-read buckets."""
    cfg, model, w, d = built
    di, dm, pi, pm = inputs(cfg)
    gen = C.GenerationConfig(do_sample=do_sample, top_k=50)
    s = G.prefill(model, gen, max_length=max_length, input_ids=di, attention_mask=dm, prompt_input_ids=pi,
                  prompt_attention_mask=pm)
    assert len(s.limits) == (1 if max_length == 24 else 2)
    assert s.cache.conv.shape == (3, 3, 3, 32 + 2 * 2 * 16) and s.cache.ssm.shape == (3, 3, 4, 8, 16)
    assert s.cache.ssm.dtype == torch.float32 and s.cache.self_k.shape == (1, 3, 2, 16 + max_length, 16)
    assert s.cache.cross_k.shape[:3] == (1, 3, 8)
    logits, generator = [s.logits.clone()], torch.Generator().manual_seed(3)
    while not s.done:
        G.decode_step(model, gen, s, generator=generator)
        logits.append(s.logits.clone())
    ref = nemotron_h.logits(w, d, _text_states(w, d, di, dm), dm, pi, pm, s.tokens[:, :, :-1])
    torch.testing.assert_close(torch.stack(logits[:-1], dim=2), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [1, 3, 4, 9, 13])
def test_the_chunked_scan_is_the_recurrence_across_chunks(t):
    """``ops/ssm.ssd_scan`` at a chunk of 4 over T not a multiple of it (and
    below it, and equal to it): its outputs and its final state are the
    step-by-step recurrence's (the reference's step), from a zero state."""
    g = torch.Generator().manual_seed(t)
    b, heads, p, groups, n = 2, 4, 3, 2, 5
    x = torch.randn(b, t, heads, p, generator=g)
    dt = torch.rand(b, t, heads, generator=g)
    a = -1.0 - 15.0 * torch.rand(heads, generator=g)
    bm, cm = torch.randn(b, t, groups, n, generator=g), torch.randn(b, t, groups, n, generator=g)
    y, final = ssm.ssd_scan(x, dt, a, bm, cm, chunk=4)
    state, want = torch.zeros(b, heads, p, n), []
    rep = heads // groups
    for s in range(t):
        state, out = nemotron_h.ssm_step(state, dt[:, s], a, x[:, s], bm[:, s].repeat_interleave(rep, 1),
                                         cm[:, s].repeat_interleave(rep, 1), torch.zeros(heads))
        want.append(out)
    torch.testing.assert_close(y, torch.stack(want, 1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(final, state, atol=1e-5, rtol=1e-5)


def test_the_plain_state_step_is_the_reference_step():
    """K8's plain version (``ops/ssm.ssm_step_plain``: softplus of dt +
    dt_bias, A = -exp(A_log), the state in place, rows of B and C read by
    group, the D skip) against the reference's step, from a random state,
    with x, B, C and dt read through the row strides of the step's
    projections."""
    g = torch.Generator().manual_seed(0)
    b, heads, p, groups, n = 3, 4, 8, 2, 16
    state = torch.randn(b, heads, p, n, generator=g)
    xbc = torch.randn(b, heads * p + 2 * groups * n + 5, generator=g)
    x, bm, cm = xbc[:, :32], xbc[:, 32:64], xbc[:, 64:96]
    dt = torch.randn(b, heads + 3, generator=g)[:, 1:1 + heads]
    dt_bias, a_log, dskip = torch.randn(heads, generator=g), torch.rand(heads, generator=g) * 2.7, torch.randn(heads)
    want_state, want = nemotron_h.ssm_step(
        state.clone(), torch.nn.functional.softplus(dt + dt_bias), -torch.exp(a_log), x.view(b, heads, p),
        bm.view(b, groups, n).repeat_interleave(2, 1), cm.view(b, groups, n).repeat_interleave(2, 1), dskip)
    y = ssm.ssm_step(state, x, bm, cm, dt, dt_bias, a_log, dskip)
    torch.testing.assert_close(state, want_state, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(y, want.reshape(b, heads * p), atol=1e-6, rtol=1e-6)


def test_rows_agree_with_each_row_alone(built):
    """Rows of one batch with prompts of different lengths (padding moved to
    the front, masked as keys and zeroed around the convolution) give each
    row's own logits: padding changes nothing, in the prefill's scan and
    convolution as in attention."""
    cfg, model, _, _ = built
    di, dm, pi, pm = inputs(cfg)
    ids = torch.randint(0, 1024, (3, 4, 7), generator=torch.Generator().manual_seed(2))
    together = _forward(model, di, dm, pi, pm, ids)
    for r in range(3):
        n = int(pm[r].sum())
        alone = _forward(model, di[r:r + 1], dm[r:r + 1], pi[r:r + 1, -n:], pm[r:r + 1, -n:], ids[r:r + 1])
        torch.testing.assert_close(together[r:r + 1], alone, atol=ATOL, rtol=0)


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Eight cards' shares of a 16-expert layer (2 experts each): the routed
    parts of all eight, plus the shared expert once, are the uncut
    reference layer's output; each share counts the pairs routed elsewhere
    as such, none as dropped, and the grouped route (on CPU tensors, as the
    card runs it) gives the loop's outputs."""
    full = tiny()
    model, w, d = build(full, seed=21)
    layer = model.decoder.layers[1].mixer  # the first MoE block
    x = torch.randn(37, 64, generator=torch.Generator().manual_seed(4))
    want = nemotron_h.experts(w.sub("decoder.layers.1.mixer."), d["decoder"], x[None])[0]
    weights_, experts = moe.route(x, layer.router.kernel, layer.expert_bias, 3, scaling=2.5, fp32_logits=True,
                                  eps=1e-20)
    shared = layer.shared_down(moe.relu2(layer.shared_up(x)))
    total, held = shared.clone(), 0
    for card in range(8):
        first = 2 * card
        up, down = layer.up[first:first + 2], layer.down[first:first + 2]
        stats = [torch.zeros(4, dtype=torch.int64) for _ in range(2)]
        part = moe.experts_plain(x, up, down, weights_, experts, stats[0], act=moe.relu2, first=first)
        grouped = moe.experts_grouped(x, up, down, weights_, experts, stats[1], act=moe.relu2, first=first)
        torch.testing.assert_close(grouped, part, atol=1e-6, rtol=0)
        mine = int(((experts >= first) & (experts < first + 2)).sum())
        assert stats[0].tolist() == stats[1].tolist()
        assert stats[0][0] == 37 * 3 and stats[0][2] == 0 and stats[0][3] == 37 * 3 - mine
        total, held = total + part, held + mine
    assert held == 37 * 3
    torch.testing.assert_close(total, want, atol=ATOL, rtol=0)
    torch.testing.assert_close(layer(x[None])[0], want, atol=ATOL, rtol=0)


def test_tts_rows_of_one_batch_at_different_lengths(built):
    """``tts`` over the Nemotron-H decoder (the eager CPU loop), prompts of
    1-9 words in one batch: every greedy token is the reference's argmax on
    its row, and every waveform the reference's decode of its tokens.  The
    counters count the call's routed pairs and those held elsewhere, none
    dropped, and the SSM state the kept steps read and wrote."""
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
    rows = tts_nemotron_h.judge(w, d, desc_ids=torch.as_tensor(di), desc_mask=torch.as_tensor(dm),
                                prompt_ids=torch.as_tensor(pi), prompt_mask=torch.as_tensor(pm),
                                tokens=kept["tokens"], audio=[torch.as_tensor(a) for a in audio])
    assert [r["gap"] for r in rows] == [0.0] * 4
    assert all(r["wave_err"] is not None and r["wave_err"] < 1e-5 for r in rows)

    def moved(name):
        return after.get(name, 0) - before.get(name, 0)

    steps = kept["t"] - 1  # the prefill's first frame, then one step a position
    fused, layers, routed = 16 + 1, 3, 3
    assert moved("moe.assignments") == layers * routed * 4 * (fused + steps)
    assert 0 < moved("moe.pairs_elsewhere") < moved("moe.assignments") and moved("moe.dropped") == 0
    state = 3 * 4 * 4 * 8 * 16 * 4  # Mamba layers x rows x heads x head dim x N, fp32
    assert moved("decode.ssm_state_bytes") == 2 * state * steps


@pytest.mark.parametrize("captured", [False, True])
def test_state_bytes_and_elsewhere_pairs_in_spans_and_counters(built, captured, monkeypatch):
    """``generate.prefill`` and ``generate.capture`` carry the cache's
    ``ssm_bytes`` beside its K/V and conv bytes; ``decode.ssm_state_bytes``
    counts the fp32 state each kept step reads and writes
    (``KVCache.step_bytes``), and ``moe.pairs_elsewhere`` the pairs routed
    to experts held elsewhere, on the eager and the captured route (its CUDA
    calls factored out, as ``tests/test_torch_tracing.py`` does), which give
    the same tokens."""
    from tests.test_torch_tracing import _fake_captures

    cfg, model, _, _ = built
    di, dm, pi, pm = inputs(cfg)
    gen = C.GenerationConfig(do_sample=False)
    eager, _ = G.generate_tokens(model, gen, max_length=20, input_ids=di, attention_mask=dm, prompt_input_ids=pi,
                                 prompt_attention_mask=pm)
    if captured:
        _fake_captures(monkeypatch, budget=1e18)
    names = ("decode.ssm_state_bytes", "moe.pairs_elsewhere", "moe.assignments", "decode.replays")
    before = {name: profiling.counters().get(name, 0) for name in names}
    with profiling.tracing():
        tokens, t = G.generate_tokens(model, gen, max_length=20, input_ids=di, attention_mask=dm,
                                      prompt_input_ids=pi, prompt_attention_mask=pm)
    moved = {name: profiling.counters().get(name, 0) - before[name] for name in names}
    assert torch.equal(tokens, eager)
    cache = init_cache(cfg.decoder, 3, 16 + 20, di.shape[1], dtype=torch.float32, device=torch.device("cpu"))
    kinds = cache.nbytes_by_kind()
    assert kinds["ssm"] == 3 * 3 * 4 * 8 * 16 * 4 and cache.step_bytes(16)["ssm"] == 2 * kinds["ssm"]
    spans = [s for s in profiling.records() if s["name"] in ("generate.prefill", "generate.capture")]
    assert any(s["name"] == "generate.capture" for s in spans) == captured
    assert spans and all(s["attrs"]["ssm_bytes"] == kinds["ssm"] and s["attrs"]["conv_bytes"] == kinds["conv"]
                         for s in spans)
    assert moved["decode.ssm_state_bytes"] == (t - 1) * 2 * kinds["ssm"]
    assert 0 < moved["moe.pairs_elsewhere"] < moved["moe.assignments"]
    assert (moved["decode.replays"] > 0) == captured


def test_the_cell_is_planned_and_its_files_import_no_jax():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELL, "--dry"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    plan = json.loads(out.stdout.splitlines()[-1])
    assert plan["driver"] == "perfbench/drivers/offline_nemotron_h.py" and plan["chips"] == 1
    assert {"ssm_roofline.offline", "ssm_ms_per_step.offline", "mfu.offline"} <= set(plan["per_layer"])
    for name in ("reference/nemotron_h.py", "reference/tts_nemotron_h.py", "drivers/offline_nemotron_h.py",
                 "flops_nemotron_h.py", "control_nemotron_h.py"):
        tree = ast.parse((ROOT / "perfbench" / name).read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        forbidden = {"jax", "jaxlib", "flax", "parler_tts_tpu"}
        if name.startswith("reference/"):
            forbidden.add("parler_tts_tpu_torch")
        assert not roots & forbidden, (name, roots & forbidden)


def test_config_round_trips_and_the_other_configs_json_is_unchanged():
    """The configuration round-trips through JSON and its file, which holds
    the catalog row's keys with the experts held here in place of the
    published 128; the mini, EnCodec and LFM2 configurations' JSON is
    what it was before the family came in, key for key."""
    from parler_tts_tpu.core import config as jcfg

    cfg = C.nemotron_3_nano_30b_a3b_config()
    d = json.loads(json.dumps(cfg.to_dict()))
    assert C.ParlerTTSConfig.from_dict(d) == cfg and C.DecoderConfig.from_dict(d["decoder"]) == cfg.decoder
    kinds = cfg.decoder.layer_types
    assert (kinds.count("mamba"), kinds.count("moe"), kinds.count("attention")) == (23, 23, 6)
    file = json.loads(CONFIG_FILE.read_text())
    assert C.ParlerTTSConfig.from_dict(file["model"]) == cfg
    assert file["reduced"] == ["n_routed_experts"] and file["n_routed_experts"] == cfg.decoder.experts_held == 16
    assert C.nemotron_h_layer_types(file["hybrid_override_pattern"]) == kinds
    assert cfg.decoder.head_dim == file["head_dim"] == 128 and cfg.decoder.mamba_conv_dim == 6144
    for name in ("mini_600m_config", "large_2b_config", "dummy_config"):
        assert json.dumps(getattr(C, name)().to_dict()) == json.dumps(getattr(jcfg, name)().to_dict())
    for name in ("parler-tts-mini-v0.1", "parler-tts-mini-v0.1-encodec24k", "lfm2-8b-a1b-encodec24k"):
        model = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())["model"]
        assert json.loads(json.dumps(C.ParlerTTSConfig.from_dict(model).to_dict())) == model
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(cfg.decoder, layer_types=("mamba",))
    with pytest.raises(ValueError, match="are not among"):
        dataclasses.replace(cfg.decoder, first_expert=120)


def test_what_the_family_does_not_build_raises(built):
    cfg, model, _, _ = built
    with pytest.raises(NotImplementedError, match="int8 weights"):
        model.decoder.decode_params(True)
    with pytest.raises(NotImplementedError, match="int8 cache"):
        init_cache(cfg.decoder, 1, 8, 4, dtype=torch.float32, device=torch.device("cpu"), kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="training"):
        model.decoder(torch.zeros((1, 4, 3), dtype=torch.long), generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="training the Nemotron-H"):
        model.train_forward(input_ids=None, attention_mask=None, prompt_input_ids=None, prompt_attention_mask=None,
                            labels=torch.zeros((1, 4, 3), dtype=torch.long))
    from parler_tts_tpu_torch.generation import streaming
    from parler_tts_tpu_torch.parallel import mesh as M
    from parler_tts_tpu_torch.serving import BatchingEngine

    class Split:
        model_group = object()

    with pytest.raises(NotImplementedError, match="tensor parallelism for the Nemotron-H"):
        M.shard_params(model, Split())
    with pytest.raises(NotImplementedError, match="stream_generate"):
        next(streaming.stream_generate(model, C.GenerationConfig(), input_ids=None, prompt_input_ids=None))
    tok_d, tok_p = ToyTokenizer(cfg.text_encoder.vocab_size), ToyTokenizer(cfg.vocab_size)
    pipe = ParlerTTSPipeline(model, cfg, C.GenerationConfig(), tok_d, tok_p, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="batching server"):
        BatchingEngine(pipe)
    with pytest.raises(NotImplementedError, match="relu2"):
        dataclasses.replace(cfg.decoder, mlp_hidden_act="silu")
