"""The plain reference against the program at small sizes on the CPU, in
float32, on the benchmark's own weights: T5, the decoder's teacher-forced
logits (and the program's prefill and cached decode through ``generate``),
the DAC and EnCodec decoders."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.core import config as C
from parler_tts_tpu_torch.generation import generate as G
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from perfbench import traffic, weights
from perfbench.reference import Weights, dac, decoder, encodec, t5

SMALL_ENCODEC = dict(num_codebooks=4, num_filters=4, hidden_size=16, codebook_dim=16,
                     target_bandwidths=(1.5, 3.0))


def small(codec: str) -> C.ParlerTTSConfig:
    cfg = C.dummy_config(4)
    if codec == "encodec":
        cfg = dataclasses.replace(cfg, audio_encoder=C.EncodecConfig(**SMALL_ENCODEC))
    else:
        cfg = dataclasses.replace(cfg, audio_encoder=dataclasses.replace(
            cfg.audio_encoder, num_codebooks=4, decoder_hidden_size=32, latent_dim=16))
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_hidden_layers=2, hidden_size=64,
                                                                ffn_dim=128, num_attention_heads=4))


def build(cfg, seed=11):
    torch.manual_seed(0)
    model = ParlerTTSModel(cfg).eval().requires_grad_(False)
    raw = weights.make(seed, weights.layout(model), codebook_size=cfg.audio_encoder.codebook_size, device="cpu",
                       dtype=torch.float32)
    model.load_state_dict(raw)
    return model, Weights(raw), json.loads(json.dumps(cfg.to_dict()))


def inputs(cfg, rows=3, seed=5):
    mix = {"rows": rows, "prompt_words": [6, 6], "description_words": [2, 8], "greedy_every": 1}
    c = traffic.call(mix, seed, 0)
    di, dm = traffic.ids(c.descriptions, cfg.text_encoder.vocab_size, left=False)
    pi, pm = traffic.ids(c.prompts, cfg.vocab_size, left=True)
    return [torch.as_tensor(x) for x in (di, dm, pi, pm)]


@pytest.mark.parametrize("codec", ["dac", "encodec"])
def test_t5_and_decoder_logits_match_the_program(codec):
    cfg = small(codec)
    model, w, d = build(cfg)
    di, dm, pi, pm = inputs(cfg)
    ref_enc = t5.encode(w.sub("text_encoder."), d["text_encoder"], di, dm)
    prog_enc = model.text_encoder(di, dm)
    assert torch.allclose(ref_enc, prog_enc, atol=2e-5, rtol=1e-5)

    states = decoder.text_states(w, ref_enc, dm)
    assert torch.allclose(states, model.encode_text(di, dm), atol=2e-5, rtol=1e-5)
    k = cfg.decoder.num_codebooks
    ids = torch.randint(0, 1024, (3, k, 12), generator=torch.Generator().manual_seed(1))
    ref = decoder.logits(w, d, states, dm, pi, pm, ids)
    fused = torch.cat([pm, torch.ones(3, 12, dtype=pm.dtype)], 1)
    hidden = model.decoder(ids, encoder_hidden_states=model.encode_text(di, dm), encoder_attention_mask=dm,
                           prompt_hidden_states=model.embed_prompts(pi), attention_mask=fused)
    prog = model.decoder.logits(hidden, num_labels=12)
    assert torch.allclose(ref, prog, atol=1e-4, rtol=1e-4)


def test_greedy_generation_is_the_reference_argmax():
    """The program's prefill and cached decode choose, at every step the
    delay pattern leaves to the model, the reference's best token."""
    cfg = small("dac")
    model, w, d = build(cfg)
    di, dm, pi, pm = inputs(cfg)
    gen = C.GenerationConfig(do_sample=False)
    tokens, _ = G.generate_tokens(model, gen, max_length=20, input_ids=di, attention_mask=dm, prompt_input_ids=pi,
                                  prompt_attention_mask=pm)
    states = decoder.text_states(w, t5.encode(w.sub("text_encoder."), d["text_encoder"], di, dm), dm)
    logits = decoder.logits(w, d, states, dm, pi, pm, tokens[:, :, :-1])
    chosen = decoder.delay_pattern(tokens.shape[1], 20, "cpu")
    assert float(decoder.token_gaps(logits, tokens, chosen).max()) < 1e-4
    forced = ~chosen & (torch.arange(20)[None] > torch.arange(tokens.shape[1])[:, None])
    assert bool((tokens[:, forced] == gen.pad_token_id).all())


def test_undelay_matches_the_program():
    tokens = torch.randint(0, 1024, (2, 4, 15), generator=torch.Generator().manual_seed(3))
    codes, _ = G.postprocess_tokens(tokens, small("dac"))
    assert torch.equal(decoder.undelay(tokens), codes)


@pytest.mark.parametrize("codec", ["dac", "encodec"])
def test_vocoders_match_the_program(codec):
    cfg = small(codec)
    model, w, d = build(cfg)
    codes = torch.randint(0, 1024, (2, 4, 9), generator=torch.Generator().manual_seed(2))
    module = encodec if codec == "encodec" else dac
    ref = module.decode(w.sub("audio_encoder."), d["audio_encoder"], codes)
    prog = model.audio_encoder.decode(codes)
    assert ref.shape == prog.shape
    assert float((ref - prog).norm() / ref.norm()) < 1e-5


def test_t5_buckets_match_the_published_table():
    rel = torch.arange(-200, 201)[None]
    got = t5.buckets(rel, 32, 128)[0]
    # HF's bidirectional buckets: exact below 8 each side, log-spaced to 15, +16 for positive offsets
    expect = []
    for r in rel[0].tolist():
        n, base = abs(r), (16 if r > 0 else 0)
        expect.append(base + (n if n < 8 else min(15, 8 + int(np.log(n / 8) / np.log(128 / 8) * 8))))
    assert got.tolist() == expect
