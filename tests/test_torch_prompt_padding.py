"""Prompts of different lengths in one ``tts`` batch, on the MusicGen
decoder at fp32 on the CPU, against the benchmark's plain reference
(``perfbench/reference/decoder.py``) on the benchmark's weights.

The tokenizer pads each prompt on the right and ``tts`` the batch on the
left, so a shorter row's prompt and its BOS frame have padding between
them, which the prefill's key bounds (``ops/flash_attention.kv_bounds``,
one run of keys a row) cannot leave out.  ``generate``'s prefill moves each
row's prompt against its BOS frame and keeps each token's position: each
row's first token is then the reference's best (gap 0.0), its logits the
reference's within fp32 rounding.  The decoder fed the padded layout
directly attends to that padding, and a shorter row's first logits move by
more than 5e-4 (50 times the fp32 rounding)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.core import config as C
from parler_tts_tpu_torch.generation import generate as G
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer
from perfbench import traffic, weights
from perfbench.reference import Weights, decoder, t5


def small() -> C.ParlerTTSConfig:
    cfg = C.dummy_config(4)
    cfg = dataclasses.replace(cfg, audio_encoder=dataclasses.replace(
        cfg.audio_encoder, num_codebooks=4, decoder_hidden_size=32, latent_dim=16))
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_hidden_layers=2, hidden_size=64,
                                                                ffn_dim=128, num_attention_heads=4))


def first_step(model, w, d, ids: dict, *, prefill: bool = True) -> tuple[list[float], list[float]]:
    """Each row's first model token (codebook 0, the greedy choice) as its
    gap below the reference's best logit, and the row's largest first-step
    logit error against the reference: through ``generate``'s prefill, or
    the decoder fed the layout as it is."""
    t = {k: torch.as_tensor(v) for k, v in ids.items()}
    s = G.prefill(model, C.GenerationConfig(do_sample=False), max_length=6, **t)
    bos, logits = s.tokens[:, :, :1], s.logits
    if not prefill:
        fused = torch.cat([t["prompt_attention_mask"], torch.ones_like(t["prompt_attention_mask"][:, :1])], 1)
        hidden = model.decoder(bos, encoder_hidden_states=model.encode_text(t["input_ids"], t["attention_mask"]),
                               encoder_attention_mask=t["attention_mask"],
                               prompt_hidden_states=model.embed_prompts(t["prompt_input_ids"]), attention_mask=fused)
        logits = model.decoder.logits(hidden, num_labels=1)[:, :, 0]
    dm = t["attention_mask"]
    states = decoder.text_states(w, t5.encode(w.sub("text_encoder."), d["text_encoder"], t["input_ids"], dm), dm)
    ref = decoder.logits(w, d, states, dm, t["prompt_input_ids"], t["prompt_attention_mask"], bos)[:, :, 0]
    chosen = logits[:, 0].argmax(-1)
    gaps = ref[:, 0].amax(-1) - ref[:, 0].gather(-1, chosen[:, None])[:, 0]
    return gaps.tolist(), (logits - ref).abs().amax(dim=(1, 2)).tolist()


@pytest.mark.parametrize("seed", [2**31 + 12345, 3])
def test_every_row_s_first_token_is_the_reference_s_best(seed):
    cfg = small()
    model = ParlerTTSModel(cfg).eval().requires_grad_(False)
    raw = weights.make(seed, weights.layout(model), codebook_size=cfg.audio_encoder.codebook_size, device="cpu",
                       dtype=torch.float32)
    model.load_state_dict(raw)
    w, d = Weights(raw), json.loads(json.dumps(cfg.to_dict()))
    c = traffic.call({"rows": 4, "prompt_words": [10, 60], "description_words": [8, 40], "greedy_every": 1}, seed, 0)
    pipe = ParlerTTSPipeline(model, cfg, C.GenerationConfig(do_sample=False), ToyTokenizer(cfg.text_encoder.vocab_size),
                             ToyTokenizer(cfg.vocab_size), dtype=torch.float32, device="cpu")
    ids = pipe.tokenize(c.descriptions, c.prompts)
    shorter = ids["prompt_attention_mask"][:, -1] == 0  # padding between the prompt and the BOS frame
    assert len(set(ids["prompt_attention_mask"].sum(1).tolist())) == 4 and shorter.sum() == 3
    gaps, errs = first_step(model, w, d, ids)
    assert gaps == [0.0] * 4 and max(errs) < 1e-5

    _, errs = first_step(model, w, d, ids, prefill=False)
    errs = np.asarray(errs)
    assert (errs[~shorter] < 1e-5).all() and (errs[shorter] > 5e-4).all()
