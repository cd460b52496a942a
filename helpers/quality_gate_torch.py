"""Quality gate of the PyTorch port: mel and waveform against the torch
reference, and the serving paths against the fp32 quality path.

Counterpart of ``helpers/quality_gate.py`` (the same gates, names, report
and thresholds) over ``parler_tts_tpu_torch``, on the card unless
``--device cpu`` is given:

1. load a reference (HF Parler-TTS) checkpoint directory with
   ``core/from_reference.from_reference_pretrained``;
2. run the port's fp32 greedy ``generate`` end to end (text encode, decode
   loop, undelay, codec vocode);
3. ``fp32_vs_torch``: run the torch reference on the same inputs, greedy,
   when its stack can run here (``tests/reference_loader`` or
   ``PARLER_REFERENCE_PATH``; it is built on ``transformers``), and hold the
   log-mel spectrograms within ``FP32_MEL_MAX_DB``; otherwise record
   ``ran: false`` with the error, as the JAX gate does;
4. ``serving_vs_fp32``: the bf16 compute + int8 KV cache + int8 weights
   path against fp32: greedy token agreement, and the mel distance of the
   bf16 vocoder on the fp32 codes within ``SERVING_MEL_MEAN_DB``;
5. ``stream_vs_offline``: ``stream_generate`` (fp32, greedy) against the
   offline codes (agreement 1.0) and audio (interior within
   ``FP32_MEL_MAX_DB``);
6. ``serving_engine_vs_direct``: three requests through a
   ``BatchingEngine`` in one batch, bit for bit against a direct
   ``pipeline.tts`` of the same padded rows and folded seed (it needs a
   tokenizer directory: ``--tokenizer`` or the checkpoint's own).

Run it on a checkpoint directory::

    python helpers/quality_gate_torch.py --checkpoint /path/to/parler_tts_mini_v0.1 \\
        [--description "A female speaker..."] [--prompt "Hey, how are you?"] [--device cpu]

Prints the report as JSON and exits non-zero when a gate that could run
failed.  Mel distances come from ``parler_tts_tpu_torch/utils/mel.py``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX gate's thresholds: greedy fp32 tokens equal the reference's and the
# fp32 vocoder is 1e-5-close, so the end-to-end mel gap is numeric noise (0.2
# dB max); a bf16 vocode of the same codes stays within 1.0 dB mean log-mel
FP32_MEL_MAX_DB = 0.2
SERVING_MEL_MEAN_DB = 1.0
WORST = ("mel_max_abs_db", "mel_mean_abs_db", "wave_max_abs")


def _load_reference_module():
    """The torch reference package: through ``tests/reference_loader`` from
    the repository's root, else from the directory ``PARLER_REFERENCE_PATH``
    names, else as an installed ``parler_tts``."""
    try:
        from tests.reference_loader import load_reference

        return load_reference()
    except Exception:
        ref_path = os.environ.get("PARLER_REFERENCE_PATH")
        if ref_path and ref_path not in sys.path:
            sys.path.insert(0, ref_path)
        import parler_tts

        return parler_tts


def _synthetic_inputs(cfg, batch: int, seed: int):
    """The JAX gate's random description and prompt ids, from ``seed``."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, cfg.text_encoder.vocab_size, (batch, 7))
    prompt = rng.integers(0, cfg.vocab_size, (batch, 5))
    return desc, np.ones_like(desc), prompt, np.ones_like(prompt)


def _tokenized_inputs(tokenizer_dir: str, description: str, prompt: str):
    from parler_tts_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer.from_pretrained(tokenizer_dir)
    d, p = tok([description], return_tensors="np"), tok([prompt], return_tensors="np")
    return d.input_ids, d.attention_mask, p.input_ids, p.attention_mask


def _torch_reference_generate(ref, rmodel, desc, dmask, pr, pmask, gen) -> list[np.ndarray]:
    """Greedy decode through the torch reference's own step machinery
    (``prepare_inputs_for_generation`` + ``forward`` + the delay mask), then
    its undelay and per-sample trim, and a vocode of each sample's trimmed
    codes (through the reference's DAC wrapper, or an HF ``DacModel``'s
    API); as the JAX gate's ``_torch_reference_generate``."""
    import torch
    from transformers.modeling_outputs import BaseModelOutput  # the reference is built on transformers

    b = desc.shape[0]
    k = rmodel.decoder.config.num_codebooks
    bos = gen.decoder_start_token_id or gen.bos_token_id
    with torch.no_grad():
        enc = rmodel.text_encoder(input_ids=torch.tensor(np.asarray(desc)),
                                  attention_mask=torch.tensor(np.asarray(dmask))).last_hidden_state
        prompt_hidden = rmodel.embed_prompts(torch.tensor(np.asarray(pr)))
        input_ids = torch.full((b * k, 1), bos, dtype=torch.long)
        input_ids, delay_mask = ref.build_delay_pattern_mask(input_ids, gen.bos_token_id, gen.pad_token_id,
                                                             gen.max_length, k)
        kwargs = dict(encoder_outputs=BaseModelOutput(last_hidden_state=enc),
                      attention_mask=torch.tensor(np.asarray(dmask)), prompt_hidden_states=prompt_hidden,
                      prompt_attention_mask=torch.tensor(np.asarray(pmask)), decoder_delay_pattern_mask=delay_mask,
                      use_cache=True)
        while input_ids.shape[1] < gen.max_length:
            inputs = rmodel.prepare_inputs_for_generation(input_ids, **kwargs)
            out = rmodel(**{key: v for key, v in inputs.items() if v is not None or key == "input_ids"},
                         return_dict=True)
            input_ids = torch.cat([input_ids, torch.argmax(out.logits[:, -1, :], dim=-1)[:, None]], dim=-1)
            kwargs["past_key_values"] = out.past_key_values
        tokens = ref.apply_delay_pattern_mask(input_ids, delay_mask)
        mask = ref.build_delay_pattern_mask(torch.full((b * k, 1), bos, dtype=torch.long), gen.bos_token_id,
                                            gen.pad_token_id, tokens.shape[1], k)[1]
        codes = tokens[(mask != gen.bos_token_id) & (mask != gen.pad_token_id)].reshape(b, k, -1)
        codebook_size = rmodel.audio_encoder.config.codebook_size
        waves = []
        for i in range(b):
            sample = codes[i]
            ok = (sample >= codebook_size).sum(dim=0) == 0
            sample = sample[:, ok] if ok.any() else sample[:, :1] * 0
            if hasattr(rmodel.audio_encoder, "model"):  # the reference's DAC wrapper
                wav = rmodel.audio_encoder.decode(sample[None, None], [None]).audio_values
            else:  # an HF DacModel
                wav = rmodel.audio_encoder.decode(audio_codes=sample[None]).audio_values
            waves.append(wav.reshape(-1).cpu().numpy())
    return waves


def _worst(worst: dict, d: dict) -> None:
    for key in WORST:
        worst[key] = max(worst[key], d[key])


def run_quality_gate(checkpoint: str, *, description: str | None = None, prompt: str | None = None,
                     batch: int = 2, seed: int = 0, max_length: int | None = None,
                     tokenizer_name: str | None = None, device: str = "cuda") -> dict:
    """Run the gates on ``checkpoint``, the port's model on ``device``;
    returns the report (``pass``, ``gates``), as the JAX gate's."""
    import torch

    from parler_tts_tpu_torch.core.from_reference import from_reference_pretrained
    from parler_tts_tpu_torch.generation import generate as G
    from parler_tts_tpu_torch.generation import streaming
    from parler_tts_tpu_torch.models import codec as codec_mod
    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.serving import BatchingEngine
    from parler_tts_tpu_torch.utils.mel import mel_distance
    from parler_tts_tpu_torch.utils.tokenizer import Tokenizer

    report: dict = {"checkpoint": checkpoint, "pass": True, "gates": {}}
    model, cfg, gen = from_reference_pretrained(checkpoint, device=device)
    dev = next(model.parameters()).device
    sr, hop = cfg.audio_encoder.sampling_rate, cfg.audio_encoder.hop_length
    if description is not None and prompt is not None:
        desc, dmask, pr, pmask = _tokenized_inputs(tokenizer_name or checkpoint, description, prompt)
    else:
        desc, dmask, pr, pmask = _synthetic_inputs(cfg, batch, seed)
    inputs = dict(input_ids=desc, attention_mask=dmask, prompt_input_ids=pr, prompt_attention_mask=pmask)
    greedy = dataclasses.replace(gen, do_sample=False, max_length=max_length or min(gen.max_length, 86),
                                 kv_cache_dtype=None, int8_weights=False)

    # ----- the port's fp32 quality path -----
    out32 = G.generate(model, greedy, **inputs, vocode=True, device=dev)
    audio32 = out32.audio.float().cpu().numpy()
    lengths = out32.audio_lengths.cpu().numpy()
    codes32 = out32.codes.cpu().numpy()
    code_lengths = out32.code_lengths.cpu().numpy()

    # ----- the torch reference on the same inputs -----
    torch_report: dict = {"ran": False}
    try:
        ref = _load_reference_module()
        rmodel = ref.ParlerTTSForConditionalGeneration.from_pretrained(checkpoint).eval()
        ref_audio = _torch_reference_generate(ref, rmodel, desc, dmask, pr, pmask, greedy)
        torch_report["ran"] = True
        # the reference vocodes each sample's trimmed codes, the batched path
        # zero-pads past each trim: (a) per-sample trimmed decodes against
        # the reference, (b) the batched audio short of its last 48 frames
        # (streaming's lookback, past the vocoder's receptive field)
        edge = streaming.DEFAULT_LOOKBACK * hop
        worst = dict.fromkeys(WORST, 0.0)
        worst_prod = dict(worst)
        for i in range(audio32.shape[0]):
            n, t_codes = int(lengths[i]), max(int(code_lengths[i]), 1)
            with torch.no_grad():
                trimmed = codec_mod.decode(model.audio_encoder, out32.codes[i:i + 1, :, :t_codes])
            _worst(worst, mel_distance(trimmed[0].float().cpu(), ref_audio[i], sr))
            n_int = max(n - edge, 0)
            if n_int:
                _worst(worst_prod, mel_distance(audio32[i, :n_int], ref_audio[i][:n_int], sr))
        torch_report.update(worst)
        torch_report["production_interior"] = worst_prod
        torch_report["mel_allclose"] = (worst["mel_max_abs_db"] <= FP32_MEL_MAX_DB
                                        and worst_prod["mel_max_abs_db"] <= FP32_MEL_MAX_DB)
        if not torch_report["mel_allclose"]:
            report["pass"] = False
    except Exception as e:  # the reference's stack cannot run here
        torch_report["error"] = f"{type(e).__name__}: {e}"[:300]
    report["gates"]["fp32_vs_torch"] = torch_report

    # ----- the serving path (bf16 compute, int8 KV cache and weights) against fp32 -----
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    serving = dataclasses.replace(greedy, kv_cache_dtype="int8", int8_weights=True)
    out_srv = G.generate(model16, serving, **inputs, vocode=False, device=dev)
    agree = float((out_srv.tokens == out32.tokens).float().mean())
    with torch.no_grad():  # the bf16 vocoder on the fp32 codes: no argmax flip counts here
        audio_bf16 = codec_mod.decode(model16.audio_encoder, out32.codes).float().cpu().numpy()
    worst_srv = dict.fromkeys(WORST, 0.0)
    for i in range(audio32.shape[0]):
        n = int(lengths[i])
        if n:
            _worst(worst_srv, mel_distance(audio32[i, :n], audio_bf16[i, :n], sr))
    serving_report = {"greedy_token_agreement": agree, **worst_srv,
                      "vocoder_mel_ok": worst_srv["mel_mean_abs_db"] <= SERVING_MEL_MEAN_DB}
    if not serving_report["vocoder_mel_ok"]:
        report["pass"] = False
    report["gates"]["serving_vs_fp32"] = serving_report

    # ----- streaming against offline (fp32, greedy) -----
    stream_report: dict = {"ran": False}
    try:
        chunks = list(streaming.stream_generate(model, greedy, **inputs, chunk_frames=max(8, greedy.max_length // 4),
                                                device=dev))
        stream_report["ran"] = True
        stream_audio = np.concatenate([c.audio for c in chunks], axis=1)
        stream_codes = np.concatenate([c.codes for c in chunks], axis=2)
        # codes agree inside each sample's valid frames (offline zeroes the
        # rest, the stream emits them raw); the audio is held on the
        # interior, short of the last lookback window, which cannot see the
        # frames a one-shot vocode of the whole utterance sees
        agree_n = agree_d = 0
        worst_stream = dict.fromkeys(WORST, 0.0)
        worst_interior = dict(worst_stream)
        edge = streaming.DEFAULT_LOOKBACK * hop
        for i in range(audio32.shape[0]):
            tv = min(int(code_lengths[i]), stream_codes.shape[-1], codes32.shape[-1])
            if tv:
                agree_n += int((stream_codes[i, :, :tv] == codes32[i, :, :tv]).sum())
                agree_d += stream_codes[i, :, :tv].size
            n = min(int(lengths[i]), stream_audio.shape[1])
            if n:
                _worst(worst_stream, mel_distance(stream_audio[i, :n], audio32[i, :n], sr))
            n_int = max(n - edge, 0)
            if n_int:
                _worst(worst_interior, mel_distance(stream_audio[i, :n_int], audio32[i, :n_int], sr))
        stream_report["token_agreement"] = agree_n / max(agree_d, 1)
        stream_report.update(worst_stream)
        stream_report["interior"] = worst_interior
        stream_report["ok"] = (stream_report["token_agreement"] == 1.0
                               and worst_interior["mel_max_abs_db"] <= FP32_MEL_MAX_DB)
        if not stream_report["ok"]:
            report["pass"] = False
    except Exception as e:  # the port's own streaming: a crash fails the gate
        stream_report["error"] = f"{type(e).__name__}: {e}"[:300]
        report["pass"] = False
    report["gates"]["stream_vs_offline"] = stream_report

    # ----- the batching engine against direct tts -----
    engine_report: dict = {"ran": False}
    try:
        # a checkpoint without a tokenizer is the one skip this gate allows
        # (reported, not failed); past it, a crash is the port's and fails it
        try:
            tok = Tokenizer.from_pretrained(tokenizer_name or checkpoint)
        except Exception as e:
            engine_report["error"] = f"tokenizer unavailable: {e}"[:300]
            report["gates"]["serving_engine_vs_direct"] = engine_report
            return report
        pipe = ParlerTTSPipeline(model16, cfg, greedy, tok, tok, dtype=torch.bfloat16, device=dev)
        texts = [("A female speaker with a low pitched voice.", "Hey, how are you?"),
                 ("Clear audio quality, speaks fast.", "How are you doing today?"),
                 ("A male speaker with a deep voice.", "Hey there.")]
        gate_seconds = greedy.max_length / cfg.frame_rate
        eng = BatchingEngine(pipe, max_batch=4, max_wait_ms=500.0, batch_buckets=(4,),
                             length_bucket_seconds=(gate_seconds,))
        try:
            futs = [eng.submit(d, p, seed=i) for i, (d, p) in enumerate(texts)]
            engine_out = [f.result(timeout=600) for f in futs]
            stats = eng.stats()
        finally:
            eng.shutdown()
        engine_report["ran"] = True
        engine_report["batches"] = stats["batches"]
        # the engine's own padding and seed fold, then the same rows through
        # the pipeline directly: bit for bit
        padded = BatchingEngine.pad_rows(texts, 4)
        direct_sr, direct = pipe.tts([t[0] for t in padded], [t[1] for t in padded],
                                     seed=BatchingEngine.fold_seeds(range(len(texts))),
                                     max_seconds=min(gate_seconds, pipe.gen.max_length / cfg.frame_rate))
        same = stats["batches"] == 1 and all(sr_i == direct_sr and np.array_equal(w_i, direct[i])
                                             for i, (sr_i, w_i) in enumerate(engine_out))
        engine_report["bitwise_equal"] = bool(same)
        if stats["batches"] != 1:  # the burst split across windows: inconclusive, not a failure
            engine_report["note"] = "burst split across batches; rerun for a conclusive check"
        elif not same:
            report["pass"] = False
    except Exception as e:
        engine_report["error"] = f"{type(e).__name__}: {e}"[:300]
        report["pass"] = False
    report["gates"]["serving_engine_vs_direct"] = engine_report
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--checkpoint", required=True, help="reference checkpoint dir")
    ap.add_argument("--description", default=None)
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-length", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer dir for the inputs and the serving-engine gate (default: the checkpoint)")
    ap.add_argument("--device", default="cuda", help="where the port's model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    report = run_quality_gate(args.checkpoint, description=args.description, prompt=args.prompt, batch=args.batch,
                              seed=args.seed, max_length=args.max_length, tokenizer_name=args.tokenizer,
                              device=args.device)
    print(json.dumps(report, indent=2))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
