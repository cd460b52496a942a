"""The reference's judgement of rows served by the Nemotron-H decoder: the
same readings as ``reference/tts.py`` (each chosen token's gap below the
reference's best logit or its excess below the k-th best, and the
waveform's relative error against the reference's decode of the same
tokens), with ``reference/nemotron_h.py``'s logits in place of the MusicGen
decoder's."""

from __future__ import annotations

import torch

from perfbench.reference import Weights, decoder, exact_fp32, nemotron_h, t5
from perfbench.reference.tts import valid_frames, vocode


@torch.no_grad()
def judge(w: Weights, cfg: dict, *, desc_ids, desc_mask, prompt_ids, prompt_mask, tokens,
          audio: list, top_k: int = 0, temperature: float = 1.0) -> list[dict]:
    """``reference/tts.judge``'s contract and readings."""
    with exact_fp32():
        enc = decoder.text_states(w, t5.encode(w.sub("text_encoder."), cfg["text_encoder"], desc_ids, desc_mask),
                                  desc_mask)
        ref_logits = nemotron_h.logits(w, cfg, enc, desc_mask, prompt_ids, prompt_mask, tokens[:, :, :-1])
        chosen = decoder.delay_pattern(tokens.shape[1], tokens.shape[2], tokens.device)
        steps = chosen[:, 1:].sum()
        gap = decoder.token_gaps(ref_logits, tokens, chosen)
        gaps, mean_gaps = gap.amax(dim=(1, 2)), gap.sum(dim=(1, 2)) / steps
        excess = None
        if top_k:
            excess = decoder.topk_excess(ref_logits, tokens, chosen, top_k, temperature).sum(dim=(1, 2)) / steps
        del ref_logits, gap
        codes = decoder.undelay(tokens)
        frames = valid_frames(codes, cfg["audio_encoder"]["codebook_size"])
        kept = torch.arange(codes.shape[-1], device=codes.device)[None] < frames[:, None]
        ref_audio = vocode(w, cfg, torch.where(kept[:, None], codes, 0))
    hop = ref_audio.shape[-1] // codes.shape[-1]
    out = []
    for i, a in enumerate(audio):
        n = int(frames[i]) * hop
        err = None
        if a.shape[-1] == n and n > 0:
            ref = ref_audio[i, :n]
            err = float((a.to(ref) - ref).norm() / ref.norm().clamp_min(1e-30))
        out.append({"gap": float(gaps[i]), "mean_gap": float(mean_gaps[i]),
                    "topk_excess": None if excess is None else float(excess[i]), "wave_err": err})
    return out
