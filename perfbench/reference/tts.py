"""The reference's judgement of served rows: for each row, how far the
tokens the program chose lie below the reference's best logit at their
steps (greedy rows) or below its k-th best (sampled rows), and the relative
L2 error of the program's waveform against the reference's decode of the
same tokens."""

from __future__ import annotations

import torch

from perfbench.reference import Weights, dac, decoder, encodec, exact_fp32, t5


def vocode(w: Weights, cfg: dict, codes: torch.Tensor) -> torch.Tensor:
    codec = cfg["audio_encoder"]
    module = encodec if codec.get("codec_type") == "encodec" else dac
    return module.decode(w.sub("audio_encoder."), codec, codes)


def valid_frames(codes: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """(B,) frames before the first that holds a special id in any codebook."""
    special = (codes >= codebook_size).any(dim=1)
    t = codes.shape[-1]
    return torch.where(special.any(1), special.int().argmax(1), torch.full_like(special[:, 0], t, dtype=torch.int64))


@torch.no_grad()
def judge(w: Weights, cfg: dict, *, desc_ids, desc_mask, prompt_ids, prompt_mask, tokens,
          audio: list, top_k: int = 0, temperature: float = 1.0) -> list[dict]:
    """Rows of one shape, all on one device: ``desc_*`` (B, S), ``prompt_*``
    (B, P) as the program was given them (descriptions right-padded,
    prompts left-padded), ``tokens`` (B, K, T) the delayed tokens it
    produced, ``audio`` its B waveforms (float tensors).  Returns per row
    the widest ``gap`` and the ``mean_gap`` over the model's steps, with
    ``top_k`` the ``topk_excess`` of a row sampled at that top-k and
    ``temperature`` (its mean over the model's steps), and ``wave_err``
    (None where the waveform's length is wrong)."""
    with exact_fp32():
        enc = decoder.text_states(w, t5.encode(w.sub("text_encoder."), cfg["text_encoder"], desc_ids, desc_mask),
                                  desc_mask)
        ref_logits = decoder.logits(w, cfg, enc, desc_mask, prompt_ids, prompt_mask, tokens[:, :, :-1])
        chosen = decoder.delay_pattern(tokens.shape[1], tokens.shape[2], tokens.device)
        gap = decoder.token_gaps(ref_logits, tokens, chosen)
        gaps, mean_gaps = gap.amax(dim=(1, 2)), gap.sum(dim=(1, 2)) / chosen[:, 1:].sum()
        excess = None
        if top_k:
            excess = decoder.topk_excess(ref_logits, tokens, chosen, top_k, temperature).sum(dim=(1, 2)) \
                / chosen[:, 1:].sum()
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
