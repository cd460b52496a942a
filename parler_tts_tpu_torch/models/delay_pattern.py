"""Delay pattern for multi-codebook codec-token generation.

Port of ``parler_tts_tpu/models/delay_pattern.py``: codebook
``k`` is shifted right by ``k`` steps so one decoder step predicts all K
codebooks.  For 4 codebooks and max length 8 the pattern is::

    [B, -1, -1, -1, -1,  P,  P,  P]
    [B,  B, -1, -1, -1, -1,  P,  P]
    [B,  B,  B, -1, -1, -1, -1,  P]
    [B,  B,  B,  B, -1, -1, -1, -1]

``B``/``P`` are the BOS/PAD ids and ``-1`` marks positions the model
predicts.  Arrays are ``(batch, K, T)`` int; results equal the JAX ones
exactly.
"""

from __future__ import annotations

import torch


def build_delay_pattern(input_ids: torch.Tensor, *, bos_token_id: int, pad_token_id: int,
                        max_length: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(batch, K, seq_len)`` start ids -> ``(prompt_ids, pattern,
    first_start_id)``: ``pattern`` ``(batch, K, max_length)`` holds the forced
    tokens and ``-1`` where the model predicts; ``prompt_ids`` is its prefix
    up to ``first_start_id`` (= ``seq_len``), the first decode position."""
    input_ids = input_ids.to(torch.int32)
    batch, num_codebooks, seq_len = input_ids.shape
    device = input_ids.device

    # short-sequence escape: too short for the triangles, everything predicted
    if max_length < 2 * num_codebooks - 1:
        pattern = torch.full((batch, num_codebooks, max_length), -1, dtype=torch.int32, device=device)
        return input_ids, pattern, seq_len

    t = torch.arange(max_length, device=device)[None, :]  # (1, T)
    k = torch.arange(num_codebooks, device=device)[:, None]  # (K, 1)

    # codebook k's prompt occupies columns [k, k + seq_len)
    src_idx = (t - k).clamp(0, seq_len - 1)
    in_prompt = (t >= k) & (t < k + seq_len)
    gathered = torch.gather(input_ids, 2, src_idx[None].expand(batch, -1, -1))
    pattern = torch.where(in_prompt[None], gathered, torch.full_like(gathered, -1))

    # BOS region is the inclusive lower triangle t <= k; PAD the upper one
    bos_region = t <= k
    pad_region = t >= (max_length - (num_codebooks - 1) + k)
    pattern = pattern.masked_fill(bos_region[None], bos_token_id)
    pattern = pattern.masked_fill(pad_region[None], pad_token_id)
    return pattern[..., :seq_len], pattern, seq_len


def apply_delay_pattern(input_ids: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """``where(pattern == -1, input_ids, pattern)`` with the pattern cropped
    to the sequence length."""
    pattern = pattern[..., : input_ids.shape[-1]]
    return torch.where(pattern == -1, input_ids.to(pattern.dtype), pattern)


def undelay_pattern(output_ids: torch.Tensor) -> torch.Tensor:
    """Shift codebook ``k`` left by ``k``: ``(batch, K, T)`` ->
    ``(batch, K, T - K + 1)`` aligned codec frames."""
    batch, num_codebooks, seq_len = output_ids.shape
    out_len = seq_len - num_codebooks + 1
    if out_len <= 0:
        return output_ids[..., :0]
    t = torch.arange(out_len, device=output_ids.device)[None, :]
    k = torch.arange(num_codebooks, device=output_ids.device)[:, None]
    return torch.gather(output_ids, 2, (t + k)[None].expand(batch, -1, -1))


def build_delay_pattern_labels(codes: torch.Tensor, lengths: torch.Tensor, *, bos_token_id: int,
                               eos_token_id: int, max_length: int, ignore_id: int = -100) -> torch.Tensor:
    """Training labels in the delay pattern from raw codes ``(batch, K,
    T_codes)`` (right-padded arbitrarily past each sample's ``lengths``).
    Label row ``k`` of a sample of length ``L`` is
    ``[BOS]*k + codes_k[:L] + [EOS]*(K-k) + [ignore_id]*padding``, cut or
    padded to ``max_length``; int32 ``(batch, K, max_length)``."""
    codes = codes.to(torch.int32)
    batch, num_codebooks, t_codes = codes.shape
    device = codes.device
    t = torch.arange(max_length, device=device)[None, None, :]
    k = torch.arange(num_codebooks, device=device)[None, :, None]
    lens = lengths.to(device=device, dtype=torch.int64)[:, None, None]

    # codebook k's data occupies [k, k + len)
    src = (t - k).clamp(0, t_codes - 1).expand(batch, num_codebooks, max_length)
    gathered = torch.gather(codes, 2, src)
    in_data = (t >= k) & (t < k + lens)
    eos_region = (t >= k + lens) & (t < lens + num_codebooks)

    labels = torch.full((batch, num_codebooks, max_length), ignore_id, dtype=torch.int32, device=device)
    labels = labels.masked_fill((t < k).expand_as(labels), bos_token_id)
    labels = torch.where(in_data, gathered, labels)
    return labels.masked_fill(eos_region, eos_token_id)


def labels_to_decoder_inputs(labels: torch.Tensor, *, bos_token_id: int, pad_token_id: int,
                             ignore_id: int = -100) -> torch.Tensor:
    """Teacher-forcing inputs: labels shifted right by one with BOS at
    position 0 and ``ignore_id`` replaced by PAD; ``(batch, K, T)``."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[..., 0] = bos_token_id
    return shifted.masked_fill(shifted == ignore_id, pad_token_id)
