"""K1, the flash-attention forward: the port's plain version (what the
wrapper runs on CPU tensors) against the JAX package's Pallas kernel in
interpret mode.  The CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parler_tts_tpu.ops.pallas.flash_attention as jfa
from parler_tts_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SHAPES = [((2, 3, 256, 64), 70), ((1, 2, 40, 32), 5), ((2, 2, 300, 64), 0)]


def _inputs(shape, pad, seed=0):
    rng = np.random.default_rng(seed)
    b, _, t, _ = shape
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    kv_mask = np.ones((b, t), np.int8)
    kv_mask[0, :pad] = 0
    return q, k, v, kv_mask


def _jax_fwd(q, k, v, kv_mask, *, scale, causal):
    """The JAX kernel's (out, lse), launched as ``flash_attention_bhtd``
    launches it, in interpret mode."""
    b, h, t, d = q.shape
    m = kv_mask.astype(np.int32)
    start = np.repeat(np.argmax(m, axis=1), h).astype(np.int32)
    end = start + np.repeat(m.sum(axis=1), h).astype(np.int32)
    block = min(1024, jfa._round8(t))
    out, lse = jfa._fwd(
        jnp.asarray(q.reshape(b * h, t, d)), jnp.asarray(k.reshape(b * h, t, d)),
        jnp.asarray(v.reshape(b * h, t, d)), jnp.asarray(start), jnp.asarray(end),
        scale=scale, causal=causal, q_offset=0, block_q=block, block_k=block, interpret=True,
    )
    return np.asarray(out).reshape(q.shape), np.asarray(lse).reshape(b, h, t)


@pytest.mark.parametrize("shape,pad", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_interpret(shape, pad, causal):
    """``out`` on every row, including the fully masked rows of the padded
    batch row where both give 0; ``lse`` on the rows with a valid key."""
    q, k, v, kv_mask = _inputs(shape, pad)
    ref_out, ref_lse = _jax_fwd(q, k, v, kv_mask, scale=0.125, causal=causal)
    out, lse = pfa.flash_attention_bhtd_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(kv_mask),
        scale=0.125, causal=causal,
    )
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5, rtol=0)
    if causal and pad:
        assert not out[0, :, :pad].any()  # no valid key: zero rows
    valid = np.ones(lse.shape, bool)
    if causal:
        valid[0, :, :pad] = False
    np.testing.assert_allclose(lse.numpy()[valid], ref_lse[valid], atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(
        pfa.flash_attention_bhtd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(kv_mask), scale=0.125, causal=causal).numpy(),
        out.numpy(),
    )


def test_mask_to_bounds_matches_jax():
    """Left- and right-padded rows, an empty row, and no mask."""
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]], np.int8)
    start, end = pfa.kv_bounds(torch.from_numpy(mask), 4, 2, 5, torch.device("cpu"))
    m = mask.astype(np.int32)
    np.testing.assert_array_equal(start.numpy(), np.repeat(np.argmax(m, axis=1), 2))
    np.testing.assert_array_equal(end.numpy(), np.repeat(np.argmax(m, axis=1) + m.sum(axis=1), 2))
    start, end = pfa.kv_bounds(None, 2, 3, 5, torch.device("cpu"))
    assert start.tolist() == [0] * 6 and end.tolist() == [5] * 6


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    q = torch.zeros((2, 4, 8), device="meta")
    bounds = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pfa.flash_attention(q, q, q, bounds, bounds)
