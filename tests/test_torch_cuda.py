"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  The
file imports no JAX, so it also runs on a machine with the card and without
JAX, where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.ops import flash_attention as pfa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pad,causal,dtype", [
    ((4, 16, 17, 64), 5, True, torch.bfloat16),
    ((4, 16, 257, 64), 70, True, torch.bfloat16),
    ((1, 2, 40, 32), 5, True, torch.float32),
    ((2, 2, 300, 64), 0, False, torch.float32),
])
def test_flash_attention_kernel_matches_plain_version(cuda, shape, pad, causal, dtype):
    """Tolerances on ``out``: fp32 1e-4 (sums in another order), bf16 2e-2
    (one output ulp); ``lse`` 1e-3."""
    rng = np.random.default_rng(0)
    b, h, t, d = shape
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
               for _ in range(3))
    kv_mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    kv_mask[0, :pad] = 0
    before = pfa.LAUNCHES
    out, lse = pfa.flash_attention_bhtd_lse(q, k, v, kv_mask, scale=0.125, causal=causal)
    torch.cuda.synchronize()
    assert pfa.LAUNCHES == before + 1
    start, end = pfa.kv_bounds(kv_mask, b, h, t, q.device)
    ref_out, ref_lse = pfa.flash_attention_plain(q.reshape(b * h, t, d), k.reshape(b * h, t, d),
                                                 v.reshape(b * h, t, d), start, end, scale=0.125,
                                                 causal=causal)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref_out.reshape(shape).float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, ref_lse.reshape(b, h, t), atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 8, 48), device="cuda")
    bounds = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        pfa.flash_attention(q, q, q, bounds, bounds)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        h = q[..., :32].contiguous().half()
        pfa.flash_attention(h, h, h, bounds, bounds)
