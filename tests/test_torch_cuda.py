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


def _bwd_inputs(shape, pad, causal, dtype):
    rng = np.random.default_rng(1)
    b, h, t, d = shape
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b * h, t, d)).astype(np.float32)).cuda().to(dtype)
                   for _ in range(4))
    kv_mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    kv_mask[0, :pad] = 0
    start, end = pfa.kv_bounds(kv_mask, b, h, t, q.device)
    out, lse = pfa.flash_attention_fwd(q, k, v, start, end, scale=0.125, causal=causal)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    return q, k, v, do, lse, delta, start, end


def _assert_grads_close(got, ref, dtype):
    """fp32: 1e-4 of the largest magnitude (sums in another order, dq by
    atomics in K4); bf16: one bf16 ulp (2^-7) of the largest magnitude."""
    for g, r in zip(got, ref):
        scale = max(1.0, r.float().abs().max().item())
        atol = scale * (2.0**-7 if dtype == torch.bfloat16 else 1e-4)
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pad,causal,dtype", [
    ((3, 16, 903, 64), 20, True, torch.bfloat16),
    ((1, 16, 1100, 64), 7, True, torch.bfloat16),
    ((1, 2, 40, 32), 5, True, torch.float32),
    ((2, 2, 300, 64), 0, False, torch.float32),
])
def test_backward_kernels_match_plain_versions(cuda, shape, pad, causal, dtype):
    """K2, K3 and K4, each launched once, against their plain versions."""
    args = _bwd_inputs(shape, pad, causal, dtype)
    kw = dict(scale=0.125, causal=causal)
    before = (pfa.LAUNCHES_DQ, pfa.LAUNCHES_DKV, pfa.LAUNCHES_DQKV)
    got = (pfa.flash_attention_dq(*args, **kw), *pfa.flash_attention_dkv(*args, **kw),
           *pfa.flash_attention_dqkv(*args, **kw))
    torch.cuda.synchronize()
    assert (pfa.LAUNCHES_DQ, pfa.LAUNCHES_DKV, pfa.LAUNCHES_DQKV) == tuple(n + 1 for n in before)
    ref = pfa.flash_dqkv_plain(*args, **kw)
    _assert_grads_close(got[:3], ref, dtype)
    _assert_grads_close(got[3:], ref, dtype)


@pytest.mark.cuda
def test_autograd_takes_k4_or_k2_and_k3(cuda, monkeypatch):
    """The autograd function's two routes on one input give the same grads."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 256, 64)).astype(np.float32)).cuda().requires_grad_()
               for _ in range(3))
    kv_mask = torch.ones((2, 256), dtype=torch.int32, device="cuda")
    kv_mask[0, :70] = 0
    grads = {}
    for env in ("0", "1"):
        monkeypatch.setenv("PARLER_FLASH_NO_FUSED_BWD", env)
        before = (pfa.LAUNCHES_DQ, pfa.LAUNCHES_DKV, pfa.LAUNCHES_DQKV)
        out = pfa.flash_attention_bhtd(q, k, v, kv_mask, scale=0.125)
        grads[env] = torch.autograd.grad(out.sin().sum(), (q, k, v))
        after = (pfa.LAUNCHES_DQ, pfa.LAUNCHES_DKV, pfa.LAUNCHES_DQKV)
        assert [a - b for a, b in zip(after, before)] == ([0, 0, 1] if env == "0" else [1, 1, 0])
    _assert_grads_close(grads["0"], grads["1"], torch.float32)
