"""K2, K3 and K4, the flash-attention backward: the port's plain versions
(what the wrappers run on CPU tensors), reached through the autograd function
on both routes, against ``jax.grad`` through the JAX package's Pallas kernels
in interpret mode.  The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parler_tts_tpu.ops.pallas.flash_attention as jfa
from parler_tts_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)  # tier-1 runs several pytest workers

# (shape, pad, causal), as tests/test_pallas_kernels.py
CASES = [((2, 3, 256, 64), 70, True), ((1, 2, 40, 32), 5, True), ((2, 2, 300, 64), 0, False)]
GRAD_TOL = 2e-5  # fp32 sums in another order than XLA's


def _inputs(shape, pad, seed=1):
    rng = np.random.default_rng(seed)
    b, h, t, d = shape
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = rng.standard_normal(shape).astype(np.float32)  # weights of the loss
    kv_mask = np.ones((b, t), np.int8)
    kv_mask[0, :pad] = 0
    return q, k, v, w, kv_mask


def _jax_grads(q, k, v, w, kv_mask, causal, block=None):
    """Gradients of sum(sin(out) * w) through the JAX kernels (interpret
    mode); ``block`` < T forces its split K2 + K3 route."""
    def loss(q, k, v):
        out = jfa.flash_attention_bhtd(q, k, v, jnp.asarray(kv_mask), scale=0.125, causal=causal,
                                       block_q=block, block_k=block, interpret=True)
        return jnp.sum(jnp.sin(out) * w)

    return [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, w, kv_mask, causal, dtype=torch.float32):
    q, k, v = (torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v))
    out = pfa.flash_attention_bhtd(q, k, v, torch.from_numpy(kv_mask), scale=0.125, causal=causal)
    (torch.sin(out) * torch.from_numpy(w).to(dtype)).sum().backward()
    return [x.grad.numpy() for x in (q, k, v)]


@pytest.fixture
def spy(monkeypatch):
    """Records which plain backward versions run."""
    calls = []
    for name in ("flash_dq_plain", "flash_dkv_plain", "flash_dqkv_plain"):
        real = getattr(pfa, name)
        monkeypatch.setattr(pfa, name, lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    return calls


@pytest.mark.parametrize("shape,pad,causal", CASES)
@pytest.mark.parametrize("route", ["fused", "split"])
def test_backward_matches_jax_grad(shape, pad, causal, route, spy, monkeypatch):
    """The fused route (K4's plain version) and the split route (K2's and
    K3's) each give JAX's gradients, on every row (fully masked rows give 0
    in both)."""
    monkeypatch.setenv("PARLER_FLASH_NO_FUSED_BWD", "0" if route == "fused" else "1")
    q, k, v, w, kv_mask = _inputs(shape, pad)
    ref = _jax_grads(q, k, v, w, kv_mask, causal)
    got = _port_grads(q, k, v, w, kv_mask, causal)
    assert spy == (["flash_dqkv_plain"] if route == "fused" else ["flash_dkv_plain", "flash_dq_plain"])
    for name, r, g in zip("qkv", ref, got):
        np.testing.assert_allclose(g, r, atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")
    if causal and pad:
        assert not got[0][0, :, :pad].any()  # no valid key: no gradient


def test_split_route_matches_jax_split_kernels(monkeypatch):
    """JAX's own K2 + K3 (128 tiles, 3 x 3 blocks) against the port's split
    route at T = 300 with left padding."""
    monkeypatch.setenv("PARLER_FLASH_NO_FUSED_BWD", "1")
    q, k, v, w, kv_mask = _inputs((1, 2, 300, 64), 37, seed=2)
    ref = _jax_grads(q, k, v, w, kv_mask, True, block=128)
    for r, g in zip(ref, _port_grads(q, k, v, w, kv_mask, True)):
        np.testing.assert_allclose(g, r, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fused", ["0", "1"])
def test_gradcheck_float64(causal, fused, monkeypatch):
    monkeypatch.setenv("PARLER_FLASH_NO_FUSED_BWD", fused)
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((3, 11, 8)), requires_grad=True) for _ in range(3))
    start = torch.tensor([3, 0, 2], dtype=torch.int32)
    end = torch.tensor([11, 7, 11], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: pfa.flash_attention(q, k, v, start, end, scale=0.3, causal=causal)[0], (q, k, v))


def test_plain_versions_agree_across_routes():
    """K4's plain version equals K2's and K3's (one shared arithmetic)."""
    q, k, v, w, kv_mask = (torch.from_numpy(x) for x in _inputs((2, 3, 64, 32), 9))
    b, h, t, d = q.shape
    start, end = pfa.kv_bounds(kv_mask, b, h, t, q.device)
    q, k, v, do = (x.reshape(b * h, t, d) for x in (q, k, v, w))
    out, lse = pfa.flash_attention_fwd(q, k, v, start, end, scale=0.125)
    delta = (do * out).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta, start, end)
    dq, dk, dv = pfa.flash_attention_dqkv(*args, scale=0.125)
    torch.testing.assert_close(pfa.flash_attention_dq(*args, scale=0.125), dq, atol=0, rtol=0)
    torch.testing.assert_close(pfa.flash_attention_dkv(*args, scale=0.125), (dk, dv), atol=0, rtol=0)


def test_bounds_and_lse_take_no_gradient():
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2, 9, 8)), dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    out, lse = pfa.flash_attention_bhtd_lse(q, k, v, torch.ones((1, 9), dtype=torch.int32), scale=0.5)
    assert out.requires_grad and not lse.requires_grad
    out.sum().backward()
    assert all(x.grad is not None for x in (q, k, v))


@pytest.mark.parametrize("tq,tk,env,fused", [
    (903, 903, None, True), (1024, 1024, None, True), (1021, 900, "0", True), (1025, 1025, None, False),
    (2623, 2623, None, False), (903, 903, "1", False), (903, 903, "yes", False),
])
def test_fused_route_follows_the_jax_rule(tq, tk, env, fused, monkeypatch):
    """K4 when both lengths fit one 1024 tile and PARLER_FLASH_NO_FUSED_BWD
    is unset or "0" (JAX ``_vjp_bwd``)."""
    if env is None:
        monkeypatch.delenv("PARLER_FLASH_NO_FUSED_BWD", raising=False)
    else:
        monkeypatch.setenv("PARLER_FLASH_NO_FUSED_BWD", env)
    assert pfa.fused_backward(tq, tk) is fused


@pytest.mark.parametrize("wrapper", ["flash_attention_dq", "flash_attention_dkv", "flash_attention_dqkv"])
def test_backward_wrappers_take_the_plain_version_only_for_cpu_tensors(wrapper):
    x = torch.zeros((2, 4, 8), device="meta")
    row = torch.zeros((2, 4, 1), device="meta")
    bounds = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        getattr(pfa, wrapper)(x, x, x, x, row, row, bounds, bounds)
