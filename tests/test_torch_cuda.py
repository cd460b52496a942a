"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  The
file imports no JAX, so it also runs on a machine with the card and without
JAX, where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.ops import cuda_build
from parler_tts_tpu_torch.ops import flash_attention as pfa

TILE = 64
TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
    ((3, 16, 903, 64), 20, True, torch.bfloat16),  # the 3 x 10 s training shape
    ((3, 16, 903, 64), 20, True, torch.float32),
    ((1, 16, 2623, 64), 12, True, torch.bfloat16),  # the 1 x 30 s training shape
    ((2, 3, 333, 32), 9, True, torch.bfloat16),  # D = 32, T not a multiple of 64
])
def test_flash_attention_kernel_matches_plain_version(cuda, shape, pad, causal, dtype):
    """Tolerances on ``out``: fp32 1e-4 (sums in another order), bf16 2e-2
    (one output ulp), and, scale-free, each 64-row tile's error within
    ``TILE_TOL`` of that tile (a long walk's outputs are about as small as
    2e-2); ``lse`` 1e-3, and bit for bit the plain version's on rows with no
    valid key (the left padding), which the backward kernels read."""
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
    assert _tile_rel_err(out.reshape(b * h, t, d), ref_out) <= TILE_TOL[dtype]
    ref_lse = ref_lse.reshape(b, h, t)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    empty = ref_lse < -1e8  # rows with no valid key
    assert bool(empty.any()) == (causal and pad > 0)
    assert torch.equal(lse[empty], ref_lse[empty])


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 8, 48), device="cuda")
    bounds = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        pfa.flash_attention(q, q, q, bounds, bounds)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        h = q[..., :32].contiguous().half()
        pfa.flash_attention(h, h, h, bounds, bounds)


def _bwd_inputs(shape, pad, causal, dtype, tk=None, q_offset=0, bounds=None):
    """q, do (BH, Tq, D) and k, v (BH, Tk, D) from a seed, the forward's lse
    and delta; batch row 0 left-padded by ``pad`` keys, or ``bounds`` =
    (kv_start, kv_end) per batch row."""
    rng = np.random.default_rng(1)
    b, h, t, d = shape
    tk = tk or t
    q, do = (torch.from_numpy(rng.standard_normal((b * h, t, d)).astype(np.float32)).cuda().to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b * h, tk, d)).astype(np.float32)).cuda().to(dtype)
            for _ in range(2))
    if bounds is None:
        kv_mask = torch.ones((b, tk), dtype=torch.int32, device="cuda")
        kv_mask[0, :pad] = 0
        start, end = pfa.kv_bounds(kv_mask, b, h, tk, q.device)
    else:
        start, end = (torch.tensor(x, dtype=torch.int32, device="cuda").repeat_interleave(h) for x in bounds)
    out, lse = pfa.flash_attention_fwd(q, k, v, start, end, scale=0.125, causal=causal, q_offset=q_offset)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    return q, k, v, do, lse, delta, start, end


def _tile_rel_err(got, ref):
    """The largest ||got - ref|| / ||ref|| over the 64-row tiles of (BH, T, D)
    outputs or gradients; inf where a zero tile of the reference is not
    zero."""
    bh, t, d = ref.shape
    pad = (0, 0, 0, -t % TILE)
    err = torch.nn.functional.pad(got.float() - ref.float(), pad).reshape(bh, -1, TILE * d).norm(dim=-1)
    norm = torch.nn.functional.pad(ref.float(), pad).reshape(bh, -1, TILE * d).norm(dim=-1)
    if bool((err[norm == 0] > 0).any()) or not bool(torch.isfinite(err).all()):
        return float("inf")
    return (err[norm > 0] / norm[norm > 0]).max().item() if bool((norm > 0).any()) else 0.0


def _assert_grads_close(got, ref, dtype):
    """fp32: 1e-4 of the largest magnitude (sums in another order, dq by
    atomics in K4); bf16: one bf16 ulp (2^-7) of the largest magnitude.  And,
    scale-free, each 64-row tile's error within ``TILE_TOL`` of that tile of
    the reference: it holds the small gradients of long walks, which the
    first check lets move by as much as their own size."""
    for g, r in zip(got, ref):
        scale = max(1.0, r.float().abs().max().item())
        atol = scale * (2.0**-7 if dtype == torch.bfloat16 else 1e-4)
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=0)
        g3, r3 = (x.reshape(-1, *x.shape[-2:]) for x in (g, r))
        assert _tile_rel_err(g3, r3) <= TILE_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pad,causal,dtype,extra", [
    ((3, 16, 903, 64), 20, True, torch.bfloat16, {}),
    ((1, 16, 1100, 64), 7, True, torch.bfloat16, {}),
    ((1, 2, 40, 32), 5, True, torch.float32, {}),
    ((2, 2, 300, 64), 0, False, torch.float32, {}),
    ((1, 16, 2623, 64), 12, True, torch.bfloat16, {}),  # the 1 x 30 s training shape
    ((2, 3, 333, 32), 9, True, torch.bfloat16, {}),  # D = 32, T not a multiple of 64
    ((2, 3, 333, 32), 9, False, torch.bfloat16, {}),
    ((3, 2, 200, 64), 37, True, torch.bfloat16, {"tk": 456, "q_offset": 200}),  # Tq < Tk
    ((3, 2, 200, 64), 37, True, torch.float32, {"tk": 456, "q_offset": 200}),
    # batch row 0's keys start past every query row: no valid pair
    ((2, 2, 150, 64), 0, True, torch.bfloat16, {"tk": 260, "bounds": ([200, 0], [260, 260])}),
])
def test_backward_kernels_match_plain_versions(cuda, shape, pad, causal, dtype, extra):
    """K2, K3 and K4, each launched once, against their plain versions."""
    args = _bwd_inputs(shape, pad, causal, dtype, **extra)
    kw = dict(scale=0.125, causal=causal, q_offset=extra.get("q_offset", 0))
    before = (pfa.LAUNCHES_DQ, pfa.LAUNCHES_DKV, pfa.LAUNCHES_DQKV)
    got = (pfa.flash_attention_dq(*args, **kw), *pfa.flash_attention_dkv(*args, **kw),
           *pfa.flash_attention_dqkv(*args, **kw))
    torch.cuda.synchronize()
    assert (pfa.LAUNCHES_DQ, pfa.LAUNCHES_DKV, pfa.LAUNCHES_DQKV) == tuple(n + 1 for n in before)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    ref = pfa.flash_dqkv_plain(*args, **kw)
    _assert_grads_close(got[:3], ref, dtype)
    _assert_grads_close(got[3:], ref, dtype)
    if "bounds" in extra:  # every pair of batch row 0 masked: zero gradients
        heads = shape[1]
        assert not any(g[:heads].any() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_takes_k4_or_k2_and_k3(cuda, monkeypatch, dtype):
    """The autograd function's two routes on one input give the same grads
    (in bf16: the tensor-core K2 + K3 against K4)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 256, 64)).astype(np.float32)).cuda().to(dtype)
               .requires_grad_() for _ in range(3))
    kv_mask = torch.ones((2, 256), dtype=torch.int32, device="cuda")
    kv_mask[0, :70] = 0
    grads = {}
    for env in ("0", "1"):
        monkeypatch.setenv("PARLER_FLASH_NO_FUSED_BWD", env)
        before = (pfa.LAUNCHES_DQ, pfa.LAUNCHES_DKV, pfa.LAUNCHES_DQKV)
        out = pfa.flash_attention_bhtd(q, k, v, kv_mask, scale=0.125)
        grads[env] = torch.autograd.grad(out.float().sin().sum(), (q, k, v))
        after = (pfa.LAUNCHES_DQ, pfa.LAUNCHES_DKV, pfa.LAUNCHES_DQKV)
        assert [a - b for a, b in zip(after, before)] == ([0, 0, 1] if env == "0" else [1, 1, 0])
    _assert_grads_close(grads["0"], grads["1"], dtype)


# A copy of a kernel whose one block leaves one tile out: (source, library,
# shape, left padding, text, replacement).  bf16 K2, K3 and K1 at the 1 x 30 s
# shape, in its second half, where the far tiles weigh as much as the near
# ones (K2: query rows 1920-1983 without keys 76-139; K3: keys 1984-2047
# without query rows 2048-2111; K1: query rows 1920-1983 without keys
# 76-139), K4 at the 3 x 10 s shape (query rows 832-895 without the dq of
# keys 64-127).
_SKIPPED_TILE = {
    "flash_attention_dq": (
        "flash_attention_bwd.cu", "flash_attention_bwd", (1, 16, 2623, 64), 12,
        "      mma_a_tile<D>(dqa, dsf, kt, lane);  // dq += ds.k\n",
        "      if (!(bh == 0 && blockIdx.y == 10 && it == 1)) mma_a_tile<D>(dqa, dsf, kt, lane);\n"),
    "flash_attention_dkv": (
        "flash_attention_bwd.cu", "flash_attention_bwd", (1, 16, 2623, 64), 12,
        "      mma_a_tile<D>(dva, pf, dot, lane);  // dv += p^T.do\n"
        "      mma_a_tile<D>(dka, dsf, qt, lane);  // dk += ds^T.q\n",
        "      if (!(bh == 0 && blockIdx.y == 31 && it == 1)) {\n"
        "        mma_a_tile<D>(dva, pf, dot, lane);\n"
        "        mma_a_tile<D>(dka, dsf, qt, lane);\n"
        "      }\n"),
    "flash_attention_dqkv": (
        "flash_attention_bwd.cu", "flash_attention_bwd", (3, 16, 903, 64), 20,
        "        dq_tile<D>(dq_acc + (qbase + i0) * D, dss, ks, tq - i0, warp, lane);  // dq += ds.k\n",
        "        if (!(bh == 0 && blockIdx.y == 1 && it == 12))\n"
        "          dq_tile<D>(dq_acc + (qbase + i0) * D, dss, ks, tq - i0, warp, lane);\n"),
    "flash_attention_fwd": (
        "flash_attention_fwd.cu", "flash_attention_fwd", (1, 16, 2623, 64), 12,
        "      if (k0 + kTile <= kv_stop && (!causal || k0 + kTile - 1 <= q_offset + w0))\n",
        "      if (bh == 0 && blockIdx.y == 10 && it == 1) {\n"
        "      } else if (k0 + kTile <= kv_stop && (!causal || k0 + kTile - 1 <= q_offset + w0))\n"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_SKIPPED_TILE))
def test_tile_check_rejects_a_skipped_tile(cuda, monkeypatch, tmp_path, name):
    """A copy of the kernel sources whose bf16 K1, K2, K3 or K4 leaves one
    tile of one walk out, built into its own library, fails the tile-wise
    check.  Prints every check's reading."""
    source, lib, shape, pad, old, new = _SKIPPED_TILE[name]
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)  # the sources and the header they include
    src = (csrc / source).read_text()
    assert src.count(old) == 1
    (csrc / source).write_text(src.replace(old, new))
    args = _bwd_inputs(shape, pad, True, torch.bfloat16)  # K1 from the package's library
    q, k, v, _, _, _, start, end = args
    kw = dict(scale=0.125, causal=True)
    if name == "flash_attention_fwd":
        ref_out, ref_lse = pfa.flash_attention_plain(q, k, v, start, end, **kw)
        ref = (ref_out,)
    else:
        ref = pfa.flash_dqkv_plain(*args, **kw)
        ref = ref[:1] if name == "flash_attention_dq" else ref[1:] if name == "flash_attention_dkv" else ref
    broken = cuda_build.library(lib, csrc)
    monkeypatch.setattr(cuda_build, "library", lambda _: broken)
    note = ""
    if name == "flash_attention_fwd":
        out, lse = pfa.flash_attention_fwd(q, k, v, start, end, **kw)
        got = (out,)
        note = f", max_abs_err_lse {(lse - ref_lse).abs().max().item()} (tol 1e-3)"
    else:
        got = getattr(pfa, name)(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    max_err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    max_tol = 2e-2 if name == "flash_attention_fwd" else 2.0**-7 * max(
        1.0, max(r.float().abs().max().item() for r in ref))
    tile_err = max(_tile_rel_err(g, r) for g, r in zip(got, ref))
    print(f"{name} with a skipped tile: max_abs_err {max_err} (tol {max_tol}), "
          f"max_tile_rel_err {tile_err} (tol {TILE_TOL[torch.bfloat16]}){note}")
    assert tile_err > TILE_TOL[torch.bfloat16]
