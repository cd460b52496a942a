"""The port's CUDA kernels against their plain PyTorch versions on the card
(the flash-attention kernels K1-K4, the decode step's attention K5, the DAC
decoder's Snake K6 and its stride-1 convolutions K7, the Mamba-2 state
update K8), the
decode loop, the stream and the prefill captured in CUDA graphs
against the per-step eager loop and the eager prefill, the captured train
and eval steps against the eager ones, and failed captures (they raise,
and leave every generator they registered usable).

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

from parler_tts_tpu_torch.core import graphs as pgraphs
from parler_tts_tpu_torch.ops import cuda_build
from parler_tts_tpu_torch.ops import flash_attention as pfa
from parler_tts_tpu_torch.utils import profiling

TILE = 64
TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


BWD = ("flash_attention_dq", "flash_attention_dkv", "flash_attention_dqkv")


def counter(name: str) -> float:
    return profiling.counters().get(name, 0)


def _launched(*kernels: str):
    """The launches of one kernel so far, or a tuple of several's."""
    now = pgraphs.launches()
    return now[kernels[0]] if len(kernels) == 1 else tuple(now[k] for k in kernels)


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
    ((4, 32, 65, 128), 10, True, torch.bfloat16),  # D = 128: the Nemotron-H cell's prefill, K/V repeated to 32 heads
    ((2, 4, 300, 128), 20, True, torch.bfloat16),
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
    before = _launched("flash_attention_fwd")
    out, lse = pfa.flash_attention_bhtd_lse(q, k, v, kv_mask, scale=0.125, causal=causal)
    torch.cuda.synchronize()
    assert _launched("flash_attention_fwd") == before + 1
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
    before = _launched(*BWD)
    got = (pfa.flash_attention_dq(*args, **kw), *pfa.flash_attention_dkv(*args, **kw),
           *pfa.flash_attention_dqkv(*args, **kw))
    torch.cuda.synchronize()
    assert _launched(*BWD) == tuple(n + 1 for n in before)
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
        before = _launched(*BWD)
        out = pfa.flash_attention_bhtd(q, k, v, kv_mask, scale=0.125)
        grads[env] = torch.autograd.grad(out.float().sin().sum(), (q, k, v))
        after = _launched(*BWD)
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


# --- the decode step's attention (K5) ---------------------------------------------------------


def _decode_attention_inputs(b, h, r, d, dtype, *, max_len=None, seed=0):
    """q (B, H, 1, D) pre-scaled, k/v one layer of (2, B, H, max_len, D) cache
    buffers read over r keys (strided, as the decode step reads them; a
    cross cache when ``max_len`` is r), and a (B, r) bool mask with holes:
    left bucket padding, a short prompt's right padding, keys not yet
    decoded, and a row with no valid key when B > 2."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    max_len = max_len or r + 61
    q = (torch.randn((b, h, 1, d), generator=g, device="cuda") * d**-0.5).to(dtype)
    kbuf, vbuf = (torch.randn((2, b, h, max_len, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    mask = torch.ones((b, r), dtype=torch.bool, device="cuda")
    mask[0, : r // 5] = False
    mask[:, r // 3 : r // 3 + 9] = False
    mask[min(1, b - 1), r - r // 7 :] = False
    if b > 2:
        mask[2] = False
    return q, kbuf[1, :, :, :r], vbuf[1, :, :, :r], mask


def _assert_decode_close(out, ref, dtype):
    """``out`` within 2e-2 (bf16, one output ulp) or 1e-4 (fp32, sums in
    another order), and each (b, h) row's error within ``TILE_TOL`` of
    that row."""
    b, h, _, d = ref.shape
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert _tile_rel_err(out.reshape(b * h, 1, d), ref.reshape(b * h, 1, d)) <= TILE_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,r,d,dtype,max_len", [
    (96, 16, 128, 64, torch.bfloat16, None),  # the cells' rows, self attention, first and mean buckets
    (96, 16, 558, 64, torch.bfloat16, None),
    (96, 16, 934, 64, torch.bfloat16, None),  # mini's last bucket
    (96, 16, 934, 64, torch.float32, None),
    (96, 16, 64, 64, torch.bfloat16, 64),  # the cells' cross attention
    (1, 16, 934, 64, torch.bfloat16, None),  # the split route: a stream's rows
    (1, 16, 4096, 64, torch.bfloat16, None),
    (4, 16, 934, 64, torch.bfloat16, None),
    (4, 16, 4096, 64, torch.bfloat16, None),
    (4, 16, 4096, 64, torch.float32, None),
    (3, 3, 333, 32, torch.bfloat16, None),  # D = 32
    (3, 3, 333, 32, torch.float32, None),
])
def test_decode_attention_kernel_matches_plain_version(cuda, b, h, r, d, dtype, max_len):
    from parler_tts_tpu_torch.ops import decode_attention as pda

    q, k, v, mask = _decode_attention_inputs(b, h, r, d, dtype, max_len=max_len)
    before = _launched("decode_attention")
    out = pda.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert _launched("decode_attention") == before + 1
    splits, _ = pda.decode_split(b * h, r, torch.cuda.get_device_properties(0).multi_processor_count)
    assert (splits == 1) == (b * h >= 1536 or r <= 64)
    _assert_decode_close(out, pda.decode_attention_plain(q, k, v, mask), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kv_heads,group,r,max_len", [
    (192, 8, 4, 128, None),  # the LFM2 cell's self attention: 8 K/V heads of 4 queries, first bucket
    (192, 8, 4, 823, None),  # its fused length at the last step
    (192, 32, 1, 64, 64),  # its cross attention (MHA, group 1)
    (96, 16, 1, 934, None),  # mini's last bucket, group 1
    (1, 8, 4, 934, None),  # the split route with groups
    (3, 2, 4, 333, None),
])
def test_decode_attention_groups_match_plain_version(cuda, b, kv_heads, group, r, max_len):
    """Grouped-query K5 (one block per (row, K/V head) and its group's
    queries) against its plain version, bf16."""
    from parler_tts_tpu_torch.ops import decode_attention as pda

    _, k, v, mask = _decode_attention_inputs(b, kv_heads, r, 64, torch.bfloat16, max_len=max_len)
    g = torch.Generator(device="cuda").manual_seed(1)
    q = (torch.randn((b, kv_heads * group, 1, 64), generator=g, device="cuda") / 8).to(torch.bfloat16)
    out = pda.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    _assert_decode_close(out, pda.decode_attention_plain(q, k, v, mask), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [192, 192 * 65])
def test_grouped_experts_match_the_loop_over_experts_at_the_cell_shapes(cuda, tokens):
    """The LFM2 cell's grouped experts (``torch._grouped_mm`` over device
    offsets) against the loop over experts on the card, bf16, at its decode
    step's 192 tokens x 4 of 32 experts (768 pairs) and its prefill's 192 x
    65 tokens, 2048 -> 1792 -> 2048 at the benchmark's std 0.02.  Each
    token's output within 1e-2 of the loop's, relative (one bf16 ulp of the
    intermediate products; two experts' down projections swapped miss it by
    far), and the same counts, none dropped."""
    from parler_tts_tpu_torch.ops import moe

    g = torch.Generator(device="cuda").manual_seed(2)
    e, h, f, k = 32, 2048, 1792, 4

    def draw(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(torch.bfloat16)

    w13, w2, router, bias = draw(e, h, 2 * f), draw(e, f, h), draw(h, e), draw(e)
    x = torch.randn((tokens, h), generator=g, device="cuda").to(torch.bfloat16)
    weights, experts = moe.route(x, router, bias, k)
    stats = [torch.zeros(3, dtype=torch.int64, device="cuda") for _ in range(2)]
    got = moe.experts_grouped(x, w13, w2, weights, experts, stats[0])
    ref = moe.experts_plain(x, w13, w2, weights, experts, stats[1])

    def rel(a):
        return ((a.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1)).max().item()

    assert rel(got) <= 1e-2
    assert rel(moe.experts_grouped(x, w13, w2[[1, 0, *range(2, e)]], weights, experts)) > 0.1
    assert stats[0].tolist() == stats[1].tolist() and stats[0].tolist()[::2] == [tokens * k, 0]


@pytest.mark.cuda
def test_decode_attention_reads_a_strided_cache_slice_in_place(cuda):
    """The cache slice is read through its strides: the call allocates its
    output and nothing the size of K or V, and gives what a contiguous copy
    gives, bit for bit; the mask may be int64 (the encoder's)."""
    from parler_tts_tpu_torch.ops import decode_attention as pda

    q, k, v, mask = _decode_attention_inputs(96, 16, 934, 64, torch.bfloat16)
    assert not k.is_contiguous() and not v.is_contiguous()
    pda.decode_attention(q, k, v, mask)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = pda.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before <= 2 * out.numel() * out.element_size()
    assert torch.equal(out, pda.decode_attention(q, k.contiguous(), v.contiguous(), mask.long()))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [96, 1])
def test_captured_decode_attention_equals_the_eager_call(cuda, b):
    """Captured in a CUDA graph (one split at 96 rows, several at 1, whose
    scratch comes from the graph's pool), a replay gives the eager call's
    output bit for bit, before and after the inputs change in place; the
    capture records one call into its program and launches none (its
    warm-up launches one), and each replay counts the call it holds."""
    from parler_tts_tpu_torch.ops import decode_attention as pda

    q, k, v, mask = _decode_attention_inputs(b, 16, 934, 64, torch.bfloat16)
    pda.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    outs, launches = [], _launched("decode_attention")
    program = pgraphs.capture(lambda: outs.append(pda.decode_attention(q, k, v, mask)))
    out = outs[-1]
    assert program.launches["decode_attention"] == 1 and _launched("decode_attention") == launches + 1
    for step in range(2):
        program.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, pda.decode_attention(q, k, v, mask))
        q.mul_(-1.5)
        k[:, :, step * 100 : step * 100 + 50] = 0.5
        mask[:, 40 + step] = ~mask[:, 40 + step]
    assert _launched("decode_attention") == launches + 5  # the warm-up, two replays, two eager calls


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_what_it_does_not_take(cuda):
    from parler_tts_tpu_torch.ops import decode_attention as pda

    q = torch.zeros((2, 4, 1, 48), device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros((2, 4, 10, 48), device="cuda", dtype=torch.bfloat16)
    mask = torch.ones((2, 10), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        pda.decode_attention(q, kv, kv, mask)
    q, kv = q[..., :32].contiguous(), kv[..., :32].contiguous()
    with pytest.raises(TypeError, match="fp32 or bf16"):
        pda.decode_attention(q.half(), kv.half(), kv.half(), mask)
    with pytest.raises(ValueError, match="kv_mask must be"):
        pda.decode_attention(q, kv, kv, mask[:, :9])
    with pytest.raises(TypeError, match="bool or integer"):
        pda.decode_attention(q, kv, kv, mask.float())


@pytest.mark.cuda
def test_decode_check_rejects_a_skipped_key_run(cuda, monkeypatch, tmp_path):
    """A copy of the kernel source whose P.V pass leaves one in four key
    runs out, built into its own library, fails the check above on every
    route.  Prints the readings."""
    from parler_tts_tpu_torch.ops import decode_attention as pda

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    src = (csrc / "decode_attention.cu").read_text()
    old = "p[u][j] = i < n ? round_to<T>(s[j * chunk + i] / l[j]) : 0.f;"
    assert src.count(old) == 1
    (csrc / "decode_attention.cu").write_text(
        src.replace(old, "p[u][j] = i < n && u != 3 ? round_to<T>(s[j * chunk + i] / l[j]) : 0.f;"))
    broken = cuda_build.library("decode_attention", csrc)
    monkeypatch.setattr(cuda_build, "library", lambda _: broken)
    for b in (96, 1):
        q, k, v, mask = _decode_attention_inputs(b, 16, 558, 64, torch.bfloat16)
        out = pda.decode_attention(q, k, v, mask)
        ref = pda.decode_attention_plain(q, k, v, mask)
        err = _tile_rel_err(out.reshape(b * 16, 1, 64), ref.reshape(b * 16, 1, 64))
        print(f"decode attention with a skipped key run, {b} rows: max_row_rel_err {err} "
              f"(tol {TILE_TOL[torch.bfloat16]})")
        assert err > TILE_TOL[torch.bfloat16]


MINI_FRAMES = 862  # 10 s at 86 frames a second: T of the DAC decoder's first Snake


def _snake_inputs(b: int, c: int, t: int, alpha_dtype, gen) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b, c, t) bf16 of std 3 with values at and beside the polynomial's
    wrap points (alpha * x / pi near an integer, where t - floor(t) jumps) at
    the start of each channel of the first row, and +-0, large and tiny
    magnitudes (a subnormal among them) in the last row; alpha (c,) with a
    negative, a tiny (1e-6) and two large (+-50) channels."""
    x = torch.randn((b, c, t), generator=gen, device="cuda") * 3
    alpha = torch.randn(c, generator=gen, device="cuda").abs() + 0.05
    alpha[: min(c, 4)] = torch.tensor([-0.7, 1e-6, 50.0, -50.0], device="cuda")[: min(c, 4)]
    alpha = alpha.to(alpha_dtype)
    m = min(t, 7)
    k = torch.arange(m, device="cuda", dtype=torch.float32) - 3  # -3 .. 3 half-turns
    wrap = k[None, :] * torch.pi / alpha.float()[:, None] * (1 + 1e-3 * (k[None, :] % 2))
    x[0, :, :m] = wrap.clamp(-1e4, 1e4)
    special = torch.tensor([0.0, -0.0, 1e4, -1e4, 3e4, -3e4, 1e-30, 1e-40, 0.5, -0.5], device="cuda")
    x[-1].reshape(-1)[: min(special.numel(), c * t)] = special[: c * t]
    return x.to(torch.bfloat16), alpha


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t", [
    (4, 1536, MINI_FRAMES),  # the decoder's five Snake widths at 4 rows, each at its T
    (4, 768, 8 * MINI_FRAMES),
    (4, 384, 64 * MINI_FRAMES),
    (4, 192, 256 * MINI_FRAMES),
    (4, 96, 512 * MINI_FRAMES),
    (3, 5, 1),  # rows shorter than a 16-byte load, and unaligned tails
    (2, 9, 7),
    (2, 17, 9),
    (1, 3, 862),
])
@pytest.mark.parametrize("alpha_dtype", [torch.bfloat16, torch.float32])
def test_snake_kernel_equals_snake_fast_bit_for_bit(cuda, b, c, t, alpha_dtype):
    from parler_tts_tpu_torch.models import dac as pdac
    from parler_tts_tpu_torch.ops import snake as psnake

    gen = torch.Generator(device="cuda").manual_seed(b * 10007 + c * 101 + t)
    x, alpha = _snake_inputs(b, c, t, alpha_dtype, gen)
    before = _launched("snake")
    out = psnake.snake_fast_cuda(x, alpha, pdac._SIN2_COEFFS)
    torch.cuda.synchronize()
    assert _launched("snake") == before + 1
    ref = pdac.snake_fast(x, alpha)
    same = out.view(torch.int16) == ref.view(torch.int16)
    assert bool(same.all()), f"{int((~same).sum())} of {same.numel()} elements differ, first at {(~same).nonzero()[0]}"
    # and from a tensor that does not start on a 16-byte boundary (element by element)
    if c * t % 8:
        shifted = torch.empty((b + 1, c, t), dtype=torch.bfloat16, device="cuda")[1:]
        shifted.copy_(x)
        assert shifted.data_ptr() % 16
        assert torch.equal(psnake.snake_fast_cuda(shifted, alpha, pdac._SIN2_COEFFS).view(torch.int16),
                           ref.view(torch.int16))


@pytest.mark.cuda
def test_snake_kernel_past_32_bit_indices(cuda):
    """A tensor of more than 2**32 elements (8.6 GB in bf16) takes the
    kernel's 64-bit indices: its first and last columns, and the columns
    around the row boundary, equal ``snake_fast``'s."""
    from parler_tts_tpu_torch.models import dac as pdac
    from parler_tts_tpu_torch.ops import snake as psnake

    t = 2**31 + 13  # two channels, one row each: a row boundary at an odd column
    x = torch.empty((1, 2, t), dtype=torch.bfloat16, device="cuda").normal_(0.0, 3.0)
    alpha = torch.tensor([0.7, -1.3], device="cuda")
    out = psnake.snake_fast_cuda(x, alpha, pdac._SIN2_COEFFS)
    torch.cuda.synchronize()
    for cols in (slice(0, 4096), slice(t - 4096, t)):
        want = pdac.snake_fast(x[:, :, cols].contiguous(), alpha)
        assert torch.equal(out[:, :, cols].view(torch.int16), want.view(torch.int16))
    del x, out
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_snake_kernel_refuses_what_it_does_not_take(cuda):
    from parler_tts_tpu_torch.models import dac as pdac
    from parler_tts_tpu_torch.ops import snake as psnake

    x = torch.zeros((2, 4, 8), dtype=torch.bfloat16, device="cuda")
    alpha = torch.ones(4, device="cuda")
    for bad, error in ((x.float(), TypeError), (x.transpose(1, 2), ValueError), (x[0], ValueError)):
        with pytest.raises(error):
            psnake.snake_fast_cuda(bad, alpha[: bad.shape[1]] if bad.dim() == 3 else alpha, pdac._SIN2_COEFFS)
    with pytest.raises(ValueError, match="alpha"):
        psnake.snake_fast_cuda(x, alpha.cpu(), pdac._SIN2_COEFFS)
    assert psnake.snake_fast_cuda(x[:0], alpha, pdac._SIN2_COEFFS).shape == (0, 4, 8)


@pytest.mark.cuda
def test_a_bf16_dac_decode_equals_the_plain_chain_bit_for_bit(cuda, monkeypatch):
    """Mini's DAC (widths 1536 -> 96, strides 8, 8, 4, 2) from random weights
    in bf16: the waveform with K6 equals the waveform with ``snake_fast`` in
    its place bit for bit, and a decode launches K6 29 times."""
    from parler_tts_tpu_torch.core.config import DACConfig
    from parler_tts_tpu_torch.models import codec as pcodec
    from parler_tts_tpu_torch.models import dac as pdac

    cfg = DACConfig()
    model = pdac.DAC(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # Snake alphas as trained ones spread, not all 1
        for name, p in model.named_parameters():
            if name.endswith("alpha"):
                p.copy_(torch.rand(p.shape, generator=gen) * 2 + 0.05)
    model = model.to("cuda", torch.bfloat16)
    codes = torch.randint(0, cfg.codebook_size, (3, cfg.num_codebooks, 43), generator=gen).cuda()
    with torch.no_grad():
        before = _launched("snake")
        wave = pcodec.decode(model, codes)
        torch.cuda.synchronize()
        assert _launched("snake") - before == 29
        monkeypatch.setattr(pdac, "snake_fast_cuda", lambda x, alpha, coeffs: pdac.snake_fast(x, alpha))
        ref = pcodec.decode(model, codes)
    assert wave.shape == ref.shape == (3, 43 * cfg.hop_length)
    assert torch.equal(wave, ref)
    assert _launched("snake") - before == 29


# the DAC decoder's distinct stride-1 convolutions at 4 rows of 10 s: (C_in, C_out, taps, dilation, T,
# residual); a decode group runs conv_in once, each level's k7 once at each dilation and its k1 three times
DAC_CONV_CASES = [(1024, 1536, 7, 1, MINI_FRAMES, False)] + [
    (c, c, k, d, per_frame * MINI_FRAMES, k == 1)
    for c, per_frame in ((768, 8), (384, 64), (192, 256), (96, 512))
    for k, d in ((7, 1), (7, 3), (7, 9), (1, 1))]


def _dac_conv_case(b, c_in, c_out, taps, d, t, residual, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    conv = torch.nn.Conv1d(c_in, c_out, taps, dilation=d, padding=(taps - 1) // 2 * d).cuda()
    with torch.no_grad():
        conv.weight.normal_(0.0, (c_in * taps) ** -0.5, generator=gen)
        conv.bias.normal_(0.0, 0.1, generator=gen)
    conv = conv.to(torch.bfloat16).requires_grad_(False)
    x = torch.randn((b, c_in, t), generator=gen, device="cuda").to(torch.bfloat16)
    r = torch.randn((b, c_out, t), generator=gen, device="cuda").to(torch.bfloat16) if residual else None
    return conv, x, r


def _assert_within_one_rounding(out, conv, x, r):
    """Every element within one bf16 rounding (2**-8 of its size) of the fp32
    result, plus the fp32 sums' reordering (2**-16 of the sum of the terms'
    sizes); the first and last 256-step tile of each row included."""
    import torch.nn.functional as F

    d, pad = conv.dilation[0], conv.padding[0]
    with torch.no_grad():
        ref = F.conv1d(x.float(), conv.weight.float(), conv.bias.float(), padding=pad, dilation=d)
        size = F.conv1d(x.float().abs(), conv.weight.float().abs(), conv.bias.float().abs(), padding=pad, dilation=d)
        if r is not None:
            ref += r.float()
            size += r.float().abs()
        ratio = (out.float() - ref).abs() / (2.0**-8 * ref.abs() + 2.0**-16 * size)
    t = x.shape[2]
    worst = {"all": float(ratio.max()), "first_tile": float(ratio[..., :256].max()),
             "last_tile": float(ratio[..., (t - 1) // 256 * 256:].max())}
    assert all(v <= 1.0 for v in worst.values()), worst


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,taps,d,t,residual", DAC_CONV_CASES)
def test_dac_conv_kernel_within_one_rounding_at_the_decoder_shapes(cuda, c_in, c_out, taps, d, t, residual):
    from parler_tts_tpu_torch.ops import dac_conv as pconv

    conv, x, r = _dac_conv_case(4, c_in, c_out, taps, d, t, residual, seed=c_in * 31 + taps * 7 + d)
    before = _launched("dac_conv")
    with torch.no_grad():
        out = pconv.dac_conv_cuda(x, conv, r)
    torch.cuda.synchronize()
    assert _launched("dac_conv") == before + 1
    assert out.shape == (4, c_out, t) and out.dtype == torch.bfloat16
    _assert_within_one_rounding(out, conv, x, r)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c_in,c_out,taps,d,t,residual", [
    (2, 64, 96, 7, 3, 37, True),  # T odd: element-by-element loads and stores
    (3, 32, 64, 7, 9, 5, False),  # T shorter than the halo
    (2, 32, 160, 7, 1, 300, True),  # T even, no multiple of 8; a 96-channel tile half outside C_out
    (2, 64, 32, 1, 1, 513, True),  # 1 tap, T past two tiles and odd
    (2, 64, 160, 1, 1, 302, True),  # 1 tap, T even, no multiple of 8; a tile half outside C_out
    (1, 96, 96, 7, 56, 1000, False),  # the largest dilation the 7-tap window fits at 96 channels
    (1, 32, 32, 7, 45, 700, True),  # a window of more 8-step blocks than the block has warps
])
def test_dac_conv_kernel_within_one_rounding_at_odd_shapes(cuda, b, c_in, c_out, taps, d, t, residual):
    from parler_tts_tpu_torch.ops import dac_conv as pconv

    conv, x, r = _dac_conv_case(b, c_in, c_out, taps, d, t, residual, seed=t)
    with torch.no_grad():
        _assert_within_one_rounding(pconv.dac_conv_cuda(x, conv, r), conv, x, r)
        # and from tensors that do not start on a 16-byte boundary
        shifted = torch.empty((b * c_in * t + 1,), dtype=torch.bfloat16, device="cuda")[1:].view(b, c_in, t)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16
        _assert_within_one_rounding(pconv.dac_conv_cuda(shifted, conv, r), conv, x, r)


@pytest.mark.cuda
def test_dac_conv_kernel_refuses_what_it_does_not_take(cuda):
    from parler_tts_tpu_torch.ops import dac_conv as pconv

    conv, x, r = _dac_conv_case(2, 32, 32, 1, 1, 16, True, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pconv.dac_conv_cuda(x, conv.cpu(), r)
    conv = conv.cuda()
    with pytest.raises(ValueError, match="residual"):
        pconv.dac_conv_cuda(x, conv, r.cpu())
    too_wide = torch.nn.Conv1d(32, 32, 7, dilation=73, padding=219).to("cuda", torch.bfloat16)
    with pytest.raises(RuntimeError, match="dac_conv launch failed"):
        pconv.dac_conv_cuda(x, too_wide.requires_grad_(False))
    assert pconv.dac_conv_cuda(x[:0], conv).shape == (0, 32, 16)
    # the relaid weight follows an in-place change of the module's weight
    with torch.no_grad():
        first = pconv.dac_conv_cuda(x, conv, r)
        conv.weight.mul_(2.0)
        _assert_within_one_rounding(pconv.dac_conv_cuda(x, conv, r), conv, x, r)
        assert not torch.equal(first, pconv.dac_conv_cuda(x, conv, r))


@pytest.mark.cuda
def test_a_bf16_dac_decode_takes_k7_25_times_a_group_near_the_parent_chain(cuda, monkeypatch):
    """Mini's DAC in bf16 from weights drawn as the benchmark draws them
    (``perfbench/weights.py``: kernels and biases of std 0.02, Snake alphas
    around 1, unit codebooks), one decode group: 25 K7 launches, and the
    waveform's distance from an fp32 decode of the same weights no larger
    than the parent's chain (``nn.Conv1d``, then the residual add) gives, or
    than the benchmark's highest ``wave_rel_err`` reading (0.0211), and
    within its limit (0.07) of the parent's waveform."""
    from parler_tts_tpu_torch.core.config import DACConfig
    from parler_tts_tpu_torch.models import codec as pcodec
    from parler_tts_tpu_torch.models import dac as pdac

    cfg = DACConfig()
    model = pdac.DAC(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("alpha"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=gen))
            elif name.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            elif name == "quantizer.codebooks":
                p.copy_(torch.randn(p.shape, generator=gen))
    fp32 = model.to("cuda").requires_grad_(False)
    codes = torch.randint(0, cfg.codebook_size, (3, cfg.num_codebooks, 43), generator=gen).cuda()
    with torch.no_grad():
        ref = pcodec.decode(fp32, codes)
        model = fp32.to(torch.bfloat16)
        before = _launched("dac_conv")
        wave = pcodec.decode(model, codes)
        torch.cuda.synchronize()
        assert _launched("dac_conv") - before == 25
        monkeypatch.setattr(pdac, "dac_conv_cuda", lambda x, module, residual=None: (
            module(x) if residual is None else residual + module(x)))
        parent = pcodec.decode(model, codes)
    assert _launched("dac_conv") - before == 25

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    errs = {"k7": rel(wave, ref), "parent": rel(parent, ref), "k7_vs_parent": rel(wave, parent)}
    print(errs)
    assert wave.shape == ref.shape == (3, 43 * cfg.hop_length)
    assert errs["k7"] <= max(errs["parent"], 0.0211) and errs["k7_vs_parent"] < 0.07, errs


@pytest.mark.cuda
def test_a_captured_96_row_tts_call_launches_the_decode_kernel_twice_a_layer(cuda):
    """A replayed ``tts`` call of 96 rows at Mini's width runs its self and
    cross attention through the decode kernel: its launches grow by
    48 per replayed step, counted through the step graphs' replays."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.models import parler as pparler
    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer

    cfg = pcfg.mini_600m_config()
    model = pparler.init(0, cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():  # no special id but EOS: every row runs its second
        model.decoder.lm_heads.kernel[..., cfg.audio_encoder.codebook_size + 1:] = 0
    tok = ToyTokenizer(cfg.vocab_size)
    pipe = ParlerTTSPipeline(model, cfg, pcfg.GenerationConfig(do_sample=True, top_k=50), tok, tok,
                             dtype=torch.bfloat16, device="cuda")
    words = "a calm voice reads the news slowly in a quiet room".split()
    texts = ([" ".join(words[: 3 + i % 8]) for i in range(96)], [" ".join(words[: 1 + i % 10]) for i in range(96)])
    pipe.tts(*texts, seed=1, max_seconds=1.0)  # captures
    launches, replays = _launched("decode_attention"), counter("decode.replays")
    pipe.tts(*texts, seed=2, max_seconds=1.0)
    steps = counter("decode.replays") - replays
    assert 2 * cfg.decoder.num_hidden_layers == 48 and steps > 0
    assert _launched("decode_attention") - launches == 48 * steps


# --- the captured decode loop ------------------------------------------------------------------

DECODE_LENGTH = 300  # + 9 prompt positions: the ladder has two buckets at 2 rows, three at 6


def _decode_model(dtype):
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.models import parler as pparler

    cfg = pcfg.dummy_config()
    model = pparler.init(0, cfg, device="cuda", dtype=dtype)
    with torch.no_grad():  # no special id but EOS: the samples run long, EOS still ends streams
        model.decoder.lm_heads.kernel[..., cfg.audio_encoder.codebook_size + 1:] = 0
    return model


def _decode_inputs(b: int) -> dict:
    g = torch.Generator().manual_seed(3)
    inputs = dict(input_ids=torch.randint(3, 1000, (b, 11), generator=g),
                  attention_mask=torch.ones((b, 11), dtype=torch.int32),
                  prompt_input_ids=torch.randint(3, 1000, (b, 9), generator=g),
                  prompt_attention_mask=torch.ones((b, 9), dtype=torch.int32))
    inputs["attention_mask"][1, 7:] = 0
    inputs["prompt_attention_mask"][0, :3] = 0
    return {k: v.cuda() for k, v in inputs.items()}


def _eager_loop(model, gen, inputs, seed):
    """The per-step eager loop (streaming's and split models')."""
    from parler_tts_tpu_torch.generation import generate as pgen

    s = pgen.prefill(model, gen, max_length=gen.max_length, **inputs)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    while not s.done:
        pgen.decode_step(model, gen, s, generator=generator)
    return s.tokens, s.t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,kw", [
    (torch.float32, 2, dict(do_sample=False)),
    (torch.bfloat16, 2, dict(do_sample=False)),
    (torch.bfloat16, 3, dict(do_sample=False, guidance_scale=3.0, kv_cache_dtype="int8", int8_weights=True)),
    (torch.bfloat16, 3, dict(do_sample=True, top_k=50, guidance_scale=3.0)),
], ids=["greedy_fp32", "greedy_bf16", "int8_cfg", "cfg_topk_sampled"])
def test_captured_decode_loop_equals_the_eager_loop(cuda, dtype, b, kw):
    """On a CUDA model the decode loop replays captured steps, bucket by
    bucket; its tokens and stop are the per-step eager loop's, bit for bit
    (both run the same kernels at the same shapes; sampling draws the same
    numbers from the same seed).  A second call replays without capturing."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.generation import generate as pgen

    model = _decode_model(dtype)
    gen = pcfg.GenerationConfig(max_length=DECODE_LENGTH, **kw)
    inputs = _decode_inputs(b)
    replays, captures = counter("decode.replays"), counter("decode.captures")
    tokens, t = pgen.generate_tokens(model, gen, max_length=gen.max_length,
                                     generator=torch.Generator(device="cuda").manual_seed(5), **inputs)
    buckets = counter("decode.captures") - captures
    rows = 2 * b if gen.guidance_scale > 1 else b
    assert buckets == len(pgen._kv_read_limits(10, 9 + DECODE_LENGTH, 8, batch_rows=rows)) >= 2
    assert counter("decode.replays") - replays >= t - 1
    ref, ref_t = _eager_loop(model, gen, inputs, seed=5)
    assert t == ref_t
    assert torch.equal(tokens, ref)
    again, _ = pgen.generate_tokens(model, gen, max_length=gen.max_length,
                                    generator=torch.Generator(device="cuda").manual_seed(5), **inputs)
    assert counter("decode.captures") - captures == buckets and torch.equal(again, tokens)


@pytest.mark.cuda
def test_captured_loop_reads_weights_changed_between_calls(cuda):
    """The graphs keep a static decode view refreshed at every call: a
    weight changed in place between two calls changes the tokens, to the
    eager loop's with the new weights."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.generation import generate as pgen

    model = _decode_model(torch.float32)
    gen = pcfg.GenerationConfig(max_length=60, do_sample=False)
    inputs = _decode_inputs(2)
    first, _ = pgen.generate_tokens(model, gen, max_length=60, **inputs)
    with torch.no_grad():
        model.decoder.layers[0].fc1.kernel.mul_(-1.5)
        model.decoder.layers[1].self_attn.q.kernel.mul_(2.0)
    captures = counter("decode.captures")
    second, _ = pgen.generate_tokens(model, gen, max_length=60, **inputs)
    assert counter("decode.captures") == captures  # the same signature: replayed, not captured again
    assert not torch.equal(first, second)
    assert torch.equal(second, _eager_loop(model, gen, inputs, seed=0)[0])


# --- the captured stream and prefill -------------------------------------------------------------

STREAM_CASES = [
    (torch.float32, 2, dict(do_sample=False)),
    (torch.bfloat16, 2, dict(do_sample=False)),
    (torch.bfloat16, 3, dict(do_sample=False, guidance_scale=3.0, kv_cache_dtype="int8", int8_weights=True)),
    (torch.bfloat16, 3, dict(do_sample=True, top_k=50, guidance_scale=3.0)),
]


def _stream_codes(model, gen, inputs, seed, chunk_frames=40):
    from parler_tts_tpu_torch.generation import streaming as pstream

    chunks = list(pstream.stream_generate(model, gen, chunk_frames=chunk_frames, vocode=False,
                                          generator=torch.Generator(device="cuda").manual_seed(seed), **inputs))
    return np.concatenate([c.codes for c in chunks], axis=2), chunks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,kw", STREAM_CASES, ids=["greedy_fp32", "greedy_bf16", "int8_cfg",
                                                          "cfg_topk_sampled"])
def test_captured_stream_equals_the_eager_stream(cuda, monkeypatch, dtype, b, kw):
    """A stream on a CUDA model runs the captured prefill and replays the
    bucket graphs chunk by chunk (chunks of 40 cross the bucket ends): no
    ``decode_step``, one decode view, and its codes are the per-step eager
    loop's bit for bit, twice (the second stream replays its prefill)."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.generation import generate as pgen
    from parler_tts_tpu_torch.generation import streaming as pstream
    from parler_tts_tpu_torch.models.delay_pattern import undelay_pattern

    model = _decode_model(dtype)
    gen = pcfg.GenerationConfig(max_length=DECODE_LENGTH, **kw)
    inputs = _decode_inputs(b)
    steps, views = [], []
    real_step, real_view = pgen.decode_step, model.decoder.decode_params
    monkeypatch.setattr(pgen, "decode_step", lambda *a, **k: steps.append(1) or real_step(*a, **k))
    monkeypatch.setattr(model.decoder, "decode_params", lambda int8=False: views.append(int8) or real_view(int8))
    replays = counter("prefill.replays")
    first, _ = _stream_codes(model, gen, inputs, seed=5)
    second, _ = _stream_codes(model, gen, inputs, seed=5)
    assert not steps and len(views) == 2 and counter("prefill.replays") - replays == 1
    ref, _ = _eager_loop(model, gen, inputs, seed=5)
    want = undelay_pattern(ref[:, :, 1:]).cpu().numpy()[:, :, :first.shape[2]]
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)


@pytest.mark.cuda
@pytest.mark.parametrize("prompt_len", [9, 33])
@pytest.mark.parametrize("frames", [0, 6])
def test_captured_prefill_equals_the_eager_prefill(cuda, prompt_len, frames):
    """The replayed prefill writes the static state as an eager ``prefill``
    does, bit for bit: the cache's self and cross K/V over the prefill's
    positions, the first logits, tokens, pattern and masks; at two prompt
    lengths, with and without audio-prompt codes, bf16 with CFG."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.generation import generate as pgen

    model = _decode_model(torch.bfloat16)
    gen = pcfg.GenerationConfig(max_length=120, do_sample=False, guidance_scale=3.0)
    g = torch.Generator().manual_seed(prompt_len + frames)
    inputs = dict(_decode_inputs(2), prompt_hidden_states=None, decoder_input_codes=None)
    inputs["prompt_input_ids"] = torch.randint(3, 1000, (2, prompt_len), generator=g).cuda()
    inputs["prompt_attention_mask"] = torch.ones((2, prompt_len), dtype=torch.int32).cuda()
    inputs["prompt_attention_mask"][0, :3] = 0
    if frames:
        inputs["decoder_input_codes"] = torch.randint(0, 1024, (2, model.cfg.decoder.num_codebooks, frames),
                                                      generator=g).cuda()
    programs = pgen._programs_of(model)
    captures = counter("prefill.captures")
    for _ in range(2):  # the first call captures, the second replays
        with programs.lock:
            _, captured, _ = pgen._captured_generation(model, gen, programs, max_length=120, generator=None,
                                                       noise=None, **inputs)
    assert counter("prefill.captures") - captures == 1
    s = captured.state
    ref = pgen.prefill(model, gen, max_length=120, **inputs)
    t = ref.cache.index
    assert s.t == ref.t == 1 + frames and s.cache.index == t == prompt_len + 1 + frames
    assert int(s.position) == ref.t and not bool(s.finished.any())
    for name in ("self_k", "self_v"):
        assert torch.equal(getattr(s.cache, name)[:, :, :, :t], getattr(ref.cache, name)[:, :, :, :t]), name
    for name in ("cross_k", "cross_v"):
        assert torch.equal(getattr(s.cache, name), getattr(ref.cache, name)), name
    for name in ("logits", "tokens", "pattern", "fused_mask"):
        assert torch.equal(getattr(s, name), getattr(ref, name)), name
    assert torch.equal(s.enc_mask, ref.enc_mask.to(s.enc_mask.dtype))


# --- spans and counters on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_captures_succeed_with_tracing_on(cuda):
    """Traced, a fresh model captures its bucket graphs and its prefill
    (each in a ``generate.capture`` span with its signature, seconds and
    bytes) and replays them, with the tokens of an untraced call bit for
    bit; the counters move as the spans say: a capture per step span, the
    segments' steps replayed, their kept positions counted."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.generation import generate as pgen

    model = _decode_model(torch.bfloat16)
    gen = pcfg.GenerationConfig(max_length=DECODE_LENGTH, do_sample=True, top_k=50)
    inputs = _decode_inputs(2)
    names = ("decode.captures", "decode.replays", "decode.positions", "prefill.captures", "prefill.replays")
    before = {name: counter(name) for name in names}
    profiling.reset()
    with profiling.tracing():
        traced = [pgen.generate_tokens(model, gen, max_length=DECODE_LENGTH,
                                       generator=torch.Generator(device="cuda").manual_seed(5), **inputs)
                  for _ in range(2)]
    moved = {name: counter(name) - before[name] for name in names}
    plain, t = pgen.generate_tokens(model, gen, max_length=DECODE_LENGTH,
                                    generator=torch.Generator(device="cuda").manual_seed(5), **inputs)
    spans = profiling.records()
    profiling.reset()
    assert all(torch.equal(tokens, plain) and stop == t for tokens, stop in traced)
    captures = [s for s in spans if s["name"] == "generate.capture"]
    steps = [s for s in captures if s["attrs"]["kind"] == "step"]
    assert moved["decode.captures"] == len(steps) == len(pgen._kv_read_limits(10, 9 + DECODE_LENGTH, 8,
                                                                              batch_rows=2)) >= 2
    assert moved["prefill.captures"] == len(captures) - len(steps) == 1 and moved["prefill.replays"] == 1
    assert all(s["attrs"]["nbytes"] >= 0 and s["attrs"]["seconds"] > 0 and s["device_s"] > 0 for s in captures)
    segments = [s for s in spans if s["name"] == "generate.segment"]
    assert moved["decode.replays"] == sum(s["attrs"]["steps"] for s in segments)
    assert moved["decode.positions"] == sum(s["attrs"]["units"] for s in segments) == 2 * (t - 1)
    assert all(s["device_s"] > 0 and s["device_end_s"] > s["device_start_s"] >= 0 for s in segments)
    assert [s["attrs"]["route"] for s in spans if s["name"] == "generate.prefill"] == ["captured", "replayed"]


@pytest.mark.cuda
def test_a_span_opened_under_capture_records_no_event(cuda):
    """A span opened while its stream is captured records no CUDA event (a
    graph replays without it); the span around the capture times it."""
    x = torch.ones(8, device="cuda")
    graph = torch.cuda.CUDAGraph()
    profiling.reset()
    with profiling.tracing():
        with profiling.span("around", x.device):
            with torch.cuda.graph(graph):
                with profiling.span("inside", x.device):
                    y = x * 2
    graph.replay()
    torch.cuda.synchronize()
    by = {s["name"]: s for s in profiling.records()}
    profiling.reset()
    assert by["inside"]["device_s"] is None and by["inside"]["parent"] == by["around"]["id"]
    assert by["around"]["device_s"] > 0 and torch.equal(y, x * 2)


@pytest.mark.cuda
def test_a_tts_call_on_the_card_off_and_on(cuda, monkeypatch):
    """Off, a ``tts`` call on the card makes no CUDA event and no record;
    on, every span of its tree but ``tts.tokenize`` has device seconds
    within its parent's, and the waveforms are the untraced call's bit for
    bit."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer

    model = _decode_model(torch.bfloat16)
    tok = ToyTokenizer(model.cfg.vocab_size)
    pipe = ParlerTTSPipeline(model, model.cfg, pcfg.GenerationConfig(do_sample=True, top_k=50), tok, tok,
                             dtype=torch.bfloat16, device="cuda")
    texts = (["a calm voice", "a fast and bright voice"], ["hello there", "how are you today"])
    pipe.tts(*texts, seed=1, max_seconds=1.0)  # captures
    profiling.reset()
    with profiling.tracing():
        _, traced = pipe.tts(*texts, seed=1, max_seconds=1.0)
    spans = profiling.records()
    profiling.reset()
    real_event = torch.cuda.Event

    def no_event(*args, **kwargs):
        raise AssertionError("tracing off made a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    _, plain = pipe.tts(*texts, seed=1, max_seconds=1.0)
    monkeypatch.setattr(torch.cuda, "Event", real_event)
    assert profiling.records() == []
    for a, b in zip(traced, plain, strict=True):
        np.testing.assert_array_equal(a, b)
    by_id = {s["id"]: s for s in spans}
    assert {s["name"] for s in spans if s["device_s"] is None} == {"tts.tokenize"}
    for s in spans:
        parent = by_id.get(s["parent"])
        if parent is not None and s["device_s"] is not None:
            assert parent["device_start_s"] <= s["device_start_s"] <= s["device_end_s"] <= parent["device_end_s"]


@pytest.mark.cuda
def test_generate_between_two_chunks_of_an_open_stream(cuda):
    """On the same thread, ``generate`` with the stream's signature between
    two of its chunks neither deadlocks nor changes the stream's codes: it
    runs on a second instance of the signature; the stream's end releases
    its lease, and a stream closed after its first chunk releases it too."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.generation import generate as pgen
    from parler_tts_tpu_torch.generation import streaming as pstream
    from parler_tts_tpu_torch.models.delay_pattern import undelay_pattern

    model = _decode_model(torch.bfloat16)
    gen = pcfg.GenerationConfig(max_length=DECODE_LENGTH, do_sample=False)
    inputs = _decode_inputs(2)
    ref, _ = _stream_codes(model, gen, inputs, seed=0)
    programs = pgen._programs_of(model)
    it = pstream.stream_generate(model, gen, chunk_frames=40, vocode=False, **inputs)
    codes = [next(it).codes]
    tokens, _ = pgen.generate_tokens(model, gen, max_length=gen.max_length, **inputs)
    assert len(programs.leased) == 1 and len(programs) == 2
    codes += [c.codes for c in it]
    np.testing.assert_array_equal(np.concatenate(codes, axis=2), ref)
    np.testing.assert_array_equal(undelay_pattern(tokens[:, :, 1:]).cpu().numpy()[:, :, :ref.shape[2]], ref)
    assert not programs.leased
    it = pstream.stream_generate(model, gen, chunk_frames=40, vocode=False, **inputs)
    next(it)
    assert programs.leased
    it.close()
    assert not programs.leased


# --- the captured train and eval steps -------------------------------------------------------------

TRAIN_STEPS = 4


def _train_setup(layerdrop: float = 0.0):
    """The dummy config (dropout 0.1) at fp32 on the card, and two batches
    of two rows of one shape (fused T = 10 + 80 + 11)."""
    import dataclasses

    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.models import parler as pparler
    from parler_tts_tpu_torch.training import data as pdata
    from parler_tts_tpu_torch.training import run_training as prun

    cfg = pcfg.dummy_config()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, dropout=0.1, layerdrop=layerdrop))
    model = pparler.init(0, cfg, device="cuda")
    batches = []
    for seed in (0, 1):
        samples = prun.prepare_synthetic(2, cfg, seed=seed, desc_len=12, prompt_len=10, codes_len=80)
        batches.append(pdata.Collator(0, 0, 12, 10, 80 + cfg.decoder.num_codebooks + 2)(samples))
    return cfg, model, batches


def _train_run(cfg, model, batches, *, captured: bool, remat: bool = False, lr: float = 1e-3, steps=TRAIN_STEPS):
    """``steps`` bf16 train steps of a copy of ``model`` on one route: the
    losses and norms, the trained parameters, the kernel launches per step
    and the state's graphs."""
    import copy

    from parler_tts_tpu_torch.training import step as pstep

    state = pstep.create_state(copy.deepcopy(model), learning_rate=lr, warmup_steps=1)
    step = pstep.make_train_step(cfg, dtype=torch.bfloat16, dropout_seed=0, remat=remat)
    real = pgraphs.capturable
    if not captured:
        pgraphs.capturable = lambda device, groups=(): False
    try:
        before = _launched("flash_attention_fwd", *BWD)
        out = [step(state, batches[i % len(batches)]) for i in range(steps)]
        after = _launched("flash_attention_fwd", *BWD)
    finally:
        pgraphs.capturable = real
    return {"losses": torch.stack([m["loss"] for m in out]), "norms": torch.stack([m["grad_norm"] for m in out]),
            "params": [p.detach().clone() for p in state.optimizer.params],
            "launches": [(a - b) / steps for a, b in zip(after, before)], "graphs": state.graphs}


def _gap(a: dict, b: dict) -> list[float]:
    return [float((a["losses"] - b["losses"]).abs().max()), float((a["norms"] - b["norms"]).abs().max()),
            max(float((x - y).abs().max()) for x, y in zip(a["params"], b["params"]))]


@pytest.mark.cuda
@pytest.mark.parametrize("backward,remat,layerdrop", [("k2_k3", False, 0.0), ("k2_k3", True, 0.25),
                                                      ("k4", False, 0.0)])
def test_captured_train_steps_equal_the_eager_steps(cuda, monkeypatch, backward, remat, layerdrop):
    """Four steps on each route from the same state, dropout on: one
    capture, then replays; K1 (twice with remat) and the backward kernels
    launch once per layer per step on both routes, counted through
    replays (eagerly, once per layer that layerdrop keeps).  With K2 + K3
    (forced: every kernel of the step sums in a fixed order; remat and
    layerdrop's device mask on one case) the captured losses, norms and
    parameters are the eager ones bit for bit, as two eager runs are; with
    K4, whose dq sums with fp32 atomics, they are within 8 times the
    spread of two eager runs."""
    monkeypatch.setenv("PARLER_FLASH_NO_FUSED_BWD", "1" if backward == "k2_k3" else "0")
    cfg, model, batches = _train_setup(layerdrop)
    eager = _train_run(cfg, model, batches, captured=False, remat=remat)
    again = _train_run(cfg, model, batches, captured=False, remat=remat)
    captured = _train_run(cfg, model, batches, captured=True, remat=remat)
    from parler_tts_tpu_torch.models.decoder import train_draws
    from parler_tts_tpu_torch.training.step import dropout_generator

    layers = cfg.decoder.num_hidden_layers
    kept = sum(sum(train_draws(dropout_generator(0, s), layers, layerdrop)[1] or [True] * layers)
               for s in range(TRAIN_STEPS)) / TRAIN_STEPS  # the eager route skips the others
    assert kept < layers if layerdrop else kept == layers
    for run, n in ((eager, kept), (captured, layers)):  # the captured route runs every layer
        k1 = 2 * n if remat else n  # remat runs each layer's forward again in the backward
        assert run["launches"] == ([k1, n, n, 0] if backward == "k2_k3" else [k1, 0, 0, n])
    assert (captured["graphs"].captures, captured["graphs"].replays) == (1, TRAIN_STEPS - 1)
    spread, gap = _gap(eager, again), _gap(eager, captured)
    print(f"{backward} remat={remat}: spread of two eager runs {spread}, captured vs eager {gap}")
    if backward == "k2_k3":
        assert spread == gap == [0.0, 0.0, 0.0]
    else:
        assert all(g <= 8 * s for g, s in zip(gap, spread))


@pytest.mark.cuda
def test_replays_at_different_steps_draw_different_masks(cuda, monkeypatch):
    """At learning rate 0 the parameters stay as they are: replays of one
    batch at steps 0-3 give four different losses (each its step's masks),
    each the eager step's bit for bit, and a replay at step 0 again gives
    step 0's loss."""
    from parler_tts_tpu_torch.training import step as pstep

    monkeypatch.setenv("PARLER_FLASH_NO_FUSED_BWD", "1")
    cfg, model, batches = _train_setup()
    eager = _train_run(cfg, model, batches[:1], captured=False, lr=0.0)
    state = pstep.create_state(model, learning_rate=0.0, warmup_steps=1)
    step = pstep.make_train_step(cfg, dtype=torch.bfloat16, dropout_seed=0)
    losses = torch.stack([step(state, batches[0])["loss"] for _ in range(TRAIN_STEPS)])
    assert len(set(losses.tolist())) == TRAIN_STEPS and torch.equal(losses, eager["losses"])
    state.step = 0
    assert torch.equal(step(state, batches[0])["loss"], losses[0])
    assert state.graphs.captures == 1


@pytest.mark.cuda
def test_captured_eval_step_equals_the_eager_eval(cuda):
    """The eval pass captured per batch shape (K1 once per layer, counted
    through the replay) gives the eager pass's loss bit for bit."""
    from parler_tts_tpu_torch.training import step as pstep

    cfg, model, batches = _train_setup()
    step = pstep.make_eval_step(cfg, dtype=torch.bfloat16)
    before = _launched("flash_attention_fwd")
    got = [step(model, b)["loss"] for b in batches]
    assert _launched("flash_attention_fwd") - before == 2 * cfg.decoder.num_hidden_layers
    graphs = pstep._eval_graphs(model)
    assert (graphs.captures, graphs.replays) == (1, 1)
    real = pgraphs.capturable
    pgraphs.capturable = lambda device, groups=(): False
    try:
        want = [step(model, b)["loss"] for b in batches]
    finally:
        pgraphs.capturable = real
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# --- failed captures ----------------------------------------------------------------------------


def _draw_from_every_generator(generators=()):
    """A failed capture must leave the default CUDA generator and the
    caller's usable: one draw from each, synchronised."""
    torch.rand(4, device="cuda")
    for gen in generators:
        torch.rand(4, device="cuda", generator=gen)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_failed_capture_leaves_the_generators_usable(cuda):
    """``core/graphs.record`` of a function that draws from the default
    generator and a registered one and then reads the device on the host:
    the capture raises, and both generators draw again, with no reset by
    the caller; a capture after it works."""
    from parler_tts_tpu_torch.core import graphs

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.zeros(8, device="cuda")

    def syncing():
        x.copy_(torch.rand(8, device="cuda") + torch.rand(8, device="cuda", generator=gen))
        float(x.sum())  # a host read: not permitted while a stream is captured

    with pytest.raises(RuntimeError):
        graphs.record(syncing, graphs.new_pool(), [gen])
    _draw_from_every_generator([gen])
    graph, _ = graphs.record(lambda: x.copy_(torch.rand(8, device="cuda", generator=gen)), graphs.new_pool(), [gen])
    gen.manual_seed(5)
    graph.replay()
    assert torch.equal(x, torch.rand(8, device="cuda", generator=torch.Generator(device="cuda").manual_seed(5)))


@pytest.mark.cuda
def test_a_failed_train_step_capture_raises(cuda, monkeypatch):
    """No fallback to the eager step: a train step that reads the device
    on the host cannot be captured, the step raises and keeps no graph,
    and the default generator and a new one draw afterwards."""
    from parler_tts_tpu_torch.training import step as pstep

    cfg, model, batches = _train_setup()
    real = pstep._grads

    def syncing(loss, params):
        float(loss)  # a host read: not permitted while a stream is captured
        return real(loss, params)

    monkeypatch.setattr(pstep, "_grads", syncing)
    state = pstep.create_state(model, learning_rate=1e-3, warmup_steps=1)
    with pytest.raises(RuntimeError):
        pstep.make_train_step(cfg, dtype=torch.bfloat16, dropout_seed=0)(state, batches[0])
    assert len(state.graphs) == 0
    _draw_from_every_generator([torch.Generator(device="cuda").manual_seed(1)])


@pytest.mark.cuda
def test_a_failed_prefill_capture_raises(cuda, monkeypatch):
    """No fallback: a prefill that reads the device on the host cannot be
    captured, and generation raises."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.generation import generate as pgen

    model = _decode_model(torch.float32)
    real = pgen._prefill_tensors

    def syncing(*args, **kw):
        out = real(*args, **kw)
        float(out[2].sum())  # a host read: not permitted while a stream is captured
        return out

    monkeypatch.setattr(pgen, "_prefill_tensors", syncing)
    gen = pcfg.GenerationConfig(max_length=40, do_sample=False)
    with pytest.raises(RuntimeError):
        pgen.generate_tokens(model, gen, max_length=40, **_decode_inputs(2))
    _draw_from_every_generator()


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda, monkeypatch):
    """No fallback to the eager loop: a step that reads the device on the
    host cannot be captured, and generation raises."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.generation import generate as pgen
    from parler_tts_tpu_torch.generation import sampling

    model = _decode_model(torch.float32)
    real = sampling.process_logits

    def syncing(logits, gen):
        float(logits.sum())  # a host read: not permitted while a stream is captured
        return real(logits, gen)

    monkeypatch.setattr(sampling, "process_logits", syncing)
    gen = pcfg.GenerationConfig(max_length=40, do_sample=False)
    with pytest.raises(RuntimeError):
        pgen.generate_tokens(model, gen, max_length=40, **_decode_inputs(2))
    _draw_from_every_generator()


# --- the Nemotron-H family: K8, and K1 and K5 at head dim 128 ----------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,p,n,groups,dtype", [
    (128, 64, 64, 128, 8, torch.bfloat16),  # the cell's step: 128 rows of Nemotron-3-Nano's heads
    (3, 4, 8, 64, 2, torch.bfloat16),
    (3, 4, 12, 128, 1, torch.float32),  # rows a warp takes not a multiple of its 4 in flight
])
def test_ssm_step_kernel_matches_plain_version(cuda, b, heads, p, n, groups, dtype):
    """K8 against its plain version, x, B, C and dt read through the row
    strides of one projection row: the fp32 state updated in place within
    1e-5 (sums in another order), y within one output rounding (bf16: 2^-7
    relative; fp32 1e-5), one launch counted."""
    from parler_tts_tpu_torch.ops import ssm

    g = torch.Generator(device="cuda").manual_seed(b)
    state = torch.randn((b, heads, p, n), generator=g, device="cuda")
    inner, bc = heads * p, groups * n
    row = torch.randn((b, 2 * inner + 2 * bc + heads + 5), generator=g, device="cuda").to(dtype)
    x, bm, cm = row[:, inner:2 * inner], row[:, 2 * inner:2 * inner + bc], row[:, 2 * inner + bc:2 * inner + 2 * bc]
    dt = row[:, 2 * inner + 2 * bc:2 * inner + 2 * bc + heads]
    dt_bias = (-2.0 - 4.0 * torch.rand(heads, generator=g, device="cuda")).to(dtype)
    a_log = torch.log(1.0 + 15.0 * torch.rand(heads, generator=g, device="cuda")).to(dtype)
    d = torch.randn(heads, generator=g, device="cuda").to(dtype)
    want_state = state.clone()
    want = ssm.ssm_step_plain(want_state, x, bm, cm, dt, dt_bias, a_log, d)
    before, ptr = _launched("ssm_step"), state.data_ptr()
    y = ssm.ssm_step(state, x, bm, cm, dt, dt_bias, a_log, d)
    torch.cuda.synchronize()
    assert _launched("ssm_step") == before + 1 and state.data_ptr() == ptr
    torch.testing.assert_close(state, want_state, atol=1e-5, rtol=1e-5)
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), want.float(), atol=1e-4, rtol=rtol)


@pytest.mark.cuda
def test_k1_takes_head_dim_128_in_bf16_only(cuda):
    q = torch.zeros((2, 8, 128), device="cuda")
    bounds = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        pfa.flash_attention_fwd(q, q, q, bounds, bounds)
    with pytest.raises(ValueError, match="head dim"):  # the backward kernels stop at 64
        pfa.flash_attention_dq(*(q.bfloat16(),) * 4, q[..., :1].contiguous(), q[..., :1].contiguous(), bounds,
                               bounds)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kv_heads,group,r,max_len", [
    (128, 2, 16, 129, None),  # the Nemotron-H cell's self attention: 2 K/V heads of 16 queries, first bucket
    (128, 2, 16, 822, None),  # its fused length at the last step
    (128, 32, 1, 64, 64),  # its cross attention (MHA, group 1)
    (1, 2, 16, 934, None),  # the split route at group 16
    (3, 2, 16, 333, None),
    (3, 2, 4, 333, None),
])
def test_decode_attention_at_head_dim_128_matches_plain_version(cuda, b, kv_heads, group, r, max_len):
    """K5 at head dim 128 (groups 1, 4 and 16) against its plain version,
    bf16."""
    from parler_tts_tpu_torch.ops import decode_attention as pda

    _, k, v, mask = _decode_attention_inputs(b, kv_heads, r, 128, torch.bfloat16, max_len=max_len)
    g = torch.Generator(device="cuda").manual_seed(1)
    q = (torch.randn((b, kv_heads * group, 1, 128), generator=g, device="cuda") / 11.3).to(torch.bfloat16)
    out = pda.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    _assert_decode_close(out, pda.decode_attention_plain(q, k, v, mask), torch.bfloat16)


@pytest.mark.cuda
def test_a_captured_nemotron_h_call_launches_k8_once_a_mamba_layer(cuda):
    """A replayed ``tts`` call of a small bf16 Nemotron-H decoder (head dim
    128, K5 at group 4, a state of 64, a share of the experts) runs every
    Mamba layer's step through K8 and every attention block's self and cross
    attention through K5: their launches grow by 3 and 2 per replayed step,
    counted through the step graphs' replays; its waveforms are finite."""
    from parler_tts_tpu_torch.core import config as pcfg
    from parler_tts_tpu_torch.models import parler as pparler
    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.utils.toy_tokenizer import ToyTokenizer

    base = pcfg.dummy_config(4)
    dec = pcfg.DecoderConfig(vocab_size=1088, hidden_size=256, num_hidden_layers=7, num_attention_heads=8,
                             num_codebooks=4, max_position_embeddings=1024, block_type="nemotron_h",
                             layer_types=pcfg.nemotron_h_layer_types("MEM*EME"), num_key_value_heads=2,
                             num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64, use_expert_bias=True,
                             routed_scaling_factor=2.5, attention_head_dim=128, mamba_num_heads=4,
                             mamba_head_dim=16, ssm_state_size=64, mamba_n_groups=2, use_conv_bias=True,
                             chunk_size=16, moe_shared_expert_intermediate_size=96, experts_held=4, first_expert=2)
    cfg = pcfg.ParlerTTSConfig(vocab_size=512, text_encoder=base.text_encoder,
                               audio_encoder=pcfg.EncodecConfig(num_codebooks=4), decoder=dec)
    model = pparler.init(0, cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():  # no special id but EOS: every row runs its second
        model.decoder.lm_heads.kernel[..., cfg.audio_encoder.codebook_size + 1:] = 0
    tok = ToyTokenizer(cfg.vocab_size)
    pipe = ParlerTTSPipeline(model, cfg, pcfg.GenerationConfig(do_sample=True, top_k=50), tok, tok,
                             dtype=torch.bfloat16, device="cuda")
    words = "a calm voice reads the news slowly in a quiet room".split()
    texts = ([" ".join(words[: 3 + i % 8]) for i in range(6)], [" ".join(words[: 1 + i % 10]) for i in range(6)])
    pipe.tts(*texts, seed=1, max_seconds=1.0)  # captures
    launches, replays = _launched("ssm_step", "decode_attention"), counter("decode.replays")
    _, audio = pipe.tts(*texts, seed=2, max_seconds=1.0)
    steps = counter("decode.replays") - replays
    k8, k5 = (now - then for now, then in zip(_launched("ssm_step", "decode_attention"), launches))
    assert steps > 0 and (k8, k5) == (3 * steps, 2 * steps)
    assert all(np.isfinite(a).all() for a in audio)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [128, 128 * 65])
def test_a_grouped_expert_share_matches_the_loop_at_the_cell_shapes(cuda, tokens):
    """The Nemotron-H cell's expert share on the card: 16 of 128 relu2
    experts of 2688 -> 1856 -> 2688 held (experts 32-47), 6 a token, at its
    decode step's 128 tokens and its prefill's 128 x 65.  The pairs held
    elsewhere sort past the grouped products' last offset, whose rows they
    leave unwritten and the sum never reads: each token's output within 1e-2
    of the loop's (relative), the same counts, the pairs held elsewhere
    counted as such and none dropped."""
    from parler_tts_tpu_torch.ops import moe

    g = torch.Generator(device="cuda").manual_seed(5)
    e, held, first, h, f, k = 128, 16, 32, 2688, 1856, 6

    def draw(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(torch.bfloat16)

    up, down, router, bias = draw(held, h, f), draw(held, f, h), draw(h, e), draw(e)
    x = torch.randn((tokens, h), generator=g, device="cuda").to(torch.bfloat16)
    weights, experts = moe.route(x, router, bias, k, scaling=2.5, fp32_logits=True, eps=1e-20)
    stats = [torch.zeros(4, dtype=torch.int64, device="cuda") for _ in range(2)]
    got = moe.experts_grouped(x, up, down, weights, experts, stats[0], act=moe.relu2, first=first)
    ref = moe.experts_plain(x, up, down, weights, experts, stats[1], act=moe.relu2, first=first)
    mine = ((experts >= first) & (experts < first + held)).any(-1)
    assert bool(mine.any()) and not bool(mine.all())
    assert got[~mine].abs().max().item() == 0.0  # a token with no held expert gets nothing
    rel = ((got[mine].float() - ref[mine].float()).norm(dim=-1) / ref[mine].float().norm(dim=-1)).max().item()
    assert rel <= 1e-2
    pairs, touched, dropped, elsewhere = stats[0].tolist()
    held_pairs = int(((experts >= first) & (experts < first + held)).sum())
    assert stats[0].tolist() == stats[1].tolist() and (pairs, dropped, elsewhere) == (tokens * k, 0,
                                                                                      tokens * k - held_pairs)
