"""The port's DAC encode side and offline audio tokenization against the JAX
package at fp32 on CPU: encoder latents, the residual quantizer's codes
(equal except at near-ties, which are counted), ``pad_audio``, the weight
carry-over of the encode side, ``tokenize_audio_batches``, ``CodesCache``
(each package reads the other's part files) and ``parse_dataset_spec``.

The codec is Mini's DAC with its strides (2, 4, 8, 8) and hop 512 at narrow
widths, so the JAX init stays quick."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.models import codec as jcodec
from parler_tts_tpu.models import dac as jdac
from parler_tts_tpu.training import data as jdata
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.models import codec as pcodec
from parler_tts_tpu_torch.models import dac as pdac
from parler_tts_tpu_torch.training import data as pdata
from tests.test_torch_blocks import T, jax_init, tiny_config

torch.set_num_threads(1)  # tier-1 runs several pytest workers

LATENT_RTOL = 1e-4  # relative Frobenius error of the encoder's latents
# a code may differ from JAX's only where the port's score of JAX's code is
# within this of its best (scores of unit vectors lie in [-1, 3])
CODE_TIE_TOL = 1e-4
WIDTHS = dict(num_codebooks=9, codebook_size=64, codebook_dim=8, latent_dim=64, encoder_hidden_size=8,
              decoder_hidden_size=32)


def narrow_dac(mod):
    return mod.DACConfig(**WIDTHS)


@pytest.fixture(scope="module")
def codecs():
    params = jax_init(jdac.init, narrow_dac(jcfg), 4)
    codec = pdac.DAC(narrow_dac(pcfg))
    load_jax_params(codec, params)
    return params, codec


def _audio(b: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    tone = np.sin(2 * np.pi * rng.uniform(80, 400, (b, 1)) * t)
    return (0.3 * tone + 0.05 * rng.standard_normal((b, n))).astype(np.float32)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(a)))


@pytest.mark.parametrize("n", [4410, 5000, 512 * 20])
def test_encoder_latents_match_jax(codecs, n):
    """Lengths that are and are not a multiple of the hop."""
    params, codec = codecs
    audio = _audio(2, n, seed=n)
    ref = jdac.encoder_forward(params["encoder"], narrow_dac(jcfg), jdac.pad_audio(audio, 512))
    with torch.no_grad():
        got = codec.encoder(pdac.pad_audio(T(audio), 512)[:, None]).transpose(1, 2)
    assert got.shape == ref.shape == (2, -(-n // 512), WIDTHS["latent_dim"])
    assert _rel(ref, got.numpy()) <= LATENT_RTOL


@pytest.mark.parametrize("n_quantizers", [None, 4])
def test_codes_match_jax_except_at_near_ties(codecs, n_quantizers):
    """Each code the port gives that JAX does not must be a near-tie: the
    port's score of JAX's code within CODE_TIE_TOL of its best.  The tie
    count is reported (0 on this machine's runs)."""
    params, codec = codecs
    audio = _audio(3, 512 * 40 + 77, seed=1)
    ref = np.asarray(jdac.encode(params, narrow_dac(jcfg), audio, n_quantizers=n_quantizers))
    got = pcodec.encode(codec, T(audio), n_quantizers=n_quantizers)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (3, n_quantizers or 9, 41)
    z = codec.encoder(pdac.pad_audio(T(audio), 512)[:, None]).transpose(1, 2)
    gaps = codec.quantizer.code_gaps(z, T(ref))
    ties = int((got.numpy() != ref).sum())
    print(f"codes differing from JAX's (near-ties): {ties} of {ref.size}")
    assert float(gaps.max()) <= CODE_TIE_TOL
    assert float(codec.quantizer.code_gaps(z, got).max()) == 0.0  # the port's own codes are its argmax


def test_code_gaps_see_a_wrong_code(codecs):
    """A code moved off the argmax shows a gap far above the tie tolerance."""
    _, codec = codecs
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 6, WIDTHS["latent_dim"])).astype(np.float32))
    codes = codec.quantizer.encode(z)
    wrong = codes.clone()
    wrong[0, 0, 3] = (wrong[0, 0, 3] + 1) % WIDTHS["codebook_size"]
    gaps = codec.quantizer.code_gaps(z, wrong)
    assert float(gaps[0, 0, 3]) > 100 * CODE_TIE_TOL and float(codec.quantizer.code_gaps(z, codes).max()) == 0.0


def test_pad_audio_matches_jax():
    x = np.arange(2 * 1030, dtype=np.float32).reshape(2, 1030)
    for hop in (512, 8, 1030):
        np.testing.assert_array_equal(pdac.pad_audio(T(x), hop).numpy(), np.asarray(jdac.pad_audio(x, hop)))


def test_load_jax_params_fills_the_encode_side(codecs):
    """Every encoder and in_proj leaf is carried (none skipped), convs in
    torch's layout."""
    params, codec = codecs
    conv = params["encoder"]["blocks"][2]["conv_down"]["kernel"]
    np.testing.assert_array_equal(codec.encoder.blocks[2].conv_down.weight.detach().numpy(),
                                  np.transpose(conv, (2, 1, 0)))
    np.testing.assert_array_equal(codec.quantizer.in_proj.kernel.detach().numpy(),
                                  params["quantizer"]["in_proj"]["kernel"])
    names = {n for n, _ in codec.named_parameters()}
    assert {n for n in names if n.startswith("encoder.")} and "quantizer.in_proj.bias" in names


def test_reset_parameters_draws_the_encode_side_as_jax_init():
    """Unit alphas, zero biases, 0.02 * truncnormal(-2, 2) kernels; the
    decode side's draws come first, so they do not depend on the encode
    side."""
    cfg = narrow_dac(pcfg)
    codec = pdac.DAC(cfg)
    codec.reset_parameters(torch.Generator().manual_seed(0))
    w = codec.encoder.blocks[3].res1.conv1.weight.detach()
    assert float(w.abs().max()) <= 0.04 and 0.012 < float(w.std()) < 0.02
    assert torch.equal(codec.encoder.snake_out.alpha, torch.ones_like(codec.encoder.snake_out.alpha))
    assert not codec.quantizer.in_proj.bias.any() and not codec.encoder.conv_in.bias.any()
    other = pdac.DAC(cfg)
    with torch.no_grad():
        for p in other.encoder.parameters():
            p.fill_(7.0)
    other.reset_parameters(torch.Generator().manual_seed(0))
    for (name, a), (_, b) in zip(codec.named_parameters(), other.named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kw", [dict(batch_size=2), dict(batch_size=3, pad_to_seconds=0.2)])
def test_tokenize_audio_batches_matches_jax(codecs, kw):
    """ceil(len / hop) frames of int16 codes per waveform, as JAX's."""
    params, codec = codecs
    lengths = (3000, 512 * 7, 6001, 1100, 4096)
    waves = [_audio(1, n, seed=n)[0] for n in lengths]
    ref = jdata.tokenize_audio_batches(params, narrow_dac(jcfg), waves, **kw)
    got = pdata.tokenize_audio_batches(codec, narrow_dac(pcfg), waves, **kw)
    assert len(got) == len(ref) == len(waves)
    for g, r, n in zip(got, ref, lengths):
        assert g.dtype == r.dtype == np.int16 and g.shape == r.shape == (9, -(-n // 512))
        np.testing.assert_array_equal(g, r)


def test_codes_cache_reads_each_others_parts(tmp_path):
    """Part file names, keys and int16 codes are the JAX package's: the port
    reads a JAX-written cache and JAX reads the port's."""
    rng = np.random.default_rng(5)
    codes = {i: rng.integers(0, 1024, (9, 5 + i)).astype(np.int32) for i in range(6)}
    jc = jdata.CodesCache(str(tmp_path), split="train", process_index=1, process_count=2)
    for i in (1, 3):
        jc.put(i, codes[i])
    jc.flush()
    pc = pdata.CodesCache(str(tmp_path), split="train")
    for i in (1, 3):
        np.testing.assert_array_equal(pc.get(i), codes[i].astype(np.int16))
        assert pc.get(i).dtype == np.int16
    assert pc.get(0) is None
    for i in (0, 4):
        pc.put(i, codes[i])
    pc.flush()
    pc.put(5, codes[5])
    pc.flush()
    assert sorted(p.name for p in (tmp_path / "train_codes").iterdir()) == [
        "h0of1_part000000.npz", "h0of1_part000001.npz", "h1of2_part000000.npz"]
    again = jdata.CodesCache(str(tmp_path), split="train")
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(again.get(i), codes[i].astype(np.int16))
    assert again._part == pdata.CodesCache(str(tmp_path), split="train")._part == 2


@pytest.mark.parametrize("args", [
    ("a+b", "x", "train+test", None, "10+20"), ("a", None, None, "meta", None),
    ("a++c", "x+y+z", None, "m1++m3", "1+2+3"), ("a+b", "x+y+z", None, None, None)])
def test_parse_dataset_spec_matches_jax(args):
    try:
        ref = jdata.parse_dataset_spec(*args)
    except ValueError:
        with pytest.raises(ValueError, match="mismatch"):
            pdata.parse_dataset_spec(*args)
        return
    got = pdata.parse_dataset_spec(*args)
    assert [vars(g) for g in got] == [vars(r) for r in ref]


def test_codec_encode_refuses_encodec_and_runs_tiny():
    """The dispatch encodes DAC (the tiny composite's codec too) and builds an
    EnCodec for an EnCodec config, whose composite encode refuses a
    normalized one, as JAX's does."""
    cfg = tiny_config(pcfg).audio_encoder
    codec = pcodec.build(cfg)
    codec.reset_parameters(torch.Generator().manual_seed(1))
    codes = pcodec.encode(codec, torch.zeros(2, 100))
    assert codes.shape == (2, cfg.num_codebooks, -(-100 // cfg.hop_length))
    assert jcodec.is_encodec(jcfg.EncodecConfig()) and pcodec.is_encodec(jcfg.EncodecConfig())
    normalized = pcodec.build(pcfg.EncodecConfig(normalize=True, num_filters=2, hidden_size=8))
    assert type(normalized).__name__ == "Encodec"
    with pytest.raises(ValueError, match="codes-only"):
        pcodec.encode(normalized, torch.zeros(1, 640))
    with pytest.raises(ValueError, match="codes-only"):
        jcodec.encode(None, jcfg.EncodecConfig(normalize=True), np.zeros((1, 640), np.float32))


@pytest.mark.parametrize("side", ["encode", "decode"])
def test_codec_convolutions_run_with_tf32_off_and_restore_the_flag(codecs, side, monkeypatch):
    """cuDNN runs fp32 convolutions in TF32 by default; the codec turns it
    off around its conv stacks (an fp32 codec is fp32, as JAX's offline
    tokenizer is) and leaves the caller's flag as it found it."""
    _, codec = codecs
    seen = []
    stack = codec.encoder if side == "encode" else codec.decoder
    real = stack.forward
    monkeypatch.setattr(stack, "forward", lambda x: seen.append(torch.backends.cudnn.allow_tf32) or real(x))
    for flag in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
        if side == "encode":
            codec.encode(T(_audio(1, 1024)))
        else:
            codec.decode(torch.zeros((1, 9, 3), dtype=torch.int64))
        assert torch.backends.cudnn.allow_tf32 is flag
    assert seen == [False, False]
