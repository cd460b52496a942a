"""Reference (HF Parler-TTS) checkpoint import: the port's
``from_reference_pretrained`` and the JAX package's read the same directory
at fp32 on CPU, and must give equal configs, equal parameters (weight-norm
folded convolutions within one fp32 ulp, every other tensor bit for bit) and
the same greedy tokens.

The directories are written here in the reference's layout from random
weights: T5 from ``transformers.T5EncoderModel`` (gated and not), the codec
from ``transformers.DacModel`` or ``EncodecModel`` (random codebooks), the
decoder's tensors from a numpy seed under the reference's names; as one
``model.safetensors``, two shards behind an index, or ``pytorch_model.bin``;
with the codec convolutions plain, as ``weight_g`` / ``weight_v`` or as
``parametrizations.weight.original0/1``; and the codec under
``audio_encoder.model.*`` or ``audio_encoder.*``.  Also the port's own
safetensors reader against the ``safetensors`` package."""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from parler_tts_tpu.core.from_reference import from_reference_pretrained as jax_from_reference
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu_torch.core import from_reference as pref
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from tests.test_torch_blocks import close
from tests.test_torch_encodec import TINY_24K, hf_encodec

torch.set_num_threads(1)  # tier-1 runs several pytest workers

CODEBOOK = 32  # every codec here has 32 codes per codebook and 4 codebooks
SPECIAL_IDS = dict(bos_token_id=CODEBOOK + 1, pad_token_id=CODEBOOK, eos_token_id=CODEBOOK,
                   decoder_start_token_id=CODEBOOK + 1)
DAC_GEOMETRY = dict(encoder_hidden_size=8, downsampling_ratios=[2, 4], decoder_hidden_size=16,
                    upsampling_ratios=[4, 2], codebook_size=CODEBOOK, codebook_dim=4, sampling_rate=16000)


def _codec(kind: str) -> tuple[dict, dict]:
    """(the reference config.json's audio_encoder entry, the codec's
    state_dict) for ``kind``: the reference's DAC wrapper config, HF's
    ``DacConfig`` (both over an HF ``DacModel``) or HF's ``EncodecConfig``."""
    if kind == "encodec":
        m = hf_encodec(TINY_24K)
        return m.config.to_dict(), m.state_dict()
    from transformers import DacConfig, DacModel

    hf_cfg = DacConfig(n_codebooks=4, hidden_size=16, **DAC_GEOMETRY)
    torch.manual_seed(1)
    m = DacModel(hf_cfg).eval()
    if kind == "hf_dac":
        return hf_cfg.to_dict(), m.state_dict()
    # the reference's DAC wrapper config: the codebook facts and the geometry
    wrapper = dict(model_type="dac", num_codebooks=4, latent_dim=16, frame_rate=2000, model_bitrate=8,
                   **DAC_GEOMETRY)
    return wrapper, m.state_dict()


def _weight_norm_form(sd: dict, form: str) -> dict:
    """The codec's conv weights in ``form``: ``plain`` (``weight``),
    ``weight_g`` (``weight_g`` / ``weight_v``, torch's old weight_norm) or
    ``parametrizations`` (``parametrizations.weight.original0/1``); v = w and
    g = ||w|| over every dimension but 0 where the source is plain."""
    out = {}
    for name, t in sd.items():
        if name.endswith(".parametrizations.weight.original0"):
            base = name[: -len(".parametrizations.weight.original0")]
            g, v = t, sd[base + ".parametrizations.weight.original1"]
        elif name.endswith(".weight") and t.ndim == 3:
            base, v = name[: -len(".weight")], t
            g = t.double().square().sum(dim=(1, 2), keepdim=True).sqrt().float()
        else:
            if not name.endswith(".parametrizations.weight.original1"):
                out[name] = t
            continue
        if form == "plain":
            out[base + ".weight"] = (g.double() * v.double()
                                     / v.double().square().sum(dim=(1, 2), keepdim=True).sqrt()).float()
        elif form == "weight_g":
            out[base + ".weight_g"], out[base + ".weight_v"] = g, v
        else:
            out[base + ".parametrizations.weight.original0"] = g
            out[base + ".parametrizations.weight.original1"] = v
    return out


def _decoder_tensors(hidden: int, layers: int, ffn: int, vocab: int, k: int, seed: int) -> dict:
    """The reference decoder's tensors (``ParlerTTSForCausalLM`` names under
    ``decoder.``) drawn from a numpy seed."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.05):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    base = "decoder.model.decoder"
    sd = {f"{base}.embed_tokens.{c}.weight": w(vocab + 1, hidden, scale=0.5) for c in range(k)}
    for i in range(layers):
        lp = f"{base}.layers.{i}"
        for attn in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{lp}.{attn}.{proj}.weight"] = w(hidden, hidden, scale=0.2)
        for norm in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            sd[f"{lp}.{norm}.weight"] = 1.0 + w(hidden)
            sd[f"{lp}.{norm}.bias"] = w(hidden)
        sd[f"{lp}.fc1.weight"] = w(ffn, hidden, scale=0.2)
        sd[f"{lp}.fc2.weight"] = w(hidden, ffn, scale=0.2)
    sd[f"{base}.layer_norm.weight"] = 1.0 + w(hidden)
    sd[f"{base}.layer_norm.bias"] = w(hidden)
    sd.update({f"decoder.lm_heads.{c}.weight": w(vocab, hidden, scale=0.5) for c in range(k)})
    return sd


def write_reference_dir(path: str, *, codec: str, weights: str, norm_form: str, codec_prefix: str,
                        gated: bool = True, seed: int = 0) -> None:
    """A reference-format checkpoint directory (see the module docstring).
    ``weights``: ``safetensors``, ``sharded`` or ``bin``; ``codec_prefix``:
    ``audio_encoder.model`` or ``audio_encoder``."""
    from transformers import T5Config, T5EncoderModel

    t5_cfg = T5Config(vocab_size=100, d_model=24, d_kv=6, d_ff=48, num_layers=2, num_heads=4,
                      relative_attention_num_buckets=8, relative_attention_max_distance=20,
                      feed_forward_proj="gated-gelu" if gated else "relu", dropout_rate=0.0)
    torch.manual_seed(seed)
    t5 = T5EncoderModel(t5_cfg).eval()
    audio_cfg, codec_sd = _codec(codec)
    hidden, layers, ffn, vocab, k = 32, 2, 48, CODEBOOK + 1, 4
    decoder_cfg = dict(model_type="parler_tts_decoder", vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
                       num_attention_heads=4, ffn_dim=ffn, num_codebooks=k, max_position_embeddings=128,
                       activation_function="gelu", scale_embedding=False, pad_token_id=CODEBOOK,
                       bos_token_id=CODEBOOK + 1, eos_token_id=CODEBOOK)
    rng = np.random.default_rng(seed + 1)
    sd = {f"text_encoder.{n}": t for n, t in t5.state_dict().items()}
    sd.update({f"{codec_prefix}.{n}": t for n, t in _weight_norm_form(codec_sd, norm_form).items()})
    sd.update(_decoder_tensors(hidden, layers, ffn, vocab, k, seed + 2))
    sd["embed_prompts.weight"] = torch.from_numpy(rng.standard_normal((100, hidden)).astype(np.float32))
    sd["enc_to_dec_proj.weight"] = torch.from_numpy((rng.standard_normal((hidden, 24)) * 0.2).astype(np.float32))
    sd["enc_to_dec_proj.bias"] = torch.from_numpy((rng.standard_normal(hidden) * 0.1).astype(np.float32))

    os.makedirs(path, exist_ok=True)
    config = {"model_type": "parler_tts", "vocab_size": 100, "text_encoder": t5_cfg.to_dict(),
              "audio_encoder": audio_cfg, "decoder": decoder_cfg}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"max_length": 16, "do_sample": True, "guidance_scale": None, **SPECIAL_IDS}, f)
    if weights == "bin":  # torch.save keeps the tied T5 embedding under both names
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
        return
    from safetensors.torch import save_file

    sd = {n: t.contiguous() for n, t in sd.items()}
    if weights == "safetensors":  # HF drops one name of a tied pair: here the alias
        del sd["text_encoder.encoder.embed_tokens.weight"]
        save_file(sd, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
        return
    del sd["text_encoder.shared.weight"]  # the importer falls back to embed_tokens
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[::2], "model-00002-of-00002.safetensors": names[1::2]}
    for fname, part in shards.items():
        save_file({n: sd[n] for n in part}, os.path.join(path, fname), metadata={"format": "pt"})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(t.numel() * 4 for t in sd.values())},
                   "weight_map": {n: fname for fname, part in shards.items() for n in part}}, f)


def assert_params_equal_jax(model: ParlerTTSModel, params, folded: bool) -> None:
    """Every parameter of ``model`` equals the JAX tree's carried over by
    ``from_jax``: bit for bit, except the codec convolutions that weight
    norm folded, within one fp32 ulp."""
    carried = ParlerTTSModel(model.cfg)
    load_jax_params(carried, params)
    theirs = carried.state_dict()
    for name, mine in model.state_dict().items():
        ref = theirs[name]
        conv = name.startswith("audio_encoder.") and name.endswith((".weight", "proj.kernel"))
        if folded and conv:
            ulp = torch.nextafter(ref.abs(), torch.tensor(float("inf"))) - ref.abs()
            assert bool(((mine - ref).abs() <= ulp).all()), name
        else:
            assert torch.equal(mine, ref), name


CASES = [  # (weights, weight-norm form, codec prefix, codec config, gated T5): every value of each
    ("safetensors", "plain", "audio_encoder.model", "dac_wrapper", True),
    ("sharded", "weight_g", "audio_encoder", "hf_dac", False),
    ("bin", "parametrizations", "audio_encoder", "encodec", True),
    ("safetensors", "weight_g", "audio_encoder", "encodec", False),
    ("sharded", "parametrizations", "audio_encoder.model", "dac_wrapper", True),
    ("bin", "plain", "audio_encoder.model", "hf_dac", True),
]


@pytest.mark.parametrize("weights,norm_form,prefix,codec,gated", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_reference_dir_loads_as_jax_does(tmp_path, weights, norm_form, prefix, codec, gated):
    path = str(tmp_path / "ref")
    write_reference_dir(path, codec=codec, weights=weights, norm_form=norm_form, codec_prefix=prefix, gated=gated)
    params, jcfg, jgen = jax_from_reference(path)
    model, cfg, gen = pref.from_reference_pretrained(path, device="cpu")
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.audio_encoder.codec_type == ("encodec" if codec == "encodec" else "dac")
    shared = set(gen.to_dict()) & set(jgen.to_dict())
    assert {k: gen.to_dict()[k] for k in shared} == {k: jgen.to_dict()[k] for k in shared}
    assert (gen.top_k, gen.guidance_scale, gen.max_length) == (0, 1.0, 16)
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    assert_params_equal_jax(model, jax.tree.map(np.asarray, params), folded=norm_form != "plain")

    rng = np.random.default_rng(3)
    batch = dict(input_ids=rng.integers(0, 100, (2, 6)), prompt_input_ids=rng.integers(0, 100, (2, 4)),
                 attention_mask=np.array([[1] * 6, [1] * 4 + [0] * 2]))
    greedy = dataclasses.replace(jgen, do_sample=False)
    ref = jgenerate.generate(params, jcfg, greedy, key=jax.random.PRNGKey(0), **batch)
    out = pgenerate.generate(model, dataclasses.replace(gen, do_sample=False), device="cpu", **batch)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    close(ref.audio, out.audio, 1e-5)


def test_missing_and_extra_tensors_raise(tmp_path):
    """The strict load names what the checkpoint lacks (here the LM heads)
    or has beyond the model."""
    path = str(tmp_path / "ref")
    write_reference_dir(path, codec="hf_dac", weights="safetensors", norm_form="plain", codec_prefix="audio_encoder")
    sd = pref.load_reference_state_dict(path)
    from safetensors.torch import save_file

    save_file({n: t.contiguous() for n, t in sd.items() if not n.startswith("decoder.lm_heads.")},
              os.path.join(path, "model.safetensors"))
    with pytest.raises(RuntimeError, match="lm_heads"):
        pref.from_reference_pretrained(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        pref.load_reference_state_dict(str(tmp_path))


def test_safetensors_reader_matches_the_package(tmp_path):
    """F32, F16, BF16 and I64 tensors (a scalar, an empty one, odd sizes),
    with ``__metadata__`` in the header; each tensor a view of a
    copy-on-write map, so writing to it leaves the file as it was."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).half(),
               "c": torch.randn(2, 3, 2, generator=g).bfloat16(), "d": torch.arange(11, dtype=torch.int64) - 5,
               "s": torch.tensor(2.5), "e": torch.zeros(0, 4)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    got, ref = pref.read_safetensors(path), load_file(path)
    assert set(got) == set(ref) == set(tensors)
    for name, t in ref.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape and torch.equal(got[name], t), name
    got["a"].zero_()
    assert torch.equal(load_file(path)["a"], tensors["a"])
