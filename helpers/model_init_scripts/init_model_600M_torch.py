"""Initialize the Mini-class (600M decoder) composite from scratch as a
PyTorch port artifact: the counterpart of ``init_model_600M.py``, whose
``config.json`` and ``generation_config.json`` it writes byte for byte.

It builds a randomly initialized 24 x 1024 decoder (9 codebooks, vocab
1024 + 64, 4096 positions) with a flan-t5-base-shaped text encoder and the
44.1 kHz DAC, and saves a complete artifact.  Local HF-format checkpoints
of the frozen encoders replace their random weights:

* ``--text-encoder``: a ``T5EncoderModel`` directory (Flan-T5 base);
* ``--dac``: a ``DacModel`` directory (the 44.1 kHz DAC);

each read with the port's own safetensors / ``pytorch_model.bin`` reader
(no ``transformers``) and imported through ``core/torch_import``; a
directory whose ``config.json`` geometry is not Mini's raises.  The
tokenizer of ``--tokenizer`` (default: ``--text-encoder``'s, which an HF
checkpoint carries) is bundled through ``utils/tokenizer.py``.

Usage: python helpers/model_init_scripts/init_model_600M_torch.py <save_dir>
       [--text-encoder <hf_t5_dir>] [--dac <hf_dac_dir>] [--tokenizer <dir>] [--seed 0] [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from parler_tts_tpu_torch.core import checkpoint as ck  # noqa: E402
from parler_tts_tpu_torch.core import torch_import as ti  # noqa: E402
from parler_tts_tpu_torch.core.config import GenerationConfig, mini_600m_config  # noqa: E402
from parler_tts_tpu_torch.core.from_reference import _codec_config_from_reference, load_reference_state_dict  # noqa: E402
from parler_tts_tpu_torch.models import codec as codec_mod  # noqa: E402
from parler_tts_tpu_torch.models import parler  # noqa: E402

T5_FIELDS = ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads", "relative_attention_num_buckets",
             "relative_attention_max_distance")
DAC_FIELDS = ("num_codebooks", "codebook_size", "codebook_dim", "latent_dim", "sampling_rate", "encoder_hidden_size",
              "downsampling_ratios", "decoder_hidden_size", "upsampling_ratios")


def _config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _check(path: str, what: str, got: dict, want: dict) -> None:
    wrong = [f"{k} {got[k]!r} (want {want[k]!r})" for k in want if got[k] != want[k]]
    if wrong:
        raise ValueError(f"{path}: this {what} is not the model's geometry: " + ", ".join(wrong))


def import_text_encoder(model, cfg, path: str) -> None:
    """A local HF ``T5EncoderModel`` directory's weights into
    ``model.text_encoder``, after its ``config.json`` is checked against
    ``cfg.text_encoder`` (the gated FFN included)."""
    hf = _config(path)
    te = cfg.text_encoder
    got = {k: hf.get(k) for k in T5_FIELDS}
    got["gated"] = hf.get("feed_forward_proj", "relu").startswith("gated")
    _check(path, "T5 encoder", got, {**{k: getattr(te, k) for k in T5_FIELDS}, "gated": te.is_gated_act})
    model.text_encoder.load_state_dict(ti.import_t5_encoder(load_reference_state_dict(path), te.num_layers))


def import_dac(model, cfg, path: str) -> None:
    """A local HF ``DacModel`` directory's weights into
    ``model.audio_encoder``, after its ``config.json`` is checked against
    ``cfg.audio_encoder``."""
    got = _codec_config_from_reference(_config(path), {})
    _check(path, "DAC", {k: getattr(got, k) for k in DAC_FIELDS},
           {k: getattr(cfg.audio_encoder, k) for k in DAC_FIELDS})
    model.audio_encoder.load_state_dict(codec_mod.import_torch(load_reference_state_dict(path), cfg.audio_encoder))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("save_dir")
    ap.add_argument("--text-encoder", default=None, help="local HF flan-t5 checkpoint dir")
    ap.add_argument("--dac", default=None, help="local HF DacModel checkpoint dir")
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer dir to bundle into the artifact (defaults to --text-encoder's, which carries "
                         "the flan-t5 tokenizer in HF checkpoints)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where the weights are drawn: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = mini_600m_config()
    model = parler.init(args.seed, cfg, device=args.device)
    if args.text_encoder:
        import_text_encoder(model, cfg, args.text_encoder)
    if args.dac:
        import_dac(model, cfg, args.dac)

    gen = GenerationConfig(
        max_length=30 * cfg.frame_rate,  # 30 s
        do_sample=True,
        guidance_scale=1.0,
        decoder_start_token_id=cfg.decoder.bos_token_id,
        pad_token_id=cfg.decoder.pad_token_id,
        bos_token_id=cfg.decoder.bos_token_id,
        eos_token_id=cfg.decoder.eos_token_id,
    )
    tok = None
    tok_src = args.tokenizer or args.text_encoder
    if tok_src:
        from parler_tts_tpu_torch.utils.tokenizer import Tokenizer

        try:
            tok = Tokenizer.from_pretrained(tok_src)
        except Exception as e:  # the JAX script's behaviour: the artifact goes without one
            print(f"tokenizer not bundled ({tok_src}: {e})", file=sys.stderr)
    ck.save_model(args.save_dir, model, cfg, gen, tokenizer=tok)
    decoder_params = sum(p.numel() for p in model.decoder.parameters())
    print(f"saved Mini-600M-class model to {args.save_dir} ({decoder_params / 1e6:.0f}M decoder params)")


if __name__ == "__main__":
    sys.exit(main())
