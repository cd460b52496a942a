"""Initialize a dummy composite over the ``facebook/encodec_24khz`` codec
geometry as a PyTorch port artifact: the counterpart of
``init_dummy_model_with_encodec.py``, whose ``config.json`` and
``generation_config.json`` it writes byte for byte.

The codec is the full 24 kHz EnCodec architecture (``models/encodec.py``:
causal SEANet conv + LSTM, 32-codebook Euclidean RVQ, hop 320, 75 Hz) with
random weights; the decoder models 8 of its codebooks.  Token ids: vocab =
codebook_size + 1, pad/eos = codebook_size, bos = codebook_size + 1.  Real
``EncodecModel`` weights load through ``core/torch_import.import_encodec``.

Usage: python helpers/model_init_scripts/init_dummy_model_with_encodec_torch.py <save_dir>
       [--seed 0] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from parler_tts_tpu_torch.core import checkpoint as ck  # noqa: E402
from parler_tts_tpu_torch.core.config import (  # noqa: E402
    DecoderConfig,
    EncodecConfig,
    GenerationConfig,
    ParlerTTSConfig,
    T5EncoderConfig,
)
from parler_tts_tpu_torch.models import parler  # noqa: E402


def encodec_dummy_config() -> ParlerTTSConfig:
    """The dummy decoder (4 x 512, 8 heads) over 8 codebooks of the 24 kHz
    EnCodec, with a 2-layer 64-wide T5."""
    codec = EncodecConfig(num_codebooks=8)
    assert codec.frame_rate == 75 and codec.hop_length == 320
    vocab = codec.codebook_size  # 1024
    return ParlerTTSConfig(
        vocab_size=32128,  # the T5 prompt tokenizer's
        text_encoder=T5EncoderConfig(d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4),
        audio_encoder=codec,
        decoder=DecoderConfig(
            vocab_size=vocab + 1, hidden_size=512, num_hidden_layers=4, num_attention_heads=8,
            ffn_dim=512, num_codebooks=codec.num_codebooks, max_position_embeddings=2048,
            pad_token_id=vocab, eos_token_id=vocab, bos_token_id=vocab + 1,
        ),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("save_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where the weights are drawn: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = encodec_dummy_config()
    codec, vocab = cfg.audio_encoder, cfg.audio_encoder.codebook_size
    model = parler.init(args.seed, cfg, device=args.device)
    gen = GenerationConfig(
        max_length=30 * codec.frame_rate, do_sample=True,
        decoder_start_token_id=vocab + 1, pad_token_id=vocab, bos_token_id=vocab + 1,
        eos_token_id=vocab,
    )
    ck.save_model(args.save_dir, model, cfg, gen)
    print(f"saved dummy model with real EnCodec codec to {args.save_dir} "
          f"({codec.num_codebooks} of {codec.num_quantizers} codebooks @ "
          f"{codec.frame_rate} Hz, {codec.sampling_rate} Hz audio)")


if __name__ == "__main__":
    sys.exit(main())
