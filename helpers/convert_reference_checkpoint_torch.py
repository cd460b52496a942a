"""Convert a reference (HF Parler-TTS) checkpoint directory into the PyTorch
port's model artifact, which ``ParlerTTSPipeline.from_pretrained`` serves.

    python helpers/convert_reference_checkpoint_torch.py <hf_checkpoint_dir> <out_dir> [--device cpu]

The directory is read by ``parler_tts_tpu_torch.core.from_reference``
(``config.json``, ``generation_config.json``, single or sharded safetensors
or ``pytorch_model.bin``) and written by ``core/checkpoint.save_model``; the
source's tokenizer and feature-extractor files are copied beside it.  The
weights are loaded on ``--device`` (default ``cuda``) on the way through.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="reference checkpoint dir (config.json + weights)")
    ap.add_argument("out", help="output artifact dir")
    ap.add_argument("--device", default="cuda", help="device the weights pass through: cuda (default) or cpu")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.core.from_reference import from_reference_pretrained

    model, cfg, gen = from_reference_pretrained(args.src, device=args.device)
    ck.save_model(args.out, model, cfg, gen)
    carried = ck.carry_side_files(args.src, args.out)
    if carried:
        print(f"carried over: {', '.join(carried)}")
    decoder_m = sum(p.numel() for p in model.decoder.parameters()) / 1e6
    print(f"converted {args.src} -> {args.out} (decoder {decoder_m:.0f}M params, "
          f"{cfg.decoder.num_codebooks} codebooks, {cfg.audio_encoder.codec_type} at {cfg.sampling_rate} Hz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
