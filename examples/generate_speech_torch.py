"""Generate speech from a description and a prompt with the PyTorch port, on
the card (``--device cuda``, the default) or the CPU.

Usage:
  python examples/generate_speech_torch.py <model_dir> \
      --description "A female speaker with a low-pitched voice..." \
      --prompt "Hey, how are you doing today?" --out out.wav

``model_dir`` is a port artifact (the training CLI's ``final/``, or the
output of ``helpers/convert_reference_checkpoint_torch.py`` or
``tools/convert_jax_artifact.py``).  Its own ``tokenizer.json`` is read;
``--tokenizer <dir>`` names another tokenizer directory.
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--description", default="A female speaker with a slightly low-pitched "
                    "voice delivers her words quite expressively, with clear audio quality.")
    ap.add_argument("--prompt", default="Hey, how are you doing today?")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="out.wav")
    args = ap.parse_args()

    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.utils.audio_io import write_wav

    pipe = ParlerTTSPipeline.from_pretrained(args.model_dir, tokenizer_name=args.tokenizer, device=args.device)
    sr, (wav,) = pipe.tts(args.description, args.prompt, seed=args.seed, max_seconds=args.max_seconds)
    write_wav(args.out, wav, sr)
    print(f"wrote {args.out}: {len(wav)/sr:.2f}s @ {sr} Hz")


if __name__ == "__main__":
    main()
