"""Stream speech chunk by chunk as the PyTorch port generates it, on the
card (``--device cuda``, the default) or the CPU: the first audio comes
after about ``chunk_frames / frame_rate`` seconds of decoding.

Usage:
  python examples/stream_speech_torch.py <model_dir> --prompt "..." --out out.wav

The artifact's own ``tokenizer.json`` is read; ``--tokenizer <dir>`` names
another tokenizer directory.
"""

import argparse
import dataclasses
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--description", default="A clear, expressive female voice.")
    ap.add_argument("--prompt", default="Streaming synthesis, one second at a time.")
    ap.add_argument("--max-seconds", type=float, default=10.0)
    ap.add_argument("--chunk-frames", type=int, default=86)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="out.wav")
    args = ap.parse_args()

    import torch

    from parler_tts_tpu_torch.generation.streaming import stream_generate
    from parler_tts_tpu_torch.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.utils.audio_io import write_wav

    pipe = ParlerTTSPipeline.from_pretrained(args.model_dir, tokenizer_name=args.tokenizer, device=args.device)
    if pipe.description_tokenizer is None:
        raise SystemExit(f"{args.model_dir} holds no tokenizer; pass --tokenizer <dir>")
    d = pipe.description_tokenizer([args.description], return_tensors="np")
    p = pipe.prompt_tokenizer([args.prompt], return_tensors="np")
    cfg = pipe.cfg
    gen = dataclasses.replace(pipe.gen, max_length=int(args.max_seconds * cfg.frame_rate))
    chunks = []
    t0 = time.time()
    for ch in stream_generate(pipe.model, gen, input_ids=d.input_ids, attention_mask=d.attention_mask,
                              prompt_input_ids=p.input_ids, prompt_attention_mask=p.attention_mask,
                              chunk_frames=args.chunk_frames,
                              generator=torch.Generator(device=pipe.device).manual_seed(args.seed),
                              device=pipe.device):
        print(f"t={time.time()-t0:6.2f}s  chunk: {ch.audio.shape[1]/cfg.sampling_rate:.2f}s audio"
              f"{'  (final)' if ch.finished else ''}")
        chunks.append(ch.audio)
    wav = np.concatenate(chunks, axis=1)[0]
    write_wav(args.out, wav, cfg.sampling_rate)
    print(f"wrote {args.out}: {len(wav)/cfg.sampling_rate:.2f}s")


if __name__ == "__main__":
    main()
