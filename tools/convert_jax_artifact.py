#!/usr/bin/env python3
"""Convert a JAX package model artifact into the PyTorch port's.

    python3 tools/convert_jax_artifact.py <jax_artifact_dir> <out_dir>

Reads the artifact with ``parler_tts_tpu.core.checkpoint.load_model``
(read-only), carries its parameters into a port ``ParlerTTSModel`` with
``core/from_jax.load_jax_params``, writes ``core/checkpoint.save_model``'s
artifact and copies the source's tokenizer and feature-extractor files
beside it.  It needs JAX and Orbax, so it runs on the CPU of a machine that
has the JAX package; the artifact it writes loads anywhere the port runs.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="JAX model artifact dir (parler_tts_tpu.core.checkpoint.save_model)")
    ap.add_argument("out", help="output port artifact dir")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import numpy as np

    from parler_tts_tpu.core import checkpoint as jax_checkpoint
    from parler_tts_tpu_torch.core import checkpoint as ck
    from parler_tts_tpu_torch.core.config import GenerationConfig, ParlerTTSConfig
    from parler_tts_tpu_torch.core.from_jax import load_jax_params
    from parler_tts_tpu_torch.models.parler import ParlerTTSModel

    params, jax_cfg, jax_gen = jax_checkpoint.load_model(args.src)
    cfg = ParlerTTSConfig.from_dict(jax_cfg.to_dict())
    gen = GenerationConfig.from_dict(jax_gen.to_dict())
    model = ParlerTTSModel(cfg)  # on the CPU: this machine runs JAX, not the card
    load_jax_params(model, jax.tree.map(np.asarray, params))
    ck.save_model(args.out, model, cfg, gen)
    carried = ck.carry_side_files(args.src, args.out)
    if carried:
        print(f"carried over: {', '.join(carried)}")
    print(f"converted {args.src} -> {args.out} ({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
