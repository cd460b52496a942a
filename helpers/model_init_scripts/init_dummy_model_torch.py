"""Initialize the tiny smoke-test model (4x512 decoder) as a PyTorch port
artifact: the counterpart of ``init_dummy_model.py``, whose
``config.json`` and ``generation_config.json`` it writes byte for byte.

Usage: python helpers/model_init_scripts/init_dummy_model_torch.py <save_dir>
       [--num-codebooks 9] [--seed 0] [--device cpu]

The weights are drawn from ``--seed`` on ``--device`` (default ``cuda``)
with the JAX ``init``'s distributions (``models/parler.init``), not its
values.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from parler_tts_tpu_torch.core import checkpoint as ck  # noqa: E402
from parler_tts_tpu_torch.core.config import GenerationConfig, dummy_config  # noqa: E402
from parler_tts_tpu_torch.models import parler  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("save_dir")
    ap.add_argument("--num-codebooks", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where the weights are drawn: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = dummy_config(num_codebooks=args.num_codebooks)
    model = parler.init(args.seed, cfg, device=args.device)
    gen = GenerationConfig(
        max_length=30 * cfg.frame_rate,
        do_sample=True,
        decoder_start_token_id=cfg.decoder.bos_token_id,
        pad_token_id=cfg.decoder.pad_token_id,
        bos_token_id=cfg.decoder.bos_token_id,
        eos_token_id=cfg.decoder.eos_token_id,
    )
    ck.save_model(args.save_dir, model, cfg, gen)
    print(f"saved dummy model to {args.save_dir}")


if __name__ == "__main__":
    sys.exit(main())
