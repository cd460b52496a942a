"""Convert a local HF ``DacModel`` checkpoint into the PyTorch port's DAC
artifact, and push it with ``--push``: the counterpart of
``push_dac_to_hub.py``.

The source directory (``config.json`` and safetensors or
``pytorch_model.bin`` weights) is read with the port's own reader and
imported through ``core/torch_import`` (weight norm folded), with no
``transformers``.  The output holds ``config.json``, the ``DACConfig`` dict
as the JAX script writes it, and ``weights.pt``, the state dict of
``models/dac.DAC(cfg)`` (it loads with ``strict=True``).  Pushing needs the
network and Hub credentials; without them the script says
``push skipped (...)``.

Usage: python helpers/push_to_hub_scripts/push_dac_to_hub_torch.py <local_dac_dir> <out_dir> [--push repo_id]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from parler_tts_tpu_torch.core.checkpoint import WEIGHTS_FILE  # noqa: E402
from parler_tts_tpu_torch.core.from_reference import (  # noqa: E402
    _codec_config_from_reference, load_reference_state_dict)
from parler_tts_tpu_torch.models import codec as codec_mod  # noqa: E402
from parler_tts_tpu_torch.models.dac import DAC  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("out")
    ap.add_argument("--push", default=None, help="hub repo id (requires network + auth)")
    args = ap.parse_args(argv)

    with open(os.path.join(args.src, "config.json")) as f:
        cfg = _codec_config_from_reference(json.load(f), {})
    codec = DAC(cfg)
    codec.load_state_dict(codec_mod.import_torch(load_reference_state_dict(args.src), cfg), strict=True)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
    torch.save(codec.state_dict(), os.path.join(args.out, WEIGHTS_FILE))
    print(f"converted {args.src} -> {args.out}")

    if args.push:
        try:
            from huggingface_hub import HfApi

            HfApi().upload_folder(folder_path=args.out, repo_id=args.push)
            print(f"pushed to {args.push}")
        except Exception as e:  # no network, no credentials, or no huggingface_hub
            print(f"push skipped ({e})", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
