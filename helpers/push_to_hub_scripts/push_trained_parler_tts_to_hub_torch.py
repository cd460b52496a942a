"""Push a trained model artifact of the PyTorch port to the Hub: the
counterpart of ``push_trained_parler_tts_to_hub.py``.

The artifact (``core/checkpoint.save_model``'s directory, the training CLI's
``final/``) is validated by loading it with ``core/checkpoint.load_model``.
Pushing needs the network and Hub credentials; without them the script says
``push skipped (...)`` and returns 1.

Usage: python helpers/push_to_hub_scripts/push_trained_parler_tts_to_hub_torch.py <artifact_dir> <repo_id>
       [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from parler_tts_tpu_torch.core import checkpoint as ck  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("artifact_dir")
    ap.add_argument("repo_id")
    ap.add_argument("--device", default="cuda", help="where the artifact is loaded: cuda (default) or cpu")
    args = ap.parse_args(argv)

    _, cfg, _ = ck.load_model(args.artifact_dir, device=args.device)  # validates the artifact
    print(f"artifact OK: decoder {cfg.decoder.num_hidden_layers}L/{cfg.decoder.hidden_size}h, "
          f"{cfg.decoder.num_codebooks} codebooks")
    try:
        from huggingface_hub import HfApi

        HfApi().upload_folder(folder_path=args.artifact_dir, repo_id=args.repo_id)
        print(f"pushed to {args.repo_id}")
    except Exception as e:  # no network, no credentials, or no huggingface_hub
        print(f"push skipped ({e})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
