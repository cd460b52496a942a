"""Fine-tune with the PyTorch port on a local dataset (or the synthetic smoke
set): a thin wrapper over the port's training CLI, on the card unless
``--device cpu`` is given.

Usage:
  python examples/finetune_torch.py --model_name_or_path <port_artifact_dir> \
      --train_dataset_name <local_hf_dataset_or_synthetic://N> \
      --output_dir ./output/finetune --max_steps 100

Every flag of the training CLI passes through (see
``parler_tts_tpu_torch/training/args.py`` or ``helpers/training_configs/*.json``).
Preparing an HF dataset needs the ``datasets`` package; a machine without it
trains from a ``save_to_disk`` cache prepared elsewhere, or on synthetic://N.
"""

import sys

from parler_tts_tpu_torch.training.run_training import main as train

DEFAULT_ARGS = [
    "--model_name_or_path", "dummy",
    "--train_dataset_name", "synthetic://96",
    "--output_dir", "./output/finetune-smoke",
    "--max_steps", "20",
    "--logging_steps", "5",
    "--save_steps", "10",
    "--do_eval", "--eval_steps", "10",
]


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    return train(argv or DEFAULT_ARGS, device=device)


if __name__ == "__main__":
    print(main())
