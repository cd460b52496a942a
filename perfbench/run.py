"""Run one cell of the benchmark once.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  With ``--trace 0`` the result line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
profiled slice's device busy time.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared with its limit); the checks are also the last lines of
standard error.  ``--dry`` prints the cell's plan and runs nothing.

It exits non-zero with no result line when there is no CUDA card or fewer
than the cell asks for, when the program is missing, and when JAX, Flax or
the JAX package is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "parler_tts_tpu")
PROGRAM = "parler_tts_tpu_torch"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``parler_tts_tpu_torch`` is none of them)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def no_jax() -> None:
    """Keeps libraries the program uses from loading JAX or Flax themselves.
    (The program builds its kernels with nvcc into its own ``_build/``
    inside the checkout; it has no other build or kernel cache.)"""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    plan = harness.plan(ROOT, args.workload)
    if args.dry:
        print(json.dumps(plan.summary()))
        return 0
    if not (ROOT / PROGRAM / "__init__.py").exists():
        print(f"perfbench: the program under test ({PROGRAM}) is not in this checkout", file=sys.stderr)
        return 2
    no_jax()
    import torch

    chips = plan.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA card(s), this machine has {count}", file=sys.stderr)
        return 2
    driver = harness.load_module(plan.driver)
    result = driver.run(plan, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                        device=torch.device("cuda"), process_start=PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the program under test must not", file=sys.stderr)
        return 3
    return emit(plan, result, trace=bool(args.trace))


def emit(plan, result: dict, *, trace: bool) -> int:
    """Print the checks on standard error and the result line last on
    standard output."""
    from perfbench import harness

    if trace:
        metrics = harness.read_per_layer(plan, result["facts"])
    else:
        metrics = {m["name"]: {"value": result["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in plan.end_to_end}
    line = {"correct": result["correct"], "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": result["device"]}
    if trace and result.get("breakdown"):
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
