"""``control.py`` for a cell of the Nemotron-H decoder: the fp8-e4m3-weight
control computed by ``reference/nemotron_h.py`` in place of the MusicGen
decoder's reference (run on the card, never by the benchmark's runs).

    python perfbench/control_nemotron_h.py --workload nemotronh-offline-b128-10s --seeds 1 2 3 [--seconds S]

The program's readings come from the cell's own driver (``drivers/
offline_nemotron_h.py``), as a run of the cell judges, and the control reads
the cell driver's weights (T5's queries at T5's published init, the Mamba layers
at Mamba-2's).  The control reads the rows in ``traffic.ids``'s layout; the
reference and the control read the same one, so their comparison is of
precision alone.  The fp8 rounding leaves the SSM state and the convolution
in the reference's own arithmetic: only the weights are rounded.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import control, harness  # noqa: E402
from perfbench.reference import decoder, nemotron_h  # noqa: E402


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    plan = harness.plan(ROOT, args[args.index("--workload") + 1])
    off, rows = harness.load_module(plan.driver), control.control_rows
    decoder.logits = nemotron_h.logits

    def published(raw, cfg, picked, sampling, seed):  # the cell driver's weights
        off.lfm2.t5_queries(raw, cfg["text_encoder"])
        return rows(off.mamba_init(raw, plan.config, seed), cfg, picked, sampling, seed)

    control.control_rows = published
    return control.main(args)


if __name__ == "__main__":
    sys.exit(main())
