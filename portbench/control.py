"""Run a cell with the control or a planted fault in place, on the card.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...] --seconds <s>
        [--faults control unchanged_state half_batch altered_answer]

Each seed and fault is one run of the cell as ``portbench.run`` makes it
(its set-up, a window of ``--seconds``, the same judge), all in this one
process; it prints one JSON line a run: the seed, the fault, ``correct``
and the numbers compared. The benchmark's own runs never plant one: this is
how the control and the faults were read at the cells' own sizes
(portbench/faults.py says what each breaks).
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run
from portbench.faults import FAULTS
from portbench.reference import bzip2_ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", nargs="+", default=list(FAULTS), choices=FAULTS)
    args = ap.parse_args(argv)
    bench = run.load_bench()
    run.use_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    with bzip2_ref.BlockPool() as pool:
        for seed in args.seeds:
            for fault in args.faults:
                r = run.run_cell(bench, args.workload, seed, args.seconds, False, pool=pool, fault=fault)
                print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault, "correct": r["correct"],
                                  "attempted": r["attempted"], "failed": r["failed"], "checks": r["checks"]}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
