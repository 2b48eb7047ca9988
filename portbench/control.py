"""Readings for the limits of ``correct``, on the card at a cell's own size.

    python portbench/control.py --workload <cell> --seeds 1 2 3 --control-seeds 4 5 6

Runs the cell once a seed in this one process, a window of one call each
(``--seconds``, 0 by default), and prints each run's compared numbers as a
JSON line: first the program as the configuration states it (the lower
readings), then the control, the program with its df32 refinement
switched off (``refinement_restarts=0``: float32 alone, the precision
below the configuration's), whose numbers have to fail the limits.
The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONTROL = {"refinement_restarts": 0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=0.0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    runs = [(s, None) for s in args.seeds] + [(s, CONTROL) for s in args.control_seeds]
    for seed, overrides in runs:
        line = harness.run_cell(args.workload, seed, args.seconds, False, time.perf_counter(),
                                solver_overrides=overrides)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": overrides is not None, "correct": line["correct"],
                          "calls": line["window"]["calls"], "check_s": line["window"]["check_s"],
                          "metrics": line["metrics"],
                          "check": line["check"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
