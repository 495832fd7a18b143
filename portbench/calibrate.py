"""Readings for the limits of ``correct``: the program's and the control's
numbers on many seeds of one cell, in one process.

    python3 -m portbench.calibrate --workload <cell> --seconds <s> --seeds <n> ... \
        --control_seeds <n> ... --program_control_seeds <n> ...

Each seed is a whole run of the cell (``run.run_cell``): weights, set-up, a
window of ``--seconds``, the check, with every number the check can compare
in ``readings``. A control seed's run also reads the control: the reference
one step below every precision the configuration states, at the same
prompts and served tokens. A program-control seed runs the program with its
own lower-precision paths (a 4-bit cache, int8 prefill activations), held
to the same reference. One JSON line per run on standard output; ``--out``
also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[],
                    help="Seeds whose runs also read the control (the reference one step "
                         "below every stated precision) and the last call's cached positions.")
    ap.add_argument("--program_control_seeds", type=int, nargs="*", default=[],
                    help="Seeds run with the program's own lower-precision paths (a 4-bit "
                         "cache, int8 prefill activations).")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    rows = []
    runs = [(seed, False, False) for seed in args.seeds]
    runs += [(seed, True, False) for seed in args.control_seeds]
    runs += [(seed, False, True) for seed in args.program_control_seeds]
    for seed, ctrl, prog_ctrl in runs:
        try:
            r = run.run_cell(cell, seed, args.seconds, bool(args.trace), "cuda", control=ctrl,
                             program_control=prog_ctrl)
        except Exception as exc:  # a control that crashes has failed; say so and go on
            r = {"error": repr(exc), "log_lines": [f"seed {seed}: {exc!r}"]}
            run.free_program_memory()
        for line in r.pop("log_lines"):
            run.log(line)
        row = {"seed": seed, "control": ctrl, "program_control": prog_ctrl, **r}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
