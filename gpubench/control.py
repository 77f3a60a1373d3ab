"""The control of a cell's comparison: a whole run of the harness
(``harness.execute``) with the plain reference put in the program's place,
a guarantee of the configuration broken (each of the mode's ``CONTROLS``,
else ``match_cap``: each pair's matches cut at its first 128, the
program's first tier without its rescue; the configuration counts every
common k-mer), on a cell's own pool sets and judged by the run's own
comparison.  Each has to come out not correct.

    python3 -m gpubench.control --workload <cell> --seeds <n> [<n> ...]
        [--control <name>]

Prints the numbers compared of each seed's run and its result line (the
metrics of a run with no program in it mean nothing).  Needs no card: the
control and the reference run on the host, a process a pool set.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Tuple

from . import harness


class ControlProgram:
    """The reference with ``control`` in the program's place: each pool
    set's output computed once, a process a set, and written where the
    program would write it whenever a job on that set runs."""

    cuda = False

    def __init__(self, mode, config: dict, control: str, inputs: List[dict],
                 jobs: List[Tuple[List[str], str]]):
        outs = harness.reference_outputs(mode, inputs, config, control)
        self.by_argv = {tuple(argv): (out_dir, files)
                        for (argv, out_dir), files in zip(jobs, outs)}

    def job(self, argv: List[str]) -> dict:
        t0 = time.perf_counter()
        out_dir, files = self.by_argv[tuple(argv)]
        for name, data in files.items():
            with open(os.path.join(out_dir, name), "wb") as fh:
                fh.write(data)
        return dict(wall_s=time.perf_counter() - t0, cpu_s=0.0, stages={},
                    launches={})


def run_control(cell: dict, config: dict, traffic: dict, seed: int,
                control: str) -> dict:
    """The result line of a run of ``cell`` with the control in the
    program's place."""
    mode = harness.load_mode(traffic)

    def program(inputs, jobs):
        return ControlProgram(mode, config, control, inputs, jobs)

    return harness.execute(cell["name"], cell["chips"], config, traffic, [],
                           seed, 0.0, 0, time.perf_counter(), device="cpu",
                           program=program)


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", help="a guarantee the mode's reference can "
                    "break (default: each of the mode's controls)")
    args = ap.parse_args(argv)
    cell, config, traffic, _e = harness.load_cell(harness.ROOT, args.workload,
                                                  0)
    controls = getattr(harness.load_mode(traffic), "CONTROLS", ("match_cap",))
    if args.control:
        controls = (args.control,)
    rows: Dict[str, Dict[int, dict]] = {}
    for control in controls:
        for seed in args.seeds:
            out = run_control(cell, config, traffic, seed, control)
            rows.setdefault(control, {})[seed] = out
            print(f"{args.workload} {control} seed {seed}: correct "
                  f"{out['correct']}, " + ", ".join(
                      f"{k} {c['value']} (limit {c['limit']})"
                      for k, c in out["checks"].items()), flush=True)
    print(json.dumps({"workload": args.workload, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
