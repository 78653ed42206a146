"""Readings of the port and of its lower-precision control, seed by seed.

    python3 portbench/controls.py --workload <cell> --seeds 1 2 3 ... [--no-control]

For each seed it makes the cell's inputs, runs the port through the
window's own call (every pool batch once; one solve), and prints one JSON
line with the numbers that decide ``correct`` for the port and for the
control: the plain reference put in the port's place and computed in the
nearest precision below the one the configuration states (TF32 operands
for float32 with TF32 off, float8 e4m3 operands for bfloat16). The limits
in ``portbench/workloads/<cell>.json`` are set between the two: above the
largest the port reads, below the least the control reads. The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The control of each precision a configuration states.
CONTROL = {"exact": "tf32", "fast": "fp8"}


def readings(root, workload, seeds, control=True, need_device=True, out=sys.stdout):
    import torch

    from portbench import harness
    from portbench.trace import Tracer

    cell = harness.prepare(root, workload, need_device)
    spec, device = cell.spec, cell.device
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = cell.driver.Driver(spec.config, spec.traffic, seed, device, cell.fm)
        tracer = Tracer(False)
        row = dict(seed=seed)
        if spec.traffic["driver"] == "pairs":
            row["program"] = dict(zip(("decisions_off", "dist_gap"),
                                      drv.readings(drv.program_sample(tracer))))
            if control:
                how = CONTROL[spec.traffic["precision"]]
                row["control"] = dict(zip(("decisions_off", "dist_gap"),
                                          drv.readings(drv.control_sample(how))), operands=how)
        else:
            row["program"] = drv.readings(*drv.program_results(tracer))
            row["lm_iters"] = drv.last_iters
            if control:
                row["control"] = dict(drv.readings(*drv.control_results("tf32")),
                                      operands="tf32")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
        del drv
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    readings(ROOT, args.workload, args.seeds, control=not args.no_control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
