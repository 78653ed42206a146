"""The config-4 pose-graph solves' wall time for one checkout of the port,
on one GPU.

Imports ``fastmatch_tpu_torch`` from ``--root`` (default: this checkout), so
two commits are compared on one card by running this script once per
checkout, in turns, inside one call (parent, change, change, parent). Solves
the 500-keyframe graph of ``chip_smoke.config4_pose_graph`` as
``chip_smoke.config4_pgo`` does (``pgo_solve`` dense and PCG, 30 LM
iterations; ``pgo_solve_hierarchical``; ``sim3_pgo_solve``, 10 iterations;
Geman-McClure weights, delta 0.5), after one warm-up dense solve, each
``--reps`` times: ms per solve by the wall clock with the card synchronized
(the median and every rep), the final cost and the iterations. Prints one
JSON line and appends it to ``chiprun_out/pgo_ab.jsonl``.

    python tools/pgo_ab.py [--root DIR] [--label NAME] [--reps N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose src/ to import")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))

    import torch

    if not torch.cuda.is_available():
        print("pgo_ab: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import config4_pose_graph, nvidia_smi_line
    from fastmatch_tpu_torch.core.lie import Sim3
    from fastmatch_tpu_torch.interop import pose_graph_from_numpy
    from fastmatch_tpu_torch.posegraph import pgo_solve, pgo_solve_hierarchical
    from fastmatch_tpu_torch.posegraph.sim3 import Sim3Graph, sim3_pgo_solve

    a = config4_pose_graph()
    g = pose_graph_from_numpy(dict(poses=(a["R"], a["t"]), edge_i=a["edge_i"],
                                   edge_j=a["edge_j"], Z=(a["ZR"], a["Zt"]),
                                   edge_weight=a["edge_weight"], pose_mask=a["pose_mask"],
                                   fixed=a["fixed"]), device="cuda")
    ones = lambda n: torch.ones(n, device=g.poses.t.device)  # noqa: E731
    sg = Sim3Graph(Sim3(g.poses.R, g.poses.t, ones(g.poses.t.shape[0])), g.edge_i, g.edge_j,
                   Sim3(g.Z.R, g.Z.t, ones(g.edge_i.shape[0])), g.edge_weight, g.pose_mask,
                   g.fixed)
    kw = dict(kernel="geman", huber_delta_static=0.5, device="cuda")
    solves = {"dense": lambda: pgo_solve(g, max_iters=30, **kw),
              "pcg": lambda: pgo_solve(g, max_iters=30, solver="pcg", **kw),
              "hierarchical": lambda: pgo_solve_hierarchical(g, **kw),
              "sim3": lambda: sim3_pgo_solve(sg, max_iters=10, **kw)}
    out = dict(label=args.label, root=os.path.abspath(args.root),
               device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line())
    solves["dense"]()  # warm-up (cuSOLVER's first call, K4's build where used)
    torch.cuda.synchronize()
    for name, fn in solves.items():
        ms = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(ms_per_solve=statistics.median(ms), ms_all=ms,
                         cost=float(res.cost), iters=res.iters)
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "pgo_ab.jsonl"), "a") as fh:
        fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
