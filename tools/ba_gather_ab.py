"""BA's host seconds with the K4 and K5 kernels against library calls, on one GPU.

Runs ``reconstruct(images=...)`` of the smoke scene (``chip_smoke.SMOKE_SCENE``,
640x480, default ``PipelineConfig``) once to warm up, then in pairs, the
order alternating from pair to pair (kernels first, then library first):

- ``kernels``: BA as shipped, its segment sums through K4
  (``kernels/segment_ops.sorted_segment_sum``, with the solve's offsets)
  and its point-keyed gathers through K5 (``sorted_gather_rows``);
- ``library``: the same sums through ``segment_sum_plain`` (one
  ``index_add_``) and the same gathers through one ``torch.index_select``
  into the same buffer.

Both gathers are exact and both sums are fp32, so the two variants do the
same BA work to within summation order; each run's ATE is printed to show
it. Prints one JSON line and writes it to ``chiprun_out/ba_gather_ab.json``:
per variant, each run's BA stage host seconds
(``Reconstruction.stage_seconds``), wall seconds and K4/K5 launches; the
medians, the interquartile range of each variant's BA seconds (the
spread), and in how many pairs the kernels' BA seconds were lower.

    python tools/ba_gather_ab.py [--pairs N] [--frames N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)


def _iqr(xs):
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def main(argv=None) -> int:
    import numpy as np
    import torch

    from chip_smoke import SMOKE_SCENE, nvidia_smi_line, render_smoke_scene
    from fastmatch_tpu_torch.ba import schur
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.kernels import _build, segment_ops
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import reconstruct
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=6, help="(kernels, library) pairs")
    ap.add_argument("--frames", type=int, default=SMOKE_SCENE["n_frames"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ba_gather_ab: CUDA is not available", file=sys.stderr)
        return 2

    _build.build_all()
    scene, views = render_smoke_scene(args.frames)
    cam = Pinhole.from_K(scene.K)
    ops = {
        "kernels": (segment_ops.sorted_segment_sum, segment_ops.sorted_gather_rows),
        "library": (lambda vals, seg, n, offsets, max_len:
                    segment_ops.segment_sum_plain(vals, seg, n),
                    lambda table, seg, out=None: torch.index_select(table, 0, seg, out=out)),
    }
    runs = {k: [] for k in ops}

    def run(variant):
        schur.sorted_segment_sum, schur.sorted_gather_rows = ops[variant]
        segment_ops.sorted_segment_sum.launches = 0
        segment_ops.sorted_gather_rows.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = reconstruct(None, cam, PipelineConfig(), images=views, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = rec.n_frames
        gt = -np.einsum("fji,fj->fi", scene.R[:n], scene.t[:n])
        return dict(wall_s=wall, ba_s=rec.stage_seconds["ba"], frames=n,
                    ate=float(ate_rmse(rec.camera_centers(), gt)),
                    k4_launches=segment_ops.sorted_segment_sum.launches,
                    k5_launches=segment_ops.sorted_gather_rows.launches)

    try:
        run("kernels")  # warm-up
        for i in range(args.pairs):
            order = ("kernels", "library") if i % 2 == 0 else ("library", "kernels")
            for variant in order:
                runs[variant].append(run(variant))
    finally:
        schur.sorted_segment_sum, schur.sorted_gather_rows = ops["kernels"]

    ba = {k: [r["ba_s"] for r in v] for k, v in runs.items()}
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line(),
               order="pairs alternate: kernels first, then library first", runs=runs,
               median_ba_s={k: statistics.median(v) for k, v in ba.items()},
               iqr_ba_s={k: _iqr(v) for k, v in ba.items()},
               median_wall_s={k: statistics.median(r["wall_s"] for r in v)
                              for k, v in runs.items()},
               kernels_lower_ba_pairs=sum(a < b for a, b in zip(ba["kernels"], ba["library"])),
               pairs=args.pairs)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ba_gather_ab.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
