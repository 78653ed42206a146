"""BA's host seconds with the K5 row gather against plain indexing, on one GPU.

Runs ``reconstruct(images=...)`` of the smoke scene (``chip_smoke.SMOKE_SCENE``,
640x480, default ``PipelineConfig``) once to warm up, then in turns with BA's
point-keyed gathers through K5 (``kernels/segment_ops.sorted_gather_rows``,
as shipped) and through one ``torch.index_select`` call each (the plain
indexing they replaced): K5, plain, plain, K5, ... Both gathers are exact,
so every run does the same BA work; each run's ATE is printed to show it.
Prints one JSON line and writes it to ``chiprun_out/ba_gather_ab.json``:
per variant, the BA stage's host seconds (``Reconstruction.stage_seconds``)
and the wall seconds of each run, and K5's launch count per run.

    python tools/ba_gather_ab.py [--rounds N] [--frames N]
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
    ap.add_argument("--rounds", type=int, default=2, help="K5/plain/plain/K5 rounds")
    ap.add_argument("--frames", type=int, default=SMOKE_SCENE["n_frames"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ba_gather_ab: CUDA is not available", file=sys.stderr)
        return 2

    _build.build_all()
    scene, views = render_smoke_scene(args.frames)
    cam = Pinhole.from_K(scene.K)
    gathers = {"k5": segment_ops.sorted_gather_rows,
               "plain": lambda table, seg: torch.index_select(table, 0, seg)}
    runs = {k: [] for k in gathers}

    def run(variant):
        schur.sorted_gather_rows = gathers[variant]
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
                    k5_launches=segment_ops.sorted_gather_rows.launches)

    try:
        run("k5")  # warm-up
        for _ in range(args.rounds):
            for variant in ("k5", "plain", "plain", "k5"):
                runs[variant].append(run(variant))
    finally:
        schur.sorted_gather_rows = gathers["k5"]

    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line(),
               order="k5, plain, plain, k5 per round", runs=runs,
               median_ba_s={k: statistics.median(r["ba_s"] for r in v)
                            for k, v in runs.items()},
               median_wall_s={k: statistics.median(r["wall_s"] for r in v)
                              for k, v in runs.items()})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ba_gather_ab.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
