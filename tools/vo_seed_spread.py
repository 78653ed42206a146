"""The port's VO engines over RANSAC seeds, on one GPU.

Runs ``visual_odometry``, ``visual_odometry_scan`` and
``stereo_visual_odometry`` on ``chip_smoke.render_vo_scene``'s 50 frames
(default configs, as ``chip_smoke.vo_paths`` runs them) for each seed of
``--seed``, and prints one JSON line a run: frames posed, flagged
fallbacks, keyframes, points, the boot frame, the sim(3) ATE of all frames
and of the frames from the boot frame on (the retroactively posed frames
before it rest on the few tracks that survive to it), the Umeyama scale and
the rigid ATE (stereo), and seconds. Compare with the JAX package's spread
from ``tools/jax_vo_reference.py --seed``.

    python tools/vo_seed_spread.py [--seed 0,1,2,3,4,5,6,7] [--engine host,scan,stereo]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    from chip_smoke import VO_BASELINE, nvidia_smi_line, render_vo_scene
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.kernels import _build
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.pipeline.stereo_vo import StereoVOConfig, stereo_visual_odometry
    from fastmatch_tpu_torch.pipeline.vo import VOConfig, visual_odometry
    from fastmatch_tpu_torch.pipeline.vo_scan import visual_odometry_scan
    from vo_fixtures import ate, centers, summary

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--engine", default="host,scan,stereo")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vo_seed_spread: CUDA is not available", file=sys.stderr)
        return 2
    _build.build_all()
    scene, left, right = render_vo_scene()
    cam = Pinhole.from_K(scene.K)
    cfg = PipelineConfig()
    gt = centers(scene.R, scene.t)
    engines = {
        "host": lambda s: visual_odometry(left, cam, cfg, VOConfig(), seed=s, device="cuda"),
        "scan": lambda s: visual_odometry_scan(left, cam, cfg, VOConfig(), seed=s,
                                               device="cuda"),
        "stereo": lambda s: stereo_visual_odometry(left, right, cam, VO_BASELINE, cfg,
                                                   StereoVOConfig(), seed=s, device="cuda"),
    }
    smi = nvidia_smi_line()
    for name in args.engine.split(","):
        for seed in (int(x) for x in args.seed.split(",")):
            t0 = time.perf_counter()
            rec = engines[name](seed)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            st = summary(rec, gt)
            fb = st["boot"][0] if st["boot"] else 0
            est = centers(rec.R[:rec.n_frames], rec.t[:rec.n_frames])
            print(json.dumps(dict(engine=name, seed=seed, seconds=secs, **st,
                                  ate_from_boot=ate(est[fb:], gt[fb:]) if fb else None,
                                  nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
