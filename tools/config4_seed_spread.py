"""The port's SLAM engines over several seeds on config 4's out-and-back orbit.

The seed keys every RANSAC draw of a run (bootstrap, tracking,
relocalization, loop verification), so the spread of a figure over seeds is
what a single run's figure can be compared within. Renders
``chip_smoke.render_config4_scene`` (56 frames unless ``--frames``), detects
SIFT features once (default ``SIFTConfig``), then runs each engine of
``--engine`` (a comma list of ``device``, ``slam_device``; ``scan``,
``slam_scan(close_loops=True)``; ``chunked``, ``slam_chunked(chunk=16)``)
with the default ``SlamConfig`` and ``MapConfig.max_frames`` >= the frame
count, once per seed of ``--seed``. Prints one JSON line per run (frames
tracked, loop edges, PGO runs, points, observations, the ATE of the tracked
frames' centres, seconds) and a summary line with each engine's ATE range,
and writes them all to ``chiprun_out/seed_spread.json``. The JAX package's
counterpart is ``tools/jax_config4_reference.py --seed``.

    python tools/config4_seed_spread.py [--engine device,scan,chunked] [--seed 0,1,2]
        [--frames N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

ENGINES = ("device", "scan", "chunked")


def main(argv=None) -> int:
    import numpy as np
    import torch

    from chip_smoke import nvidia_smi_line, render_config4_scene
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import detect_features
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig
    from fastmatch_tpu_torch.pipeline.slam_device import slam_device
    from fastmatch_tpu_torch.pipeline.slam_scan import slam_chunked, slam_scan
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="device,scan,chunked",
                    help="comma list of " + ", ".join(ENGINES))
    ap.add_argument("--seed", default="0,1,2", help="comma list of seeds")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    engines = args.engine.split(",")
    if any(e not in ENGINES for e in engines):
        ap.error(f"--engine: each of {engines} must be one of {ENGINES}")
    seeds = [int(s) for s in args.seed.split(",")]
    dev = args.device or "cuda"
    if dev == "cuda" and not torch.cuda.is_available():
        print("config4_seed_spread: CUDA is not available", file=sys.stderr)
        return 2
    if dev == "cuda":
        from fastmatch_tpu_torch.kernels import _build

        _build.build_all()
        print(nvidia_smi_line(), flush=True)

    scene, views = render_config4_scene(args.frames)
    cfg = PipelineConfig(map=MapConfig(max_frames=max(64, 1 << (len(views) - 1).bit_length())))
    feats = detect_features(views, cfg, dev)
    cam = Pinhole.from_K(scene.K)
    runs = {"device": lambda s: slam_device(feats, cam, cfg, SlamConfig(), seed=s, device=dev),
            "scan": lambda s: slam_scan(feats, cam, cfg, SlamConfig(), seed=s, close_loops=True,
                                        device=dev),
            "chunked": lambda s: slam_chunked(feats, cam, cfg, SlamConfig(), chunk=16, seed=s,
                                              device=dev)}
    lines, spread = [], {}
    for engine in engines:
        for seed in seeds:
            t0 = time.perf_counter()
            out = runs[engine](seed)
            secs = time.perf_counter() - t0
            rec, seq = out.rec, np.asarray(out.frame_seq)
            gt = -np.einsum("fji,fj->fi", scene.R[seq], scene.t[seq])
            line = dict(engine=engine, seed=seed, frames=len(views), frames_tracked=rec.n_frames,
                        ate=float(ate_rmse(rec.camera_centers(), gt)),
                        loop_edges=[[int(e[0]), int(e[1])] for e in out.loop_edges],
                        pgo_runs=out.pgo_runs, n_points=int(rec.pt_mask.sum()),
                        n_obs=rec.n_obs, seconds=secs, device=dev)
            print(json.dumps(line), flush=True)
            lines.append(line)
            spread.setdefault(engine, []).append(line["ate"])
    summary = {e: dict(ate_min=min(a), ate_max=max(a), seeds=seeds) for e, a in spread.items()}
    print(json.dumps({"seed_spread": summary}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "seed_spread.json"), "w") as f:
        json.dump(dict(runs=lines, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
