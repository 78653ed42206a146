"""Where the time goes on the port's main path, on one GPU.

Runs ``reconstruct(images=...)`` of the smoke scene (``chip_smoke.SMOKE_SCENE``,
640x480, default ``PipelineConfig``), or with ``--path config4`` SIFT and
``slam`` on the config-4 scene as ``chip_smoke.config4_slam`` runs them, or
with ``--path config4-device`` SIFT and the device engine ``slam_device``
on the whole 120-frame out-and-back orbit (``MapConfig.max_frames`` 128),
as ``chip_smoke.config4_device_slam`` runs it, or with ``--path vo`` /
``vo-scan`` the host / scan KLT visual odometry engine on the VO phase's 50
frames (``chip_smoke.render_vo_scene``, default ``VOConfig``), as
``chip_smoke.vo_paths`` runs it,
three times on ``cuda``: once to warm up
(kernel builds, cuBLAS/cuSOLVER handles, the caching allocator), once timed,
and once under ``torch.profiler`` tracing the CUDA activity (kernels and
copies; every figure below reads only those, and tracing the host's
operators too made a 120-frame device-engine run take over 20 minutes). Prints one
JSON line and writes the same to ``chiprun_out/profile_<path>.json``:

- wall seconds and host seconds per pipeline stage
  (``Reconstruction.stage_seconds``) of the timed run, and of the profiled
  run;
- device busy seconds in the profiled run (the union of all kernel and
  memcpy intervals) and the idle share of the timed and the profiled wall;
  device operations (kernels and copies) in all and a frame;
- device time, launch count and mean microseconds per launch of the top
  kernels by device time, of each of the port's own CUDA kernels (each
  template instantiation apart), and summed per TPU kernel (K1-K5);
- K2's launches and device time per (queries, bank rows) shape: the
  profiled run records each ``match_pair_fused`` call's shape in order and
  pairs the i-th with the i-th K2 tile kernel on the device's timeline.

    python tools/profile_main_path.py [--path config3|config4|config4-device|vo|vo-scan]
        [--frames N]
        [--top K]
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

# The port's kernels by their CUDA function names (csrc/); K3's earlier
# one-segment kernel (gather_patches_kernel) too, for older checkouts.
# match_tiles is K1's and K2's shared engine; configs 3 and 4 run only K2's.
PORT_KERNELS = {"batch_match_finalize": "K1", "match_tiles": "K2",
                "topk_finalize": "K2", "gather_patch_sets_kernel": "K3",
                "gather_patches_kernel": "K3",
                "segsum_short": "K4", "segsum_long": "K4",
                "gather_rows_narrow": "K5", "gather_rows_wide": "K5"}


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (kernel_instance_name, kernel_short_name, nvidia_smi_line,
                            render_config4_scene, render_smoke_scene, render_vo_scene)
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.kernels import _build
    from fastmatch_tpu_torch.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import detect_features, reconstruct
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig, slam
    from fastmatch_tpu_torch.pipeline.slam_device import slam_device
    from fastmatch_tpu_torch.pipeline.vo import VOConfig, visual_odometry
    from fastmatch_tpu_torch.pipeline.vo_scan import visual_odometry_scan
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("config3", "config4", "config4-device", "vo", "vo-scan"),
                    default="config3")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main_path: CUDA is not available", file=sys.stderr)
        return 2

    _build.build_all()
    if args.path == "config3":
        scene, views = render_smoke_scene(args.frames)
    elif args.path.startswith("vo"):
        scene, views, _ = render_vo_scene(args.frames)
    else:
        frames = args.frames or (120 if args.path == "config4-device" else None)
        scene, views = render_config4_scene(frames)
    cam = Pinhole.from_K(scene.K)

    def run():
        """(the path's Reconstruction (SLAM's detection in its "sift"
        stage), the input frame of each of its frames)."""
        if args.path == "config3":
            rec = reconstruct(None, cam, PipelineConfig(), images=views, device="cuda")
            return rec, np.arange(rec.n_frames)
        if args.path.startswith("vo"):
            engine = visual_odometry_scan if args.path == "vo-scan" else visual_odometry
            rec = engine(views, cam, PipelineConfig(), VOConfig(), device="cuda")
            return rec, np.arange(rec.n_frames)
        cfg = PipelineConfig(map=MapConfig(
            max_frames=max(64, 1 << (len(views) - 1).bit_length())))
        secs = {"sift": 0.0}
        feats = detect_features(views, cfg, "cuda", secs)
        engine = slam_device if args.path == "config4-device" else slam
        out = engine(feats, cam, cfg, SlamConfig(), device="cuda")
        out.rec.stage_seconds["sift"] = secs["sift"]
        return out.rec, np.asarray(out.frame_seq or range(out.rec.n_frames))

    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _ = run()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    from fastmatch_tpu_torch.kernels import distance_topk as k2

    k2_matcher, k2_shapes = k2.match_pair_fused, []

    def record_k2(desc_a, desc_b, *args, **kw):
        k2_shapes.append((desc_a.data.shape[0], desc_b.data.shape[0]))
        return k2_matcher(desc_a, desc_b, *args, **kw)

    k2.match_pair_fused = record_k2  # matching.match_pair imports it per call
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rec, seq = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        k2.match_pair_fused = k2_matcher

    by_name, intervals, k2_tiles = {}, [], []
    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        intervals.append((s, e))
        if kernel_short_name(ev.name) == "match_tiles":
            k2_tiles.append((s, e))
        d = by_name.setdefault(ev.name, [0.0, 0])
        d[0] += e - s
        d[1] += 1
    busy_s = _union_us(intervals) * 1e-6

    def row(name, us, n):
        return dict(name=name[:120], device_ms=us * 1e-3, launches=n, mean_us=us / n)

    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    port = {}
    for name, (us, count) in by_name.items():
        # One entry per instantiation: segsum_short<3> and segsum_short<9> apart.
        if kernel_short_name(name) in PORT_KERNELS:
            short = kernel_instance_name(name)
            port[short] = dict(row(name, us, count),
                               kernel=PORT_KERNELS[kernel_short_name(name)])
    per_kernel = {}
    for v in port.values():
        d = per_kernel.setdefault(v["kernel"], dict(device_ms=0.0, launches=0))
        d["device_ms"] += v["device_ms"]
        d["launches"] += v["launches"]
    for d in per_kernel.values():
        d["mean_us"] = d["device_ms"] * 1e3 / d["launches"]
    k2_by_shape = {}
    if len(k2_tiles) == len(k2_shapes):
        for (n_q, n_b), (s, e) in zip(k2_shapes, sorted(k2_tiles)):
            d = k2_by_shape.setdefault(f"{n_q}x{n_b}", dict(launches=0, device_ms=0.0))
            d["launches"] += 1
            d["device_ms"] += (e - s) * 1e-3
        for d in k2_by_shape.values():
            d["mean_us"] = d["device_ms"] * 1e3 / d["launches"]
    n = rec.n_frames
    gt = -np.einsum("fji,fj->fi", scene.R[seq], scene.t[seq])
    out = dict(
        path=args.path, device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line(),
        frames=n, wall_s=wall_plain, frames_per_s=n / wall_plain,
        stage_seconds=plain.stage_seconds, profiled_wall_s=wall,
        profiled_stage_seconds=rec.stage_seconds, device_busy_s=busy_s,
        device_idle_share=1.0 - busy_s / wall_plain,
        device_idle_share_profiled=1.0 - busy_s / wall,
        kernel_launches=sum(v[1] for v in by_name.values()),
        device_operations_per_frame=sum(v[1] for v in by_name.values()) / n,
        ate=float(ate_rmse(rec.camera_centers(), gt)),
        top_kernels=[row(k, *v) for k, v in top], port_kernels=port,
        port_kernels_total=per_kernel, k2_tiles_by_shape=k2_by_shape,
        k2_calls_seen=len(k2_shapes), k2_tile_launches_seen=len(k2_tiles))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"profile_{args.path}.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
