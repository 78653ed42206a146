"""Command-line interface of the PyTorch/CUDA port.

    python -m fastmatch_tpu_torch.cli [--device cpu] [--config F] [--set k=v] CMD ...

Port of ``fastmatch_tpu/cli.py`` for the subcommands whose engines are
ported, with the JAX package's argument names and JSON output:

  info        torch version, device name, power limit
  match       two descriptor files (.npy) or two images (SIFT or ORB),
              optional geometric verification
  reconstruct incremental SfM over an image directory or .npz features
  evaluate    match precision/recall ('synth' pairs or an Oxford-VGG
              directory) or trajectory ATE/RPE ('traj --est --gt')
  slam        SLAM with loop closure (--engine auto|device|host|scan|chunked)

Everything runs on the card unless ``--device cpu`` is given. An option or
subcommand whose module is not ported yet raises ``NotImplementedError``
naming its ROADMAP item; none is dropped silently. Config: a JSON or YAML
``--config`` file and dotted ``--set`` overrides, e.g.
``--set ba.interval=3 --set matching.ratio=0.75``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

# Subcommands of the JAX package's CLI whose engines are not ported yet,
# with their ROADMAP Queue 1 item.
_UNPORTED_COMMANDS = {"flow": 5, "vo": 5, "stereo": 6, "densify": 6, "vialign": 7,
                      "locate": 8, "merge": 8, "serve": 8}


def not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported (ROADMAP Queue 1 item {item})")


def _load_config(args):
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig

    data = {}
    if args.config:
        with open(args.config) as fh:
            text = fh.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            import yaml  # type: ignore

            data = yaml.safe_load(text)
    for kv in args.set or []:
        k, v = kv.split("=", 1)
        d = data
        parts = k.split(".")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        try:
            d[parts[-1]] = json.loads(v)
        except json.JSONDecodeError:
            d[parts[-1]] = v

    def apply(obj, overrides):
        # Config nodes are frozen dataclasses or NamedTuples (SIFTConfig).
        if not overrides:
            return obj
        is_nt = hasattr(obj, "_fields")
        names = obj._fields if is_nt else [f.name for f in dataclasses.fields(obj)]
        unknown = set(overrides) - set(names)
        if unknown:
            raise KeyError(f"unknown config keys {sorted(unknown)} on {type(obj).__name__}")
        kw = {name: apply(getattr(obj, name), ov) if isinstance(ov, dict) else ov
              for name, ov in overrides.items()}
        return obj._replace(**kw) if is_nt else dataclasses.replace(obj, **kw)

    return apply(PipelineConfig(), data)


def _device(args):
    from fastmatch_tpu_torch.core.device import resolve_device

    return resolve_device(args.device)


def cmd_info(args):
    import subprocess

    import torch

    print(f"torch {torch.__version__} cuda={torch.version.cuda} "
          f"available={torch.cuda.is_available()}")
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"devices: {names}")
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        print(f"nvidia-smi: {out.stdout.strip()}")


def cmd_match(args):
    import torch

    from fastmatch_tpu_torch.core.containers import descriptors_from_numpy

    if args.method == "mirror":
        raise not_ported("match --method mirror (matching/mirror.py)", 8)
    cfg = _load_config(args)
    dev = _device(args)

    def load_side(path):
        if path.endswith(".npy"):
            if args.feature == "orb":
                raise ValueError("--feature orb needs image inputs "
                                 "(descriptor .npy dumps are SIFT float)")
            return None, descriptors_from_numpy(np.load(path).astype(np.float32), device=dev)
        from fastmatch_tpu_torch.utils.imageio import load_gray

        img = torch.from_numpy(load_gray(path))
        if args.feature == "orb":
            from fastmatch_tpu_torch.features.orb import detect_and_describe_orb

            return detect_and_describe_orb(img, device=dev)
        from fastmatch_tpu_torch.features.sift import detect_and_describe

        return detect_and_describe(img, cfg.sift, device=dev)

    kp_a, da = load_side(args.a)
    kp_b, db = load_side(args.b)
    if args.feature == "orb":
        from fastmatch_tpu_torch.matching.hamming import match_pair_hamming

        m = match_pair_hamming(da, db, ratio=cfg.matching.ratio,
                               cross_check=cfg.matching.cross_check, device=dev)
    else:
        from fastmatch_tpu_torch.matching.matcher import match_pair

        m = match_pair(da, db, ratio=cfg.matching.ratio, cross_check=cfg.matching.cross_check,
                       backend=cfg.matching.backend, precision=cfg.matching.precision,
                       device=dev)
    report = {}
    if args.verify != "none":
        if kp_a is None or kp_b is None:
            raise ValueError("--verify needs image inputs (keypoint coords)")
        from fastmatch_tpu_torch.matching.verify import verify_matches

        vr = verify_matches(kp_a, kp_b, m, model=args.verify, thr_px=args.verify_thr,
                            generator=torch.Generator(dev).manual_seed(0), device=dev)
        m = vr.matches
        report["verified"] = bool(vr.ok)
        report["model_inliers"] = int(vr.n_inliers)
    valid = m.valid.cpu().numpy() & da.mask.cpu().numpy()
    idx = m.idx.cpu().numpy()
    out = np.stack([np.where(valid)[0], idx[valid]], axis=1)
    if args.out:
        if kp_a is not None and kp_b is not None:
            xy_a, xy_b = kp_a.xy.cpu().numpy(), kp_b.xy.cpu().numpy()
            np.savez(args.out, pairs=out, xy_a=xy_a[out[:, 0]], xy_b=xy_b[out[:, 1]])
        else:
            np.save(args.out, out)
    print(json.dumps({"n_matches": int(valid.sum()), "out": args.out, **report}))


def _load_features(args, cfg, secs=None):
    """Per-frame (xy, desc, mask) numpy features from a .npz dump or an
    image directory (the native threaded loader, then SIFT on the device),
    and the camera. ``secs`` (a dict) receives the "decode" and "sift"
    seconds of an image directory."""
    import glob

    import torch

    if args.input.endswith(".npz"):
        data = np.load(args.input)
        n = int(data["n_frames"])
        feats = [(data[f"xy_{i}"], data[f"desc_{i}"], data[f"mask_{i}"]) for i in range(n)]
        w, h = data["image_size"]
        return feats, _make_camera(args, (w, h))
    from fastmatch_tpu_torch.features.sift import detect_and_describe
    from fastmatch_tpu_torch.utils.imageio import FrameLoader, load_gray

    secs = {} if secs is None else secs
    secs.update(decode=0.0, sift=0.0)
    dev = _device(args)
    paths = sorted(glob.glob(args.input + "/*"))
    if len(paths) < 2:
        raise ValueError(f"{args.input}: need at least 2 frames, found {len(paths)}")

    def detect(im):
        t0 = time.perf_counter()
        kps, descs = detect_and_describe(torch.from_numpy(im), cfg.sift, device=dev)
        out = (kps.xy.cpu().numpy(), descs.data.cpu().numpy(), descs.mask.cpu().numpy())
        secs["sift"] += time.perf_counter() - t0
        return out

    # Every frame is delivered at the first frame's shape; a frame the
    # loader skips (a decode error) is an error: dropping it would shift
    # every later pose.
    t0 = time.perf_counter()
    first = load_gray(paths[0])
    secs["decode"] += time.perf_counter() - t0
    h, w = first.shape
    feats = [detect(first)]
    expected = 1
    with FrameLoader(paths[1:], size=(w, h)) as frames:
        t0 = time.perf_counter()
        for idx, im in frames:
            secs["decode"] += time.perf_counter() - t0
            if idx + 1 != expected:
                raise IOError(f"failed to decode {paths[expected]}")
            feats.append(detect(im))
            expected += 1
            t0 = time.perf_counter()
    if expected != len(paths):
        raise IOError(f"failed to decode {paths[expected]}")
    return feats, _make_camera(args, (w, h))


def _make_camera(args, size):
    """--focal/--camera-model/--dist -> camera (principal point w/2, h/2)."""
    from fastmatch_tpu_torch.core.camera import Fisheye, Pinhole

    w, h = size
    K = np.array([[args.focal, 0, w / 2], [0, args.focal, h / 2], [0, 0, 1.0]], np.float32)
    dist = tuple(float(x) for x in args.dist.split(",")) if args.dist else ()
    return (Fisheye if args.camera_model == "fisheye" else Pinhole).from_K(K, dist)


def _add_camera_args(sp):
    sp.add_argument("--focal", type=float, default=500.0)
    sp.add_argument("--camera-model", choices=("pinhole", "fisheye"), default="pinhole",
                    help="pinhole = Brown-Conrady distortion (k1,k2,k3,p1,p2); fisheye = "
                         "equidistant theta-polynomial (k1,k2,k3,k4)")
    sp.add_argument("--dist", default="",
                    help="comma-separated distortion coefficients, e.g. '-0.28,0.07'")


def _add_gps_args(sp):
    sp.add_argument("--gps", metavar="NPZ", help="georegister to GPS camera centres")
    sp.add_argument("--gps-weight", type=float, default=10.0)
    sp.add_argument("--gps-delta", type=float, default=None)


def _add_export_args(sp):
    sp.add_argument("--export-ply", help="write the sparse point cloud as ASCII PLY")
    sp.add_argument("--export-colmap", metavar="DIR", help="write a COLMAP text model")
    sp.add_argument("--export-kitti", help="write the trajectory in KITTI format")


def _refuse_unported(args):
    """Raise on the map-level options whose modules are not ported."""
    if getattr(args, "selfcal", 0):
        raise not_ported("--selfcal (ba/calibrate.py)", 4)
    if getattr(args, "gps", None):
        raise not_ported("--gps (pipeline/georegister.py)", 4)
    if getattr(args, "checkpoint", None):
        raise not_ported("--checkpoint (pipeline/checkpoint.py)", 4)
    for opt in ("export_ply", "export_colmap", "export_kitti"):
        if getattr(args, opt, None):
            raise not_ported(f"--{opt.replace('_', '-')} (utils/export.py)", 4)


def _metrics(args):
    if not args.metrics:
        return None
    from fastmatch_tpu_torch.utils.metrics import MetricsLogger

    return MetricsLogger(path=args.metrics)


def _save_map(path, rec):
    np.savez(path, centers=rec.camera_centers(), R=rec.R[: rec.n_frames],
             t=rec.t[: rec.n_frames], points=rec.points[rec.pt_mask])


def cmd_reconstruct(args):
    from fastmatch_tpu_torch.pipeline.reconstruct import reconstruct
    from fastmatch_tpu_torch.utils.metrics import profile_trace

    if args.mode == "global":
        raise not_ported("reconstruct --mode global (pipeline/global_sfm.py)", 4)
    _refuse_unported(args)
    cfg = _load_config(args)
    secs = {}
    feats, cam = _load_features(args, cfg, secs)
    metrics = _metrics(args)
    with profile_trace(args.profile_dir):
        rec = reconstruct(feats, cam, cfg, metrics=metrics, device=_device(args))
    if metrics:
        metrics.log("stage_seconds", **{**rec.stage_seconds, **secs})
        metrics.close()
    if args.out:
        _save_map(args.out, rec)
    print(json.dumps({"n_frames": rec.n_frames, "n_points": int(rec.pt_mask.sum()),
                      "n_obs": rec.n_obs, "out": args.out}))


def cmd_slam(args):
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig

    if args.mesh:
        raise not_ported("slam --mesh (dist/pipeline.py)", 9)
    if args.checkpoint_interval or args.resume or args.no_overlap:
        raise not_ported("--checkpoint-interval/--resume/--no-overlap (with --mesh)", 9)
    if args.plot:
        raise not_ported("slam --plot (utils/viz.py)", 4)
    _refuse_unported(args)
    cfg = _load_config(args)
    scfg = SlamConfig(window=args.window, loop_gap=args.loop_gap,
                      loop_min_votes=args.loop_min_votes)
    dev = _device(args)
    # "auto", as in the JAX package: the device engine on the card, the
    # host engine on the CPU.
    engine = args.engine
    if engine == "auto":
        engine = "device" if dev.type == "cuda" else "host"
    secs = {}
    feats, cam = _load_features(args, cfg, secs)
    metrics = _metrics(args)
    kw = dict(metrics=metrics, device=dev)
    if engine == "device":
        from fastmatch_tpu_torch.pipeline.slam_device import slam_device

        out = slam_device(feats, cam, cfg, scfg, **kw)
    elif engine == "scan":
        # Offline mapping: no per-frame decision but the BA cadence, no
        # in-loop closure (pipeline/slam_scan.py).
        from fastmatch_tpu_torch.pipeline.slam_scan import slam_scan

        out = slam_scan(feats, cam, cfg, scfg, **kw)
    elif engine == "chunked":
        # Near-online: scan slices with loop closure between them.
        from fastmatch_tpu_torch.pipeline.slam_scan import slam_chunked

        out = slam_chunked(feats, cam, cfg, scfg, chunk=args.chunk, **kw)
    else:
        from fastmatch_tpu_torch.pipeline.slam import slam

        out = slam(feats, cam, cfg, scfg, **kw)
    rec = out.rec
    if metrics:
        metrics.log("stage_seconds", **{**rec.stage_seconds, **secs})
        metrics.close()
    if args.out:
        _save_map(args.out, rec)
    if args.trajectory:
        _write_tum(args.trajectory, rec)
    print(json.dumps({"n_frames": rec.n_frames, "n_points": int(rec.pt_mask.sum()),
                      "loop_closures": len(out.loop_edges), "pgo_runs": out.pgo_runs,
                      "engine": engine, "out": args.out}))


def _quat_xyzw(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def _write_tum(path, rec):
    """The trajectory in TUM format (ts tx ty tz qx qy qz qw), camera to
    world; ``datasets.load_tum_trajectory`` reads it."""
    with open(path, "w") as fh:
        fh.write("# ts tx ty tz qx qy qz qw\n")
        for f in range(rec.n_frames):
            Rwc = rec.R[f].T
            c = -Rwc @ rec.t[f]
            q = _quat_xyzw(Rwc)
            fh.write(f"{float(f):.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                     f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def _load_traj(path: str) -> np.ndarray:
    """(N, 3) camera centres from an --out .npz (``centers``) or a TUM
    text trajectory."""
    if path.endswith(".npz"):
        return np.load(path)["centers"]
    from fastmatch_tpu_torch.datasets import load_tum_trajectory

    return load_tum_trajectory(path)[1]


def cmd_evaluate(args):
    cfg = _load_config(args)
    if args.plot_dir:
        raise not_ported("evaluate --plot-dir (utils/viz.py)", 4)
    if args.dataset == "traj":
        import torch

        from fastmatch_tpu_torch.utils.evaluation import ate_rmse, rpe_trans

        est = torch.from_numpy(np.asarray(_load_traj(args.est), np.float32))
        gt = torch.from_numpy(np.asarray(_load_traj(args.gt), np.float32))
        if len(est) != len(gt):
            raise ValueError(f"length mismatch: est {len(est)} vs gt {len(gt)} frames "
                             "(trajectories must be frame-aligned)")
        rpe_rmse, rpe_med = rpe_trans(est, gt, delta=args.rpe_delta)
        print(json.dumps({"n_frames": int(len(est)), "ate_rmse": float(ate_rmse(est, gt)),
                          "rpe_rmse": float(rpe_rmse), "rpe_median": float(rpe_med),
                          "rpe_delta": args.rpe_delta}))
        return
    from fastmatch_tpu_torch.datasets import (evaluate_pairs, load_vgg_dataset,
                                              synthesize_warped_pair)

    if args.dataset == "synth":
        pairs = [synthesize_warped_pair(seed) for seed in range(args.n_synth)]
    else:
        pairs = load_vgg_dataset(args.dataset)
    size = (args.resize, args.resize) if args.resize else None
    results, agg = evaluate_pairs(pairs, sift_cfg=cfg.sift, ratio=cfg.matching.ratio,
                                  tol=args.tol, backend=cfg.matching.backend, size=size,
                                  device=_device(args))
    for r in results:
        print(json.dumps(r))
    print(json.dumps({"aggregate": agg}))


def _cmd_unported(args):
    raise not_ported(f"the {args.cmd!r} subcommand", _UNPORTED_COMMANDS[args.cmd])


def cmd_bench(args):
    raise NotImplementedError("bench is not yet ported: the port has no benchmark "
                              "(BENCHMARK.json) yet; python3 chip_smoke.py times its kernels")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m fastmatch_tpu_torch.cli")
    p.add_argument("--config", help="YAML/JSON config file")
    p.add_argument("--set", action="append", help="dotted config override k=v")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; never falls back to the CPU")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("info")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("match")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.add_argument("--out")
    sp.add_argument("--verify", default="none", choices=["none", "fundamental", "homography"],
                    help="geometric verification filter (image inputs only)")
    sp.add_argument("--method", choices=("ratio", "mirror"), default="ratio",
                    help="ratio = Lowe top-2 + cross-check; mirror: not yet ported")
    sp.add_argument("--mirror-tau", type=float, default=1.0)
    sp.add_argument("--feature", choices=("sift", "orb"), default="sift",
                    help="descriptor family of image inputs: sift (float L2) or orb "
                         "(256-bit binary, Hamming)")
    sp.add_argument("--verify-thr", type=float, default=3.0,
                    help="inlier threshold in pixels for --verify")
    sp.set_defaults(fn=cmd_match)

    sp = sub.add_parser("reconstruct")
    sp.add_argument("input", help="image dir or features .npz")
    _add_camera_args(sp)
    sp.add_argument("--mode", choices=["incremental", "global"], default="incremental",
                    help="incremental SfM; global: not yet ported")
    sp.add_argument("--window", type=int, default=8, help="global mode's view-graph window")
    sp.add_argument("--out")
    sp.add_argument("--checkpoint")
    sp.add_argument("--metrics", help="write JSONL metrics here")
    sp.add_argument("--profile-dir", help="capture a torch.profiler trace here")
    sp.add_argument("--selfcal", type=int, default=0, metavar="N")
    _add_gps_args(sp)
    _add_export_args(sp)
    sp.set_defaults(fn=cmd_reconstruct)

    sp = sub.add_parser("slam")
    sp.add_argument("input", help="image dir or features .npz")
    _add_camera_args(sp)
    sp.add_argument("--window", type=int, default=8)
    sp.add_argument("--loop-gap", type=int, default=12)
    sp.add_argument("--loop-min-votes", type=int, default=25)
    sp.add_argument("--engine", choices=("auto", "device", "host", "scan", "chunked"),
                    default="auto", help="auto = device on the card, host on the CPU; "
                    "device = one track_step a frame with online loop closure; scan = "
                    "offline, no in-loop closure; chunked = scan slices with loop closure "
                    "between them")
    sp.add_argument("--chunk", type=int, default=16,
                    help="with --engine chunked: frames per slice")
    sp.add_argument("--mesh", help="multi-card pipeline: not yet ported")
    sp.add_argument("--no-overlap", action="store_true")
    sp.add_argument("--checkpoint-interval", type=int, default=0)
    sp.add_argument("--resume")
    sp.add_argument("--out")
    sp.add_argument("--plot")
    sp.add_argument("--trajectory", help="write TUM-format trajectory here")
    sp.add_argument("--checkpoint")
    sp.add_argument("--metrics", help="write JSONL metrics here")
    sp.add_argument("--selfcal", type=int, default=0, metavar="N")
    _add_gps_args(sp)
    _add_export_args(sp)
    sp.set_defaults(fn=cmd_slam)

    sp = sub.add_parser("evaluate")
    sp.add_argument("dataset", help="Oxford-VGG sequence dir (img1..imgN + H1to*p), "
                    "'synth', or 'traj' (trajectory ATE/RPE: --est/--gt)")
    sp.add_argument("--n-synth", type=int, default=3)
    sp.add_argument("--tol", type=float, default=3.0)
    sp.add_argument("--resize", type=int, default=0)
    sp.add_argument("--plot-dir")
    sp.add_argument("--est", help="traj: estimated trajectory (.npz 'centers' or TUM)")
    sp.add_argument("--gt", help="traj: ground-truth trajectory (same formats)")
    sp.add_argument("--rpe-delta", type=int, default=1)
    sp.set_defaults(fn=cmd_evaluate)

    for name in _UNPORTED_COMMANDS:
        sp = sub.add_parser(name, help="not yet ported")
        sp.add_argument("rest", nargs=argparse.REMAINDER)
        sp.set_defaults(fn=_cmd_unported)
    sp = sub.add_parser("bench", help="not yet ported")
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
