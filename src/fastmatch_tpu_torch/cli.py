"""Command-line interface of the PyTorch/CUDA port.

    python -m fastmatch_tpu_torch.cli [--device cpu] [--config F] [--set k=v] CMD ...

Port of ``fastmatch_tpu/cli.py`` for the subcommands whose engines are
ported, with the JAX package's argument names and JSON output:

  info        torch version, device name, power limit
  match       two descriptor files (.npy) or two images (SIFT or ORB),
              optional geometric verification
  reconstruct incremental SfM (or global SfM with --mode global) over an
              image directory or .npz features; --selfcal N refines the
              intrinsics against the map
  evaluate    match precision/recall ('synth' pairs or an Oxford-VGG
              directory; --plot-dir for match figures) or trajectory
              ATE/RPE ('traj --est --gt')
  slam        SLAM with loop closure (--engine auto|device|host|scan|chunked),
              or on a (data, bank) mesh of ranks with --mesh; --selfcal N,
              --plot PNG (top-down trajectory)
  flow        KLT: Shi-Tomasi corners on A tracked into B
  vo          KLT visual odometry over an image directory (--engine host|scan),
              or metric stereo VO with --right
  stereo      dense rectified-stereo depth of two images
  densify     dense cloud from a posed image directory
  vialign     visual-inertial metric upgrade of a trajectory
  locate      localize frames against a saved map (exact or IVF search,
              or VLAD retrieval with --retrieval K)
  merge       merge two saved maps into one
  serve       HTTP localization service over a saved map

Everything runs on the card unless ``--device cpu`` is given. What is not
ported yet raises ``NotImplementedError`` naming its ROADMAP item, and
nothing is dropped silently: ``bench`` waits for the port's benchmark
(Queue 1 item 2). ``slam --mesh`` runs ``dist/pipeline.slam_distributed``:
every rank runs the same command, joined by COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID (none set: one rank), NCCL on the card and
gloo with ``--device cpu``; rank 0 writes the files. Figures (``--plot``,
``--plot-dir``) need matplotlib, imported only when one is asked for. Config: a JSON or YAML
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

    if args.feature == "orb" and args.method == "mirror":
        raise ValueError("--method mirror applies to SIFT float descriptors; ORB matches in "
                         "Hamming space")
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
    elif args.method == "mirror":
        from fastmatch_tpu_torch.matching.mirror import match_pair_mirror

        m = match_pair_mirror(da, db, tau=args.mirror_tau, device=dev)
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
    sp.add_argument("--gps", metavar="NPZ",
                    help="georegister the map to GPS camera centres: npz with 'frames' "
                    "(sequence indices) and 'xyz' ((K, 3) world positions); sim(3) "
                    "alignment, GPS-anchored pose graph, anchored BA")
    sp.add_argument("--gps-weight", type=float, default=10.0,
                    help="GPS prior information scale")
    sp.add_argument("--gps-delta", type=float, default=None,
                    help="robust width (metres) of the GPS priors (geman kernel)")


def _run_gps(args, rec, cfg, metrics, frame_seq=None):
    """--gps: the georegistration post-pass (pipeline/georegister.py)."""
    from fastmatch_tpu_torch.pipeline.georegister import georegister

    data = np.load(args.gps)
    return georegister(rec, data["frames"], data["xyz"], cfg, weight=args.gps_weight,
                       prior_delta=args.gps_delta, frame_seq=frame_seq, metrics=metrics)


def _save_checkpoint(args, rec):
    """--checkpoint DIR: the map in the port's format (pipeline/checkpoint.py)."""
    if args.checkpoint:
        from fastmatch_tpu_torch.pipeline.checkpoint import save_map

        save_map(rec, args.checkpoint)


def _add_export_args(sp):
    sp.add_argument("--export-ply", help="write the sparse point cloud as ASCII PLY")
    sp.add_argument("--export-colmap", metavar="DIR", help="write a COLMAP text model")
    sp.add_argument("--export-kitti", help="write the trajectory in KITTI format")


def _run_selfcal(rec, cam, cfg, rounds: int, metrics):
    """--selfcal N: the in-place intrinsics refinement post-pass
    (ba/calibrate.py); returns the refined camera and the JAX CLI's JSON
    summary."""
    from fastmatch_tpu_torch.ba.calibrate import self_calibrate

    cam2, hist = self_calibrate(rec, cam, cfg, rounds=rounds, metrics=metrics)
    vec = cam2.intrinsics_vector()
    return cam2, {
        "fx": round(float(vec[0]), 3), "fy": round(float(vec[1]), 3),
        "cx": round(float(vec[2]), 3), "cy": round(float(vec[3]), 3),
        "dist": [round(float(v), 6) for v in vec[4:]],
        "mean_px2": round(hist[-1][0], 6),
    }


def _run_exports(args, rec, cam):
    """--export-ply / --export-colmap / --export-kitti of a map."""
    from fastmatch_tpu_torch.utils import export

    if getattr(args, "export_ply", None):
        export.save_ply(args.export_ply, rec.points[rec.pt_mask])
    if getattr(args, "export_colmap", None):
        # The CLI always centres the principal point (w/2, h/2).
        size = (int(round(2 * float(cam.cx))), int(round(2 * float(cam.cy))))
        export.save_colmap_text(args.export_colmap, rec, cam, image_size=size)
    if getattr(args, "export_kitti", None):
        export.save_kitti_trajectory(args.export_kitti, rec)


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

    cfg = _load_config(args)
    secs = {}
    feats, cam = _load_features(args, cfg, secs)
    metrics = _metrics(args)
    dev = _device(args)
    with profile_trace(args.profile_dir):
        if args.mode == "global":
            from fastmatch_tpu_torch.pipeline.global_sfm import global_reconstruct

            rec = global_reconstruct(feats, cam, cfg, metrics=metrics, window=args.window,
                                     device=dev)
        else:
            rec = reconstruct(feats, cam, cfg, metrics=metrics, device=dev)
    selfcal = None
    if args.selfcal:
        cam, selfcal = _run_selfcal(rec, cam, cfg, args.selfcal, metrics)
    gps = _run_gps(args, rec, cfg, metrics) if args.gps else None
    if metrics:
        metrics.log("stage_seconds", **{**rec.stage_seconds, **secs})
        metrics.close()
    if args.out:
        _save_map(args.out, rec)
    _save_checkpoint(args, rec)
    _run_exports(args, rec, cam)
    print(json.dumps({"n_frames": rec.n_frames, "n_points": int(rec.pt_mask.sum()),
                      "n_obs": rec.n_obs, "out": args.out,
                      **({"selfcal": selfcal} if selfcal else {}),
                      **({"gps": gps} if gps else {})}))


def _parse_mesh(spec: str) -> dict:
    """'bank=4' / 'data=2,bank=4' -> {'n_data': 2, 'n_bank': 4}."""
    out = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in ("data", "bank") or not v.strip().isdigit():
            raise SystemExit(f"bad --mesh spec {spec!r}; use e.g. "
                             "'bank=4' or 'data=2,bank=4'")
        out["n_" + k] = int(v)
    return out


def cmd_slam(args):
    from fastmatch_tpu_torch.pipeline.slam import SlamConfig

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
    if not args.mesh and (args.checkpoint_interval or args.resume or args.no_overlap):
        raise SystemExit("--checkpoint-interval, --resume and --no-overlap need --mesh")
    if args.mesh:
        import torch.distributed as dist

        from fastmatch_tpu_torch.dist.bootstrap import initialize_distributed

        mesh_shape = _parse_mesh(args.mesh)
        initialize_distributed(device=dev)
        if dist.get_rank() != 0:
            # Every rank holds the same map: rank 0 alone writes the files.
            args = argparse.Namespace(**{**vars(args), **dict.fromkeys(
                ("out", "trajectory", "plot", "checkpoint", "metrics", "export_ply",
                 "export_colmap", "export_kitti"))})
    metrics = _metrics(args)
    kw = dict(metrics=metrics, device=dev)
    if args.mesh:
        # Sharded retrieval + distributed BA + overlap + periodic
        # checkpoint on a (data, bank) mesh of ranks.
        from fastmatch_tpu_torch.dist.pipeline import DistConfig, slam_distributed

        engine = "mesh"
        dcfg = DistConfig(**mesh_shape, checkpoint_dir=args.checkpoint,
                          checkpoint_interval=args.checkpoint_interval,
                          overlap=not args.no_overlap)
        out = slam_distributed(feats, cam, cfg, scfg, dcfg, resume_from=args.resume, **kw)
    elif engine == "device":
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
    selfcal = None
    if args.selfcal:
        cam, selfcal = _run_selfcal(rec, cam, cfg, args.selfcal, metrics)
    gps = _run_gps(args, rec, cfg, metrics, frame_seq=out.frame_seq) if args.gps else None
    if metrics:
        metrics.log("stage_seconds", **{**rec.stage_seconds, **secs})
        metrics.close()
    if args.out:
        _save_map(args.out, rec)
    if args.trajectory:
        _write_tum(args.trajectory, rec)
    if args.plot:
        from fastmatch_tpu_torch.utils.viz import plot_trajectory

        plot_trajectory(rec.camera_centers(), args.plot)
    _save_checkpoint(args, rec)
    _run_exports(args, rec, cam)
    print(json.dumps({"n_frames": rec.n_frames, "n_points": int(rec.pt_mask.sum()),
                      "loop_closures": len(out.loop_edges), "pgo_runs": out.pgo_runs,
                      "engine": engine, "out": args.out,
                      **({"selfcal": selfcal} if selfcal else {}),
                      **({"gps": gps} if gps else {})}))


def _image_dir(path):
    """(first frame, iterator of every frame at its size, paths) of an
    image directory in lexical order; a frame that fails to decode raises."""
    import glob

    from fastmatch_tpu_torch.utils.imageio import FrameLoader, load_gray

    paths = sorted(glob.glob(path + "/*"))
    if len(paths) < 2:
        raise ValueError(f"{path}: need at least 2 frames, found {len(paths)}")
    first = load_gray(paths[0])
    h, w = first.shape

    def frames(limit=len(paths)):
        yield first
        expected = 1
        with FrameLoader(paths[1:limit], size=(w, h)) as fl:
            for idx, img in fl:
                if idx + 1 != expected:
                    raise IOError(f"failed to decode {paths[expected]}")
                expected += 1
                yield img
        if expected != limit:
            raise IOError(f"failed to decode {paths[expected]}")

    return first, frames, paths


def cmd_flow(args):
    """KLT tracking between two images: Shi-Tomasi corners on A tracked into
    B, optionally filtered by the descriptor matcher's geometric verification."""
    import torch

    from fastmatch_tpu_torch.core.containers import Keypoints, Matches
    from fastmatch_tpu_torch.features.klt import KLTConfig, track_pair
    from fastmatch_tpu_torch.utils.imageio import load_gray

    dev = _device(args)
    cfg = KLTConfig(levels=args.levels, win=args.win)
    p0, p1, status, err = track_pair(load_gray(args.a), load_gray(args.b), cfg,
                                     capacity=args.capacity, device=dev)
    report = {"n_corners": int(status.shape[0]), "n_tracked": int(status.sum())}
    if args.verify != "none":
        from fastmatch_tpu_torch.matching.verify import verify_matches

        cap = p0.shape[0]

        def kp(xy):
            return Keypoints(xy=xy, scale=torch.ones(cap, device=dev),
                             angle=torch.zeros(cap, device=dev),
                             score=torch.zeros(cap, device=dev), mask=status)

        m = Matches(idx=torch.arange(cap, dtype=torch.int32, device=dev),
                    dist=torch.where(status, err, torch.zeros_like(err)), valid=status)
        vr = verify_matches(kp(p0), kp(p1), m, model=args.verify, thr_px=args.verify_thr,
                            generator=torch.Generator(dev).manual_seed(0), device=dev)
        status = vr.matches.valid
        report["verified"] = bool(vr.ok)
        report["model_inliers"] = int(vr.n_inliers)
    st = status.cpu().numpy()
    err = err.cpu().numpy()
    if args.out:
        np.savez(args.out, xy_a=p0.cpu().numpy()[st], xy_b=p1.cpu().numpy()[st], err=err[st])
    mean_err = float(err[st].mean()) if st.any() else 0.0
    print(json.dumps({**report, "n_final": int(st.sum()),
                      "mean_residual": round(mean_err, 5), "out": args.out}))


def cmd_stereo(args):
    """Dense rectified-stereo depth of two images, given a rig baseline
    (rectified inputs) or a relative pose .npz (R, t) to rectify them first;
    a disparity/depth .npz and optionally a dense PLY point cloud."""
    from fastmatch_tpu_torch.dense.stereo import (StereoConfig, depth_from_disparity,
                                                  disparity_to_points, rectify_pair,
                                                  stereo_disparity)
    from fastmatch_tpu_torch.utils.imageio import load_gray

    dev = _device(args)
    left, right = load_gray(args.left), load_gray(args.right)
    h, w = left.shape
    fx = args.focal if args.focal else 1.2 * max(h, w)
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    baseline = args.baseline
    if args.pose:
        pose = np.load(args.pose)
        la, rb, info = rectify_pair(left, right, K, pose["R"], pose["t"], device=dev)
        left, right = la.cpu().numpy(), rb.cpu().numpy()
        baseline = info["baseline"] * (args.baseline or 1.0)
    elif baseline is None:
        raise ValueError("need --baseline (rectified rig) or --pose npz")
    cfg = StereoConfig(max_disp=args.max_disp, win=args.win)
    disp, valid = stereo_disparity(left, right, cfg, device=dev)
    depth = depth_from_disparity(disp, valid, fx, baseline).cpu().numpy()
    disp, v = disp.cpu().numpy(), valid.cpu().numpy()
    report = {"valid_frac": round(float(v.mean()), 4),
              "median_depth": round(float(np.median(depth[v])), 4) if v.any() else None}
    if args.out:
        np.savez(args.out, disparity=disp, valid=v, depth=depth)
        report["out"] = args.out
    if args.export_ply:
        from fastmatch_tpu_torch.utils.export import save_ply

        pts, inten = disparity_to_points(disp, v, K, baseline, image=left, stride=args.stride,
                                         max_depth=args.max_depth)
        save_ply(args.export_ply, pts,
                 colors=np.repeat((inten * 255).astype(np.uint8)[:, None], 3, axis=1))
        report["ply"] = args.export_ply
        report["n_points"] = int(len(pts))
    print(json.dumps(report))


def cmd_vo(args):
    """KLT visual odometry over an image directory: the host engine, the
    scan engine (--engine scan), or metric stereo VO with a rectified right
    directory (--right)."""
    from fastmatch_tpu_torch.features.klt import KLTConfig
    from fastmatch_tpu_torch.pipeline.vo import VOConfig, visual_odometry

    if args.right and args.engine != "host":
        raise ValueError("--right runs the stereo engine; it cannot be combined with "
                         f"--engine {args.engine}")
    cfg = _load_config(args)
    dev = _device(args)
    first, frames, paths = _image_dir(args.input)
    h, w = first.shape
    cam = _make_camera(args, (w, h))
    vo = VOConfig(capacity=args.capacity, bootstrap_px=args.bootstrap_px, kf_px=args.kf_px,
                  klt=KLTConfig(levels=args.levels))
    metrics = _metrics(args)
    if args.right:
        # A rectified stereo rig: metric VO, no bootstrap and no scale gauge.
        from fastmatch_tpu_torch.pipeline.stereo_vo import (StereoVOConfig,
                                                            stereo_visual_odometry)

        rfirst, rframes, rpaths = _image_dir(args.right)
        if len(rpaths) != len(paths):
            raise ValueError(f"--right: {len(rpaths)} frames vs {len(paths)} left")
        if rfirst.shape != first.shape:
            raise ValueError(f"--right: frames of {rfirst.shape} vs {first.shape} left")
        svo = StereoVOConfig(capacity=args.capacity, klt=KLTConfig(levels=args.levels))
        rec = stereo_visual_odometry(frames(), rframes(), cam, args.baseline, cfg, svo,
                                     metrics=metrics, device=dev)
    elif args.engine == "scan":
        # The scan engine takes the whole stack at once (one upload).
        from fastmatch_tpu_torch.pipeline.vo_scan import visual_odometry_scan

        rec = visual_odometry_scan(list(frames()), cam, cfg, vo, metrics=metrics, device=dev)
    else:
        rec = visual_odometry(frames(), cam, cfg, vo, metrics=metrics, device=dev)
    if metrics:
        metrics.log("stage_seconds", **rec.stage_seconds)
        metrics.close()
    if args.out:
        _save_map(args.out, rec)
    _run_exports(args, rec, cam)
    n_kf = sum(1 for s in rec.frame_stats if s.get("kf"))
    n_fail = sum(1 for s in rec.frame_stats if s.get("pnp_failed"))
    print(json.dumps({"n_frames": rec.n_frames, "n_keyframes": n_kf,
                      "n_points": int(rec.pt_mask.sum()), "n_obs": rec.n_obs,
                      "pnp_failures": n_fail, "out": args.out}))


def cmd_densify(args):
    """Dense mapping: stereo-sweep selected frame pairs of a posed image
    directory (poses from a vo/reconstruct/slam --out .npz) into one fused
    world-frame cloud."""
    from fastmatch_tpu_torch.dense.densify import densify
    from fastmatch_tpu_torch.dense.stereo import StereoConfig
    from fastmatch_tpu_torch.utils.export import save_ply

    dev = _device(args)
    traj = np.load(args.traj)
    R, t = traj["R"], traj["t"]
    sparse = traj["points"] if "points" in traj.files else None
    first, frames, paths = _image_dir(args.input)
    if len(paths) < R.shape[0]:
        raise ValueError(f"{len(paths)} images < {R.shape[0]} poses")
    images = list(frames(R.shape[0]))
    h, w = first.shape
    K = np.array([[args.focal, 0, w / 2], [0, args.focal, h / 2], [0, 0, 1.0]])
    pts, inten, rep = densify(images, R, t, K, sparse_points=sparse,
                              cfg=StereoConfig(max_disp=args.max_disp, win=args.win),
                              stride=args.stride, voxel=args.voxel, device=dev)
    if args.export_ply:
        save_ply(args.export_ply, pts,
                 colors=np.repeat((np.clip(inten, 0, 1) * 255).astype(np.uint8)[:, None], 3, 1))
        rep["ply"] = args.export_ply
    print(json.dumps(rep))


def cmd_vialign(args):
    """Visual-inertial metric upgrade: align a monocular trajectory .npz
    (vo/reconstruct/slam --out) with IMU sample runs and write its metric,
    gravity-aligned version."""
    import torch

    from fastmatch_tpu_torch.sensors.imu import gravity_rotation, preintegrate, vi_align

    dev = _device(args)
    traj = np.load(args.traj)
    R_wc, t = traj["R"].astype(np.float32), traj["t"].astype(np.float32)
    F = R_wc.shape[0]
    imu = np.load(args.imu)
    gyro, accel, dts = (imu["gyro"].astype(np.float32), imu["accel"].astype(np.float32),
                        imu["dt"].astype(np.float32))
    interval = imu["interval"].astype(np.int64)  # sample -> frame interval i
    if interval.max() != F - 2:
        raise ValueError(f"imu intervals cover 0..{interval.max()}, trajectory needs "
                         f"0..{F - 2}")
    # Samples per interval, padded to the longest interval with masked rows.
    cap = int(np.bincount(interval, minlength=F - 1).max())
    g_b = np.zeros((F - 1, cap, 3), np.float32)
    a_b = np.zeros((F - 1, cap, 3), np.float32)
    d_b = np.zeros((F - 1, cap), np.float32)
    m_b = np.zeros((F - 1, cap), bool)
    fill = np.zeros(F - 1, np.int64)
    for s, i in enumerate(interval):
        k = fill[i]
        g_b[i, k], a_b[i, k], d_b[i, k] = gyro[s], accel[s], dts[s]
        m_b[i, k] = True
        fill[i] += 1
    pres = preintegrate(g_b, a_b, d_b, torch.from_numpy(m_b), device=dev)
    centers = -np.einsum("fji,fj->fi", R_wc, t)
    s, g, _, resid = vi_align(R_wc.transpose(0, 2, 1), centers.astype(np.float32), pres,
                              g_mag=args.g)
    s = float(s)
    g_np = g.cpu().numpy().astype(np.float64)
    R_g = gravity_rotation(g_np)
    R_new = np.einsum("fij,kj->fik", R_wc, R_g).astype(np.float32)
    t_new = (s * t).astype(np.float32)
    out = {"R": R_new, "t": t_new, "centers": -np.einsum("fji,fj->fi", R_new, t_new)}
    if "points" in traj.files:
        out["points"] = (s * (traj["points"] @ R_g.T)).astype(np.float32)
    np.savez(args.out, **out)
    print(json.dumps({"scale": round(s, 6), "gravity": [round(float(x), 4) for x in g_np],
                      "resid": round(float(resid), 6), "out": args.out}))


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
                                  plot_dir=args.plot_dir, device=_device(args))
    for r in results:
        print(json.dumps(r))
    print(json.dumps({"aggregate": agg}))


def cmd_locate(args):
    """Localize frames against a saved map (kidnapped-robot query): exact
    search, or the IVF index above the crossover (pipeline/localize.py);
    --retrieval K retrieves the top-K keyframes by VLAD and matches only
    their landmarks (pipeline/retrieval.py)."""
    cfg = _load_config(args)
    dev = _device(args)
    feats, cam = _load_features(args, cfg)
    if args.retrieval > 0:
        from fastmatch_tpu_torch.pipeline.retrieval import (build_keyframe_db,
                                                            localize_hierarchical,
                                                            map_from_checkpoint)

        md = map_from_checkpoint(args.map)
        db = build_keyframe_db(md, n_words=args.vocab_words, device=dev)

        def _localize(xy, d, m):
            return localize_hierarchical(md, db, xy, d, m, cam, topk=args.retrieval,
                                         thr_px=args.thr_px)
        mode = {"retrieval": args.retrieval}
    else:
        from fastmatch_tpu_torch.pipeline.localize import localize, map_index_from_checkpoint

        index = map_index_from_checkpoint(args.map, ann_threshold=args.ann_threshold,
                                          device=dev)

        def _localize(xy, d, m):
            return localize(index, xy, d, m, cam, thr_px=args.thr_px)
        mode = {"ann": index.ivf is not None}
    frames = range(len(feats)) if args.frame < 0 else [args.frame]
    n_ok = 0
    for k in frames:
        r = _localize(*feats[k])
        ok = bool(r.ok)
        n_ok += ok
        print(json.dumps({
            "frame": int(k), "ok": ok,
            "n_matches": int(r.n_matches), "n_inliers": int(r.n_inliers),
            "R": r.R.cpu().numpy().tolist() if ok else None,
            "t": r.t.cpu().numpy().tolist() if ok else None,
        }))
    print(json.dumps({"localized": n_ok, "of": len(frames), **mode}))
    return 0 if n_ok else 1


def _pinhole(args, dist: str = ""):
    """The camera of --focal/--width/--height (principal point at the
    centre), with --camera-model/--dist where the subcommand has them."""
    from fastmatch_tpu_torch.core.camera import Fisheye, Pinhole

    w, h = args.width, args.height
    K = np.array([[args.focal, 0, w / 2], [0, args.focal, h / 2], [0, 0, 1.0]], np.float32)
    coeffs = tuple(float(x) for x in dist.split(",")) if dist else ()
    model = getattr(args, "camera_model", "pinhole")
    return (Fisheye if model == "fisheye" else Pinhole).from_K(K, coeffs)


def cmd_merge(args):
    """Merge two saved maps (pipeline/merge.py): cross-localize map B's
    keyframes in map A through VLAD retrieval, recover the Sim(3) between
    the sessions, dedup shared landmarks, joint BA; writes the merged map."""
    from fastmatch_tpu_torch.pipeline.checkpoint import save_map
    from fastmatch_tpu_torch.pipeline.merge import merge_maps, rec_from_checkpoint

    if args.focal is None:
        raise ValueError("merge needs --focal: the focal length in pixels that both maps' "
                         "normalized observations were made with")
    dev = _device(args)
    cam = _pinhole(args)
    rec_a = rec_from_checkpoint(args.map_a, cam, device=dev)
    rec_b = rec_from_checkpoint(args.map_b, cam, device=dev)
    merged, info = merge_maps(rec_a, rec_b, thr_px=args.thr_px, topk=args.retrieval,
                              stride=args.stride, dedup_thr=args.dedup_thr,
                              refine=not args.no_refine)
    if args.out:
        save_map(merged, args.out)
        info["out"] = args.out
    _run_exports(args, merged, cam)
    info["n_frames"] = int(merged.n_frames)
    info["n_points"] = int(merged.n_points)
    print(json.dumps(info))
    return 0


def cmd_serve(args):
    """Serve localization queries over a saved map (pipeline/serve.py): the
    index built once, the query path run (and on the card its kernel
    built) before the socket opens, then HTTP until interrupted."""
    from fastmatch_tpu_torch.pipeline.serve import serve

    dev = _device(args)
    cam = _pinhole(args, args.dist)
    print(json.dumps({"serving": f"http://{args.host}:{args.port}", "map": args.map}),
          flush=True)
    serve(args.map, cam, host=args.host, port=args.port, ann_threshold=args.ann_threshold,
          thr_px=args.thr_px, device=dev)


def cmd_bench(args):
    raise not_ported("bench (the port has no benchmark, BENCHMARK.json, yet; python3 "
                     "chip_smoke.py times its kernels)", 2)


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
                    help="ratio = Lowe top-2 + cross-check; mirror = mutual NN gated by "
                    "joint-set distinctiveness (matching/mirror.py, no ratio test)")
    sp.add_argument("--mirror-tau", type=float, default=1.0,
                    help="mirror self-distance gate scale")
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
                    help="incremental SfM (default) or global SfM (rotation and "
                    "translation averaging over a view graph, one global BA: "
                    "pipeline/global_sfm.py)")
    sp.add_argument("--window", type=int, default=8, help="global mode's view-graph window")
    sp.add_argument("--out")
    sp.add_argument("--checkpoint", metavar="DIR",
                    help="save the map here (map.pt, pipeline/checkpoint.py)")
    sp.add_argument("--metrics", help="write JSONL metrics here")
    sp.add_argument("--profile-dir", help="capture a torch.profiler trace here")
    sp.add_argument("--selfcal", type=int, default=0, metavar="N",
                    help="after mapping, refine the camera intrinsics against the map: N "
                    "rounds of intrinsics refinement alternated with global BA")
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
    sp.add_argument("--mesh", help="multi-rank pipeline, e.g. 'bank=4' or 'data=1,bank=8': "
                    "ring-sharded retrieval + distributed BA + overlap on a (data, bank) "
                    "mesh of ranks (dist/pipeline.py)")
    sp.add_argument("--no-overlap", action="store_true",
                    help="with --mesh: disable retrieval/BA overlap (serial schedule, "
                    "identical results)")
    sp.add_argument("--checkpoint-interval", type=int, default=0,
                    help="with --mesh: snapshot the tracker state every N accepted frames "
                    "into --checkpoint (resumable via --resume)")
    sp.add_argument("--resume", help="with --mesh: resume from a --checkpoint dir "
                    "(bit-deterministic continuation)")
    sp.add_argument("--out")
    sp.add_argument("--plot", help="write a top-down trajectory PNG here (matplotlib)")
    sp.add_argument("--trajectory", help="write TUM-format trajectory here")
    sp.add_argument("--checkpoint", metavar="DIR",
                    help="save the map here (map.pt, pipeline/checkpoint.py); with --mesh "
                    "and --checkpoint-interval also the tracker snapshots (track.pt)")
    sp.add_argument("--metrics", help="write JSONL metrics here")
    sp.add_argument("--selfcal", type=int, default=0, metavar="N",
                    help="after mapping, refine the camera intrinsics against the map: N "
                    "rounds of intrinsics refinement alternated with global BA")
    _add_gps_args(sp)
    _add_export_args(sp)
    sp.set_defaults(fn=cmd_slam)

    sp = sub.add_parser("evaluate")
    sp.add_argument("dataset", help="Oxford-VGG sequence dir (img1..imgN + H1to*p), "
                    "'synth', or 'traj' (trajectory ATE/RPE: --est/--gt)")
    sp.add_argument("--n-synth", type=int, default=3)
    sp.add_argument("--tol", type=float, default=3.0)
    sp.add_argument("--resize", type=int, default=0)
    sp.add_argument("--plot-dir", help="write per-pair match figures and a "
                    "precision/recall summary here (matplotlib)")
    sp.add_argument("--est", help="traj: estimated trajectory (.npz 'centers' or TUM)")
    sp.add_argument("--gt", help="traj: ground-truth trajectory (same formats)")
    sp.add_argument("--rpe-delta", type=int, default=1)
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("flow", help="KLT: Shi-Tomasi corners on A tracked into B")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.add_argument("--out", help=".npz of (xy_a, xy_b, err) for live tracks")
    sp.add_argument("--capacity", type=int, default=1024, help="corner capacity")
    sp.add_argument("--levels", type=int, default=3)
    sp.add_argument("--win", type=int, default=11)
    sp.add_argument("--verify", default="none", choices=["none", "fundamental", "homography"],
                    help="geometric verification filter on the tracks")
    sp.add_argument("--verify-thr", type=float, default=3.0)
    sp.set_defaults(fn=cmd_flow)

    sp = sub.add_parser("stereo", help="dense rectified-stereo depth: ZNCC shift-sweep, "
                        "subpixel winner, left-right check")
    sp.add_argument("left")
    sp.add_argument("right")
    sp.add_argument("--baseline", type=float,
                    help="rig baseline in world units (rectified inputs)")
    sp.add_argument("--pose", help=".npz with R (3,3), t (3,): rectify the pair first (t's "
                    "scale sets the depth unit unless --baseline also gives a scale factor)")
    sp.add_argument("--focal", type=float, help="fx in px (default 1.2*max(h,w))")
    sp.add_argument("--max-disp", type=int, default=64)
    sp.add_argument("--win", type=int, default=9)
    sp.add_argument("--out", help="output .npz (disparity, valid, depth)")
    sp.add_argument("--export-ply", help="dense colored point cloud PLY")
    sp.add_argument("--stride", type=int, default=2, help="PLY subsample stride")
    sp.add_argument("--max-depth", type=float, default=float("inf"))
    sp.set_defaults(fn=cmd_stereo)

    sp = sub.add_parser("vo", help="KLT visual odometry over an image directory: "
                        "flow-tracked landmarks + PnP, keyframed triangulation + BA")
    sp.add_argument("input", help="image directory (sorted lexically)")
    _add_camera_args(sp)
    sp.add_argument("--capacity", type=int, default=512, help="track slots")
    sp.add_argument("--levels", type=int, default=3, help="KLT pyramid levels")
    sp.add_argument("--bootstrap-px", type=float, default=20.0)
    sp.add_argument("--kf-px", type=float, default=12.0)
    sp.add_argument("--engine", choices=("host", "scan"), default="host",
                    help="host: the per-frame loop on the host; scan: the device-resident "
                    "loop after a batched bootstrap")
    sp.add_argument("--right", metavar="DIR", help="rectified right-image directory: "
                    "metric stereo VO (landmarks lifted by dense stereo); not with "
                    "--engine scan")
    sp.add_argument("--baseline", type=float, default=0.12,
                    help="stereo baseline (world units) for --right")
    sp.add_argument("--out", help="trajectory/points .npz")
    sp.add_argument("--metrics", help="JSONL metrics path")
    _add_export_args(sp)
    sp.set_defaults(fn=cmd_vo)

    sp = sub.add_parser("densify", help="dense mapping: stereo-sweep frame pairs of a "
                        "posed sequence into a fused world cloud")
    sp.add_argument("input", help="image directory (sorted lexically)")
    sp.add_argument("--traj", required=True,
                    help=".npz from vo/reconstruct --out (R, t[, points])")
    sp.add_argument("--focal", type=float, default=500.0)
    sp.add_argument("--max-disp", type=int, default=64)
    sp.add_argument("--win", type=int, default=9)
    sp.add_argument("--stride", type=int, default=2)
    sp.add_argument("--voxel", type=float, help="fusion grid (world units; default depth/200)")
    sp.add_argument("--export-ply", help="output PLY path")
    sp.set_defaults(fn=cmd_densify)

    sp = sub.add_parser("vialign", help="visual-inertial metric upgrade: align a monocular "
                        "trajectory with IMU runs -> metric, gravity-aligned npz")
    sp.add_argument("--traj", required=True,
                    help="trajectory .npz (R, t[, points]) from vo/reconstruct/slam --out")
    sp.add_argument("--imu", required=True,
                    help=".npz with gyro (N,3), accel (N,3) raw specific force, dt (N,), "
                    "interval (N,) mapping each sample to frame interval i (frames i -> i+1)")
    sp.add_argument("--g", type=float, default=9.81, help="gravity magnitude (m/s^2)")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_vialign)

    sp = sub.add_parser("locate", help="localize frames against a saved map")
    sp.add_argument("map", help="map checkpoint dir (slam/reconstruct --checkpoint output)")
    sp.add_argument("input", help="feature .npz or image directory")
    _add_camera_args(sp)
    sp.add_argument("--frame", type=int, default=-1, help="localize only this frame (-1 = all)")
    sp.add_argument("--thr-px", type=float, default=2.0)
    sp.add_argument("--ann-threshold", type=int, default=None,
                    help="bank rows from which the IVF index is used (default 100,000; "
                    "0 forces IVF)")
    sp.add_argument("--retrieval", type=int, default=0, metavar="K",
                    help="hierarchical mode: retrieve the top-K keyframes by VLAD, match "
                    "only their landmarks (0 = flat search over the whole bank)")
    sp.add_argument("--vocab-words", type=int, default=64,
                    help="VLAD vocabulary size for --retrieval")
    sp.set_defaults(fn=cmd_locate)

    sp = sub.add_parser("merge", help="merge two saved maps into one")
    sp.add_argument("map_a", help="map checkpoint dir (kept gauge)")
    sp.add_argument("map_b", help="map checkpoint dir (re-gauged into A)")
    sp.add_argument("--out", help="merged map checkpoint dir")
    sp.add_argument("--focal", type=float, default=None,
                    help="focal length in pixels of both maps (required)")
    sp.add_argument("--width", type=int, default=640)
    sp.add_argument("--height", type=int, default=480)
    sp.add_argument("--thr-px", type=float, default=2.0)
    sp.add_argument("--retrieval", type=int, default=4, metavar="K",
                    help="keyframes retrieved per cross-localization")
    sp.add_argument("--stride", type=int, default=1, help="localize every Nth frame of map B")
    sp.add_argument("--dedup-thr", type=float, default=None,
                    help="largest 3D distance (map A's units) at which two mutually matched "
                    "landmarks merge (default: 2%% of A's landmark-cloud diameter)")
    sp.add_argument("--no-refine", action="store_true",
                    help="skip the joint BA over the merged map")
    _add_export_args(sp)
    sp.set_defaults(fn=cmd_merge)

    sp = sub.add_parser("serve", help="HTTP localization service over a saved map")
    sp.add_argument("map", help="map checkpoint dir (slam/reconstruct --checkpoint output)")
    _add_camera_args(sp)
    sp.add_argument("--width", type=int, default=640)
    sp.add_argument("--height", type=int, default=480)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--thr-px", type=float, default=2.0)
    sp.add_argument("--ann-threshold", type=int, default=None,
                    help="bank rows from which the IVF index is used")
    sp.set_defaults(fn=cmd_serve)
    sp = sub.add_parser("bench", help="not yet ported")
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
