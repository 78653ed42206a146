"""K3's share of feature detection for one checkout of the port, on one GPU.

Imports ``fastmatch_tpu_torch`` from ``--root`` (default: this checkout), so
two commits are compared on one card by running this script once per
checkout, in turns, inside one call (parent, change, change, parent). Runs
``detect_and_describe`` (SIFT, ``SIFTConfig()``) and
``detect_and_describe_orb`` (``ORBConfig()``) on the first ``--frames``
rendered 640x480 frames of the smoke scene (``chip_smoke.SMOKE_SCENE``) and
records, for each detector:

- by ``torch.profiler`` over one pass over the frames: K3's device us and
  launches a frame (the kernels ``gather_patches_kernel``, one a patch set,
  and ``gather_patch_sets_kernel``, one a frame), the device us and launches
  a frame of PyTorch's replicate-pad kernels (names holding
  ``replication_pad``), every kernel's device us and launches a frame, and
  the kernels that took the most device time;
- the wall ms a frame: host clock around a pass over the frames that ends
  in a synchronise, divided by the frames (median of ``--reps`` passes);
- a sha256 of every frame's outputs (keypoint xy, scale, angle, score and
  mask, and SIFT's float descriptors or ORB's packed bits), and one over all
  frames, so two checkouts are compared bit for bit.

Prints one JSON line and appends it to ``chiprun_out/patch_gather_ab.jsonl``.

    python tools/patch_gather_ab.py [--root DIR] [--label NAME] [--frames N]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# K3 under both designs: one launch a patch set, and one launch a frame.
K3_NAMES = {"gather_patches_kernel", "gather_patch_sets_kernel"}


def _digest(kps, desc) -> str:
    h = hashlib.sha256()
    for t in (kps.xy, kps.scale, kps.angle, kps.score, kps.mask, desc):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose src/ to import")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("patch_gather_ab: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import kernel_short_name, nvidia_smi_line, render_smoke_scene
    import fastmatch_tpu_torch  # noqa: F401  (sets the float32 matmul pin)
    from fastmatch_tpu_torch.features.orb import ORBConfig, detect_and_describe_orb
    from fastmatch_tpu_torch.features.sift import SIFTConfig, detect_and_describe
    from fastmatch_tpu_torch.kernels import _build

    _build.build_all()
    _, views = render_smoke_scene(args.frames)
    frames = [torch.as_tensor(v, dtype=torch.float32).cuda() for v in views]

    def sift(f):
        kps, desc = detect_and_describe(f, SIFTConfig(), device="cuda")
        return kps, desc.data

    def orb(f):
        kps, desc = detect_and_describe_orb(f, ORBConfig(), device="cuda")
        return kps, desc.packed

    detectors = {"sift": sift, "orb": orb}
    out = dict(label=args.label, root=os.path.abspath(args.root), frames=len(frames),
               device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line())
    n = len(frames)
    for name, fn in detectors.items():
        digests = [_digest(*fn(f)) for f in frames]  # also the warm-up pass
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for f in frames:
                fn(f)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / n * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for f in frames:
                fn(f)
            torch.cuda.synchronize()
        k3, pads, every, by_name = [0.0, 0], [0.0, 0], [0.0, 0], {}
        for ev in prof.events():
            if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            us = ev.time_range.end - ev.time_range.start
            picks = [every]
            if kernel_short_name(ev.name) in K3_NAMES:
                picks.append(k3)
            if "replication_pad" in ev.name:
                picks.append(pads)
            for acc in picks + [by_name.setdefault(ev.name[:100], [0.0, 0])]:
                acc[0] += us
                acc[1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        whole = hashlib.sha256("".join(digests).encode()).hexdigest()
        out[name] = dict(
            wall_ms_per_frame=statistics.median(walls), wall_ms_per_frame_all=walls,
            k3_device_us_per_frame=k3[0] / n, k3_launches_per_frame=k3[1] / n,
            pad_device_us_per_frame=pads[0] / n, pad_launches_per_frame=pads[1] / n,
            device_us_per_frame=every[0] / n, device_launches_per_frame=every[1] / n,
            top_kernels=[dict(name=k, device_us_per_frame=v[0] / n, launches_per_frame=v[1] / n)
                         for k, v in top],
            sha256=whole, sha256_per_frame=[d[:16] for d in digests])
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "patch_gather_ab.jsonl"), "a") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
