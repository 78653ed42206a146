"""Smoke run of the PyTorch/CUDA port (``fastmatch_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:

1. the device, and ``nvidia-smi``'s name and power limit;
2. build of the CUDA kernels under ``src/fastmatch_tpu_torch/csrc/`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: K2 (fused distance/top-2/column argmin) at 2048x2048 and
   2048x8192 in exact and fast mode, K3 (patch gather) at the orientation
   and descriptor patch shapes of a 640x480 frame, K4 (sorted segment sum)
   at the bundle adjustment's point- and camera-keyed shapes;
4. a small-input reference: ``reconstruct`` from synthetic features on the
   card and on the CPU, both held to the JAX package's ATE gate;
5. the main path at BASELINE.json config 3's size: ``reconstruct(images=...)``
   on rendered 640x480 frames with the default ``PipelineConfig``, with
   every kernel's launch count set to 0 just before and read just after.

Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The config-3 smoke scene: 640x480 rendered frames of a SyntheticScene
# (tests/synth.py). A 1.2-radian orbit over 50 frames gives ~1.4 degrees of
# parallax per frame at the scene centre, above MapConfig's 1-degree
# triangulation gate; the JAX package reconstructs all 50 frames of it on a
# CPU (tools/jax_reference_smoke.py).
SMOKE_SCENE = dict(seed=0, n_points=400, n_frames=50, span=1.2, image_size=(640, 480))
ATE_GATE = 0.35

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # tensor cores
PEAK_BYTES = 3.35e12         # HBM3


def render_smoke_scene(n_frames=None):
    """(scene, frames) of the smoke sequence; frames are (480, 640) f32."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import SyntheticScene, render_scene_views

    p = SMOKE_SCENE
    rng = np.random.default_rng(p["seed"])
    scene = SyntheticScene(rng, n_points=p["n_points"], n_frames=p["n_frames"],
                           image_size=p["image_size"], span=p["span"])
    frames = list(range(p["n_frames"] if n_frames is None else n_frames))
    views = render_scene_views(scene, rng, image_size=p["image_size"], frames=frames)
    return scene, views


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, batches=7, reps=10):
    """Median over ``batches`` of the mean ms per call of ``fn`` across
    ``reps`` back-to-back calls on the current stream, by CUDA events, after
    one warm-up call. A call's time includes its wrapper's host work
    wherever that is longer than the device work it enqueues."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(n_bytes, n_ops=0.0, peak_ops=PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions -----------------------------


def _descriptor_sets(rng, n, m, m_live, n_shared):
    """SIFT-like unit descriptors: n queries and an m-row bank whose first
    m_live rows are live and hold noisy copies of n_shared queries."""
    import numpy as np

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    q = unit(np.abs(rng.standard_normal((n, 128)))).astype(np.float32)
    bank = np.zeros((m, 128), np.float32)
    bank[:m_live] = unit(np.abs(rng.standard_normal((m_live, 128))))
    rows = rng.choice(m_live, n_shared, replace=False)
    bank[rows] = unit(np.abs(q[:n_shared] + 0.08 * rng.standard_normal((n_shared, 128))))
    mask_b = np.zeros(m, bool)
    mask_b[:m_live] = True
    return q, np.ones(n, bool), bank, mask_b


def check_k2(rng):
    """K2 at the matcher's shapes; returns (entry, details)."""
    import torch

    from fastmatch_tpu_torch.core.containers import Descriptors
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.matching.matcher import BIG, match_pair_plain

    dev = torch.device("cuda")
    details, entry = [], None
    for n, m, m_live in ((2048, 2048, 2048), (2048, 8192, 5000)):
        q, mq, bank, mb = _descriptor_sets(rng, n, m, m_live, 1500)
        da = Descriptors(torch.from_numpy(q).to(dev), torch.from_numpy(mq).to(dev))
        db = Descriptors(torch.from_numpy(bank).to(dev), torch.from_numpy(mb).to(dev))
        a, b = da.data, db.data
        a2m = torch.where(da.mask, (a * a).sum(-1), BIG).contiguous()
        b2m = torch.where(db.mask, (b * b).sum(-1), BIG).contiguous()
        ref = match_pair_plain(da, db)
        for mode in ("exact", "fast"):
            fast = mode == "fast"
            got = k2.match_pair_fused(da, db, precision=mode)
            # The matcher's decisions (valid, and idx where valid).
            agree = ((got.valid == ref.valid)
                     & (~ref.valid | (got.idx == ref.idx))).float().mean().item()
            both = got.valid & ref.valid
            err = (got.dist - ref.dist)[both].abs().max().item() if both.any() else 0.0
            ki1, kd1, kd2, knnb = k2.distance_topk(a, b, b2m, a2m, fast=fast)
            pi1, pd1, pd2, pnnb = k2.distance_topk_plain(a, b, b2m, a2m, fast=fast)
            raw = dict(idx1=(ki1 == pi1).float().mean().item(),
                       nnb=(knnb[db.mask] == pnnb[db.mask]).float().mean().item(),
                       d1=(kd1 - pd1).abs().max().item(), d2=(kd2 - pd2).abs().max().item())
            ms = cuda_ms(lambda: k2.distance_topk(a, b, b2m, a2m, fast=fast))
            plain_ms = cuda_ms(lambda: k2.distance_topk_plain(a, b, b2m, a2m, fast=fast))
            n_bytes = 4 * (n * 128 + m * 128 + n + m) + 4 * (3 * n + m)
            b_ms, b_by = bound(n_bytes, 2.0 * n * m * 128,
                               PEAK_BF16_FLOPS if fast else PEAK_FP32_FLOPS)
            d = dict(shape=[n, m, 128], mode=mode, decision_agreement=agree,
                     n_valid=int(ref.valid.sum()), max_abs_err=err, raw=raw, ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            details.append(d)
            log("K2", json.dumps(d))
            if mode == "exact" and agree != 1.0:
                raise AssertionError(f"K2 exact decisions differ at {n}x{m}: {agree}")
            if mode == "fast" and agree < 0.99:
                raise AssertionError(f"K2 fast agreement {agree} < 0.99 at {n}x{m}")
            if mode == "exact" and m == 8192:
                entry = dict(max_abs_err=max(err, raw["d1"], raw["d2"]), ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None)
    return entry, details


def _window_union_bytes(stack, lyx, P):
    """Bytes of the stack that the clamped windows of ``lyx`` cover: each
    such element is read once and no other element need be."""
    import torch

    L, H, W = stack.shape
    lv = lyx[:, 0].clamp(0, L - 1).long()
    y = lyx[:, 1].clamp(0, H - P).long()
    x = lyx[:, 2].clamp(0, W - P).long()
    r = torch.arange(P, device=stack.device)
    flat = ((lv[:, None, None] * H + y[:, None, None] + r[:, None]) * W
            + x[:, None, None] + r)
    touched = torch.zeros(L * H * W, dtype=torch.bool, device=stack.device)
    touched[flat.reshape(-1)] = True
    return 4 * int(touched.sum())


def check_k3(rng):
    """K3 at SIFT's orientation and descriptor patch shapes on a 640x480
    frame (octave 0, 2048 keypoints); outputs must be bit-equal."""
    import torch

    from fastmatch_tpu_torch.kernels import patch_gather as k3

    dev = torch.device("cuda")
    details, entry = [], None
    # (what, L, H, W, P): the orientation stack is padded by R+1 = 9 and
    # cut 19x19 patches; the descriptor stack is padded by 2 and cut 88x88.
    for what, L, H, W, P in (("orientation", 6, 498, 658, 19),
                             ("descriptor", 6, 484, 644, 88)):
        K = 2048
        stack = torch.rand((L, H, W), device=dev)
        lyx = torch.stack([torch.randint(1, 4, (K,), device=dev),
                           torch.randint(-4, H - P + 4, (K,), device=dev),
                           torch.randint(-4, W - P + 4, (K,), device=dev)], 1)
        lyx = lyx.to(torch.int32).contiguous()
        got = k3.gather_patches(stack, lyx, P)
        ref = k3.gather_patches_plain(stack, lyx, P)
        equal = bool(torch.equal(got, ref))
        ms = cuda_ms(lambda: k3.gather_patches(stack, lyx, P))
        plain_ms = cuda_ms(lambda: k3.gather_patches_plain(stack, lyx, P))
        b_ms, b_by = bound(4 * K * P * P + _window_union_bytes(stack, lyx, P) + 12 * K)
        d = dict(what=what, stack=[L, H, W], K=K, P=P, bit_equal=equal, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        details.append(d)
        log("K3", json.dumps(d))
        if not equal:
            raise AssertionError(f"K3 {what} patches differ from the plain version")
        if what == "descriptor":
            entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    return entry, details


def check_k4(rng):
    """K4 at the BA shapes of the smoke map's last solve (17788 live
    observations, the table compacted to them): point-keyed over 8192
    segments and camera-keyed over 64 (sorted once, as ba/schur.py does).
    Relative error <= 1e-5 against the plain version; two runs bit-equal."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.kernels import segment_ops as k4

    dev = torch.device("cuda")
    details, entry = [], None
    O = 17788
    for what, n_seg, n_used, D in (("point", 8192, 5025, 9), ("camera", 64, 50, 36)):
        keys = np.sort(rng.integers(0, n_used, O)).astype(np.int32)
        seg = torch.from_numpy(keys).to(dev)
        vals = torch.randn((O, D), device=dev)
        got = k4.sorted_segment_sum(vals, seg, n_seg)
        again = k4.sorted_segment_sum(vals, seg, n_seg)
        ref = k4.segment_sum_plain(vals, seg, n_seg)
        scale = ref.abs().max().clamp(min=1e-30)
        rel = ((got - ref).abs().max() / scale).item()
        same = bool(torch.equal(got, again))
        lengths = torch.bincount(seg.long(), minlength=n_seg)
        ms = cuda_ms(lambda: k4.sorted_segment_sum(vals, seg, n_seg))
        plain_ms = cuda_ms(lambda: k4.segment_sum_plain(vals, seg, n_seg))
        library_ms = cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths))
        b_ms, b_by = bound(4 * (O * D + O + n_seg * D), O * D)
        d = dict(what=what, rows=O, cols=D, segments=n_seg, rel_err=rel,
                 max_abs_err=(got - ref).abs().max().item(), bit_identical_runs=same,
                 ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                 bound_by=b_by)
        details.append(d)
        log("K4", json.dumps(d))
        if rel > 1e-5 or not same:
            raise AssertionError(f"K4 {what}: rel err {rel}, bit-identical runs {same}")
        if what == "point":
            entry = dict(max_abs_err=d["max_abs_err"], ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    return entry, details


# -- phases 4 and 5: reconstruct ---------------------------------------------------


def small_reference():
    """reconstruct on the card and on the CPU from the synthetic features of
    the JAX package's ATE test (10 frames, 300 points): both must reach its
    gate (ATE < 0.05, all 10 frames)."""
    import numpy as np

    from synth import SyntheticScene, random_descriptors
    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.pipeline.config import BAConfig, MapConfig, PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import reconstruct
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    rng = np.random.default_rng(0)
    scene = SyntheticScene(rng, n_points=300, n_frames=10)
    base = random_descriptors(rng, 300)
    feats = []
    for f in range(10):
        vis = np.where(scene.visible[f])[0]
        xy = np.zeros((512, 2), np.float32)
        desc = np.zeros((512, 128), np.float32)
        mask = np.zeros(512, bool)
        d = np.abs(base[vis] + 0.05 * rng.standard_normal((len(vis), 128)))
        xy[:len(vis)] = scene.pixels[f, vis] + 0.3 * rng.standard_normal((len(vis), 2))
        desc[:len(vis)] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[:len(vis)] = True
        feats.append((xy, desc, mask))
    cfg = PipelineConfig(ba=BAConfig(interval=4, max_iters=10, pcg_iters=30),
                         map=MapConfig(max_frames=16, max_points=2048, max_obs=16384))
    gt = -np.einsum("fji,fj->fi", scene.R, scene.t)
    out = {}
    for dev in ("cuda", "cpu"):
        rec = reconstruct(feats, Pinhole.from_K(scene.K), cfg, device=dev)
        out[dev] = dict(n_frames=rec.n_frames, n_points=int(rec.pt_mask.sum()),
                        ate=float(ate_rmse(rec.camera_centers(), gt[:rec.n_frames])))
    log("small_reference", json.dumps(out))
    for dev, r in out.items():
        if r["n_frames"] != 10 or not r["ate"] < 0.05:
            raise AssertionError(f"small reference on {dev}: {r}")


def main_path():
    """reconstruct(images=...) on the smoke scene at the default config."""
    import numpy as np
    import torch

    from fastmatch_tpu_torch.core.camera import Pinhole
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.kernels import patch_gather as k3
    from fastmatch_tpu_torch.kernels import segment_ops as k4
    from fastmatch_tpu_torch.pipeline.config import PipelineConfig
    from fastmatch_tpu_torch.pipeline.reconstruct import reconstruct
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    t0 = time.perf_counter()
    scene, views = render_smoke_scene()
    log(f"rendered {len(views)} frames in {time.perf_counter() - t0:.1f} s")
    wrappers = {"distance_topk": k2.distance_topk, "gather_patches": k3.gather_patches,
                "sorted_segment_sum": k4.sorted_segment_sum}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rec = reconstruct(None, Pinhole.from_K(scene.K), PipelineConfig(), images=views,
                      device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    n = rec.n_frames
    centers = rec.camera_centers()
    gt = -np.einsum("fji,fj->fi", scene.R[:n], scene.t[:n])
    ate = float(ate_rmse(centers, gt))
    pts = rec.points[rec.pt_mask]
    stats = dict(scene=SMOKE_SCENE, frames=len(views), frames_reconstructed=n,
                 seconds=secs, frames_per_s=n / secs, stage_seconds=rec.stage_seconds,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(), ate=ate,
                 n_points=int(pts.shape[0]), n_obs=rec.n_obs, launches=launches)
    log("main_path", json.dumps(stats))
    if n != len(views) or not np.isfinite(centers).all() or not np.isfinite(pts).all():
        raise AssertionError(f"main path: {n}/{len(views)} frames, or non-finite output")
    if not ate < ATE_GATE:
        raise AssertionError(f"main path ATE {ate} >= {ATE_GATE}")
    for k, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np

    import fastmatch_tpu_torch  # noqa: F401  (sets the float32 matmul pin)
    from fastmatch_tpu_torch.kernels import _build

    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

    build_s = _build.build_all()
    log(f"kernels built in {build_s:.1f} s")
    for name in _build.SOURCES:
        log(f"ptxas {name}: " + " | ".join(
            line.strip() for line in _build.ptxas_report(name).splitlines()
            if "registers" in line or "spill" in line))

    rng = np.random.default_rng(0)
    entries = {}
    details = {}
    for name, fn in (("distance_topk", check_k2), ("gather_patches", check_k3),
                     ("sorted_segment_sum", check_k4)):
        entries[name], details[name] = fn(rng)

    small_reference()
    launches = main_path()

    meta = {
        "distance_topk": ("src/fastmatch_tpu_torch/csrc/distance_topk.cu",
                          "src/fastmatch_tpu/kernels/distance_topk.py:164"),
        "gather_patches": ("src/fastmatch_tpu_torch/csrc/patch_gather.cu",
                           "src/fastmatch_tpu/kernels/patch_gather.py:117"),
        "sorted_segment_sum": ("src/fastmatch_tpu_torch/csrc/segment_sum.cu",
                               "src/fastmatch_tpu/kernels/segment_ops.py:133"),
    }
    kernels = []
    for name, e in entries.items():
        source, replaces = meta[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **e))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_details.json"), "w") as fh:
        json.dump(dict(kernels=kernels, checks=details, nvidia_smi=smi), fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
