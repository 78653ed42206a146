"""Map export: PLY point clouds, KITTI trajectories and COLMAP text models.

Port of ``fastmatch_tpu/utils/export.py``: host-side numpy writers of the
formats downstream tools read (PLY for every 3D viewer, the KITTI odometry
format for trajectory evaluation, COLMAP's cameras.txt/images.txt/
points3D.txt for SfM interchange), and readers of the first two. No device
work; the bytes written equal the JAX package's for the same map.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fastmatch_tpu_torch.core.camera import project_pixels


def save_ply(path: str, points: np.ndarray, colors: np.ndarray = None,
             normals: np.ndarray = None) -> None:
    """Write an ASCII PLY point cloud. ``colors``: optional (N, 3) uint8;
    ``normals``: optional (N, 3) float."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = None if colors is None else np.asarray(colors, np.uint8)
    nrm = None if normals is None else np.asarray(normals, np.float64)
    if nrm is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
    if cols is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("\n".join(props) + "\n")
        f.write("end_header\n")
        for i in range(n):
            row = [f"{v:.6g}" for v in pts[i]]
            if nrm is not None:
                row += [f"{v:.6g}" for v in nrm[i]]
            if cols is not None:
                row += [str(int(v)) for v in cols[i]]
            f.write(" ".join(row) + "\n")


def load_ply(path: str):
    """Read back an ASCII PLY written by save_ply (tests/tooling).
    Returns (points, colors_or_None)."""
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "ply"
    n = 0
    props = []
    for i, ln in enumerate(lines):
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
        elif ln.startswith("property"):
            props.append(ln.split()[-1])
        elif ln == "end_header":
            body = lines[i + 1 : i + 1 + n]
            break
    vals = np.array([ln.split() for ln in body], dtype=np.float64)
    cols = None
    if "red" in props:
        c0 = props.index("red")
        cols = vals[:, c0 : c0 + 3].astype(np.uint8)
    return vals[:, :3], cols


def save_kitti_trajectory(path: str, rec) -> None:
    """KITTI odometry format: one row per live frame, the 3x4
    camera-to-world matrix [R_wc | C] flattened row-major — the format the
    KITTI devkit and most odometry-evaluation tools ingest. (Our poses are
    world->camera; inverted here.)"""
    with open(path, "w") as f:
        for fi in np.nonzero(rec.pose_mask)[0]:
            Rwc = rec.R[fi].T
            C = -Rwc @ rec.t[fi]
            M = np.concatenate([Rwc, C[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")


def load_kitti_trajectory(path: str):
    """Read back a KITTI trajectory: returns (R_wc (N,3,3), centers (N,3))."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    return rows[:, :, :3], rows[:, :, 3]


def _rot_to_qvec(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> COLMAP (w, x, y, z) quaternion (world->camera,
    same convention as our poses). Shepperd's branch-stable method."""
    m = R
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def _project(xn: np.ndarray, vec: np.ndarray, model: str) -> np.ndarray:
    """Normalized coordinates -> pixels in float32 on the CPU
    (``core.camera.project_pixels``)."""
    return project_pixels(torch.from_numpy(np.asarray(xn, np.float32)),
                          torch.from_numpy(vec.astype(np.float32)), model).numpy()


def save_colmap_text(out_dir: str, rec, camera,
                     image_size=(640, 480)) -> None:
    """Write a COLMAP sparse text model (cameras.txt, images.txt,
    points3D.txt) from a Reconstruction.

    - cameras.txt: one shared camera. Model OPENCV (fx fy cx cy k1 k2 p1
      p2) for pinhole/Brown-Conrady, OPENCV_FISHEYE (fx fy cx cy k1 k2 k3
      k4) for fisheye (k3 of the polynomial is dropped for plain OPENCV —
      COLMAP's OPENCV model has no k3).
    - images.txt: world->camera quaternion + translation per live frame;
      the observation list per image with its point3D ids (2D coordinates
      are the stored observations denormalized through the camera).
    - points3D.txt: xyz + track (image_id, point2D_idx) entries; error
      column is the mean reprojection error of the track in pixels.

    COLMAP ids are 1-based; ours are 0-based (id + 1 throughout).
    """
    os.makedirs(out_dir, exist_ok=True)
    model = getattr(camera, "model", "pinhole")
    vec = np.asarray(camera.intrinsics_vector(), np.float64)
    w, h = int(image_size[0]), int(image_size[1])

    if model == "fisheye":
        cam_model, params = "OPENCV_FISHEYE", [*vec[:4], *vec[4:8]]
    else:
        # OPENCV: fx fy cx cy k1 k2 p1 p2  (no k3 slot)
        cam_model, params = "OPENCV", [*vec[:4], vec[4], vec[5],
                                       vec[7], vec[8]]
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        f.write(f"1 {cam_model} {w} {h} "
                + " ".join(f"{p:.10g}" for p in params) + "\n")

    live_obs = np.nonzero(rec.obs_mask)[0]
    oc = rec.obs_cam[live_obs]
    op = rec.obs_pt[live_obs]
    # Stored observations are normalized; denormalize for the 2D columns.
    uv_px = _project(rec.obs_uv[live_obs], vec, model)

    # Per-image observation lists, remembering each row's slot (COLMAP
    # points3D tracks reference (image_id, point2D_idx)).
    frames = np.nonzero(rec.pose_mask)[0]
    slot_of = np.full(live_obs.shape[0], -1, np.int64)
    per_image = {int(fi): [] for fi in frames}
    for k in range(live_obs.shape[0]):
        fi = int(oc[k])
        slot_of[k] = len(per_image[fi])
        per_image[fi].append(k)

    # Mean reprojection error per point (for the error column).
    Xc = np.einsum("oij,oj->oi", rec.R[oc], rec.points[op]) + rec.t[oc]
    z = np.clip(Xc[:, 2:3], 1e-9, None)
    reproj = _project(Xc[:, :2] / z, vec, model)
    err = np.linalg.norm(reproj - uv_px, axis=1)

    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID "
                "NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for fi in frames:
            q = _rot_to_qvec(rec.R[fi])
            t = rec.t[fi]
            f.write(f"{fi + 1} " + " ".join(f"{v:.10g}" for v in q) + " "
                    + " ".join(f"{v:.10g}" for v in t)
                    + f" 1 frame{fi:06d}.png\n")
            row = []
            for k in per_image[int(fi)]:
                row.append(f"{uv_px[k, 0]:.4f} {uv_px[k, 1]:.4f} "
                           f"{int(op[k]) + 1}")
            f.write(" ".join(row) + "\n")

    pts = np.nonzero(rec.pt_mask)[0]
    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pi in pts:
            rows = np.nonzero(op == pi)[0]
            track = " ".join(f"{int(oc[k]) + 1} {int(slot_of[k])}"
                             for k in rows)
            e = float(err[rows].mean()) if rows.size else 0.0
            x, y, zz = rec.points[pi]
            f.write(f"{pi + 1} {x:.10g} {y:.10g} {zz:.10g} "
                    f"128 128 128 {e:.6g} {track}\n")
