"""The port's localization against a prebuilt map (fastmatch_tpu_torch.
pipeline.localize, CPU) beside the JAX package's on the same inputs.

The map is built directly from a tests/synth.py scene (tests/
test_merge.py's ``_rec_from_scene``: ground-truth poses and points, noisy
per-map descriptors), never by a SLAM run, and carried across with
``interop``; queries are fresh noisy re-observations of map frames.

- the exact/IVF switch at ``ann_threshold``, as the JAX package switches;
- the exact route's match decisions equal to JAX's ``match_pair(...,
  cross_check=False)``; the IVF route's equal to JAX's
  ``match_pair_ann_big`` on the JAX index carried across;
- poses pass tests/test_localize.py's gates (centre within 0.1, rotation
  within 1.5 degrees on the exact route; 0.15 and 2 degrees on IVF, at
  least 2 of 3); RANSAC's draws differ between the packages, so poses are
  judged by outcome;
- a garbage query fails closed; ``map_index_from_checkpoint`` round trip.

Also the helpers the other map-service files share (``scene_map``,
``query_view``, ``pose_err``).
"""

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.core.containers import Descriptors as JDescriptors
from fastmatch_tpu.pipeline import localize as jloc
from synth import SyntheticScene, random_descriptors
from test_merge import _rec_from_scene

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import localize as tloc

torch.set_num_threads(1)


# -- shared by the map-service test files -------------------------------------

def scene_map(n_points=400, n_frames=24, frames=None, seed=0):
    """(scene, base_desc, JAX Reconstruction, port Reconstruction on the
    CPU) of a synthetic scene's ground-truth map over ``frames``."""
    import jax.numpy as jnp  # noqa: F401  (the JAX side runs on the CPU)

    rng = np.random.default_rng(seed)
    scene = SyntheticScene(rng, n_points=n_points, n_frames=n_frames, span=1.2)
    base_desc = random_descriptors(rng, n_points)
    frames = np.arange(n_frames) if frames is None else frames
    jrec = _rec_from_scene(scene, frames, base_desc, JPinhole.from_K(scene.K.astype(np.float32)),
                           np.random.default_rng(seed + 1))
    trec = port_rec(jrec, scene)
    return scene, base_desc, jrec, trec


def port_rec(jrec, scene):
    return interop.reconstruction_from_numpy(interop.reconstruction_to_numpy(jrec),
                                             interop.config_from(jrec.cfg),
                                             Pinhole.from_K(scene.K.astype(np.float32)),
                                             device="cpu")


def query_view(scene, base_desc, f, seed, cap=512, desc_noise=0.03, px_noise=0.3):
    """(xy (cap, 2), desc (cap, 128), mask (cap,)) of frame f re-observed:
    the visible landmarks' pixels and descriptors with fresh noise."""
    rng = np.random.default_rng(seed)
    vis = np.flatnonzero(scene.visible[f])[:cap]
    xy = np.zeros((cap, 2), np.float32)
    d = np.zeros((cap, 128), np.float32)
    m = np.zeros(cap, bool)
    xy[:vis.size] = scene.pixels[f, vis] + px_noise * rng.standard_normal((vis.size, 2))
    dd = base_desc[vis] + desc_noise * rng.standard_normal((vis.size, 128)).astype(np.float32)
    d[:vis.size] = dd / np.linalg.norm(dd, axis=1, keepdims=True)
    m[:vis.size] = True
    return xy, d, m


def pose_err(scene, f, R, t):
    """(centre error, rotation error in degrees) against the scene's frame f."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    c = -R.T @ t
    c_gt = -scene.R[f].T @ scene.t[f]
    cosang = (np.trace(R @ scene.R[f].T) - 1) / 2
    return float(np.linalg.norm(c - c_gt)), float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))


def same_decisions(got, ref):
    gv, rv = got.valid.numpy(), np.asarray(ref.valid)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(got.idx.numpy()[gv], np.asarray(ref.idx)[rv])
    return int(gv.sum())


# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    scene, base_desc, jrec, trec = scene_map()
    cam = Pinhole.from_K(scene.K.astype(np.float32))
    jcam = JPinhole.from_K(scene.K.astype(np.float32))
    return dict(scene=scene, base=base_desc, jrec=jrec, trec=trec, cam=cam, jcam=jcam)


def _indexes(b, **kw):
    r = b["trec"]
    t = tloc.build_map_index(r.points, r.pt_desc, r.pt_mask, device="cpu", **kw)
    j = jloc.build_map_index(r.points, r.pt_desc, r.pt_mask, **kw)
    return t, j


def test_exact_ivf_switch(built):
    """IVF from ``ann_threshold`` rows on, in both packages; the default
    (100,000) keeps this 4,000-row-capacity map exact."""
    rows = built["trec"].pt_desc.shape[0]
    for thr, ivf in ((None, False), (rows + 1, False), (rows, True), (0, True)):
        t, j = _indexes(built, ann_threshold=thr)
        assert (t.ivf is not None) == ivf == (j.ivf is not None), thr
    assert tloc.ANN_CROSSOVER_ROWS == jloc.ANN_CROSSOVER_ROWS
    for rows in (2, 1000, 262_144, 4_000_000, 10 ** 9):
        n = tloc.default_n_clusters(rows)
        assert n == int(min(4096, max(64, 2 ** int(np.ceil(np.log2(rows ** 0.5))))))
    assert tloc.default_n_clusters(4_000_000) == 2048


def test_exact_route_decisions_and_pose(built):
    import jax.numpy as jnp
    from fastmatch_tpu.matching.matcher import match_pair as jmatch

    t, j = _indexes(built)
    for f in (5, 13):
        xy, d, m = query_view(built["scene"], built["base"], f, seed=100 + f)
        got = tloc.match_to_map(t, d, m)
        ref = jmatch(JDescriptors(jnp.asarray(d), jnp.asarray(m)), j.bank, ratio=0.8,
                     cross_check=False)
        assert same_decisions(got, ref) > 50
        r = tloc.localize(t, xy, d, m, built["cam"])
        assert bool(r.ok), int(r.n_matches)
        assert int(r.n_matches) == int(np.asarray(ref.valid).sum())
        dc, ang = pose_err(built["scene"], f, r.R, r.t)
        assert dc < 0.1 and ang < 1.5, (f, dc, ang)


def test_ivf_route_decisions_and_pose(built):
    """The JAX package's IVF index carried across: the port's shortlist
    search makes JAX's decisions; its poses pass test_localize.py's IVF
    gates on at least 2 of 3 frames."""
    import jax.numpy as jnp
    from fastmatch_tpu.matching.ann import match_pair_ann_big as jbig

    t, j = _indexes(built, ann_threshold=0)
    t = t._replace(ivf=interop.ivf_index_sorted_from_numpy(j.ivf, device="cpu"))
    ok = 0
    for f in (5, 13, 21):
        xy, d, m = query_view(built["scene"], built["base"], f, seed=200 + f)
        got = tloc.match_to_map(t, d, m, budget=1024)
        ref = jbig(JDescriptors(jnp.asarray(d), jnp.asarray(m)), j.ivf, budget=1024, n_probe=8,
                   ratio=0.8, cross_check=False)
        same_decisions(got, ref)
        r = tloc.localize(t, xy, d, m, built["cam"], budget=1024)
        if bool(r.ok):
            dc, ang = pose_err(built["scene"], f, r.R, r.t)
            assert dc < 0.15 and ang < 2.0, (f, dc, ang)
            ok += 1
    assert ok >= 2, ok


def test_garbage_query_fails_closed(built):
    t, _ = _indexes(built)
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 600, (512, 2)).astype(np.float32)
    d = np.abs(rng.standard_normal((512, 128))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    assert not bool(tloc.localize(t, xy, d, np.ones(512, bool), built["cam"]).ok)


def test_checkpoint_roundtrip(built, tmp_path):
    from fastmatch_tpu_torch.pipeline.checkpoint import save_map

    save_map(built["trec"], str(tmp_path / "map"))
    index = tloc.map_index_from_checkpoint(str(tmp_path / "map"), device="cpu")
    assert index.ivf is None
    np.testing.assert_array_equal(index.bank.data.numpy(), built["trec"].pt_desc)
    xy, d, m = query_view(built["scene"], built["base"], 8, seed=308)
    r = tloc.localize(index, xy, d, m, built["cam"])
    assert bool(r.ok)
