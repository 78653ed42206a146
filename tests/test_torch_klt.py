"""The port's KLT tracker (fastmatch_tpu_torch/features/klt.py, CPU)
against the JAX package's, on the same numpy images.

Tolerances: pyramids within 1e-6 (the same shift-and-add blur); Shi-Tomasi
keypoints identical (positions and mask; scores within 1e-4 relative: XLA's
CPU cumsum is a parallel prefix, PyTorch's a running sum, and the min-eig
response cancels; measured 6.1e-5);
K3's plain version at KLT's patch sets bit-equal to the JAX kernel in
interpret mode and to the JAX package's ``dynamic_slice`` path; tracks of a
rendered pair: status equal on >= 0.99 of the slots and positions within
1e-3 px on the slots live in both (the LK products sum in another order in
each framework).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.features import klt as jklt
from fastmatch_tpu.features.sift import _extract_patches
from fastmatch_tpu.kernels.patch_gather import gather_patches as j_gather
from synth import SyntheticScene, render_blob_image, render_scene_views

from fastmatch_tpu_torch.features import klt as tklt
from fastmatch_tpu_torch.kernels import patch_gather as k3

torch.set_num_threads(1)

SIZE = (320, 240)
CAP = 512


def _images():
    rng = np.random.default_rng(0)
    blob = render_blob_image(rng, (256, 256), 60)
    rng = np.random.default_rng(3)
    scene = SyntheticScene(rng, n_points=220, n_frames=24, image_size=SIZE)
    f0, f1 = render_scene_views(scene, rng, image_size=SIZE, frames=[0, 1])
    return blob, f0, f1


BLOB, F0, F1 = _images()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's corners, pyramids and tracks of the rendered pair."""
    kps = jklt.shi_tomasi(jnp.asarray(F0), capacity=CAP)
    pyr0 = jklt.build_pyramid(jnp.asarray(F0))
    pyr1 = jklt.build_pyramid(jnp.asarray(F1))
    new, st, err = jklt.track_pyramids(pyr0, pyr1, kps.xy, kps.mask, jklt.KLTConfig())
    return dict(xy=np.asarray(kps.xy), mask=np.asarray(kps.mask),
                score=np.asarray(kps.score), pyr0=[np.asarray(p) for p in pyr0],
                pyr1=[np.asarray(p) for p in pyr1], new=np.asarray(new),
                status=np.asarray(st), err=np.asarray(err))


def test_build_pyramid(jax_run):
    tp = tklt.build_pyramid(F0, device="cpu")
    assert [tuple(p.shape) for p in tp] == [(240, 320), (120, 160), (60, 80)]
    assert all(p.is_contiguous() for p in tp)
    for t, j in zip(tp, jax_run["pyr0"]):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["blob", "frame"])
def test_shi_tomasi_identical(name, jax_run):
    img = BLOB if name == "blob" else F0
    if name == "blob":
        j = jklt.shi_tomasi(jnp.asarray(img), capacity=CAP)
        jxy, jm, js = np.asarray(j.xy), np.asarray(j.mask), np.asarray(j.score)
    else:
        jxy, jm, js = jax_run["xy"], jax_run["mask"], jax_run["score"]
    t = tklt.shi_tomasi(img, capacity=CAP, device="cpu")
    assert jm.sum() > 50
    np.testing.assert_array_equal(t.mask.numpy(), jm)
    np.testing.assert_array_equal(t.xy.numpy(), jxy)
    np.testing.assert_allclose(t.score.numpy(), js, rtol=1e-4, atol=1e-12)
    # A non-default NMS radius (the JAX package's guard for min_dist) too.
    j5 = jklt.shi_tomasi(jnp.asarray(img), capacity=CAP, min_dist=5)
    t5 = tklt.shi_tomasi(img, capacity=CAP, min_dist=5, device="cpu")
    np.testing.assert_array_equal(t5.xy.numpy(), np.asarray(j5.xy))


def test_k3_plain_at_klt_sets_vs_jax_kernel(jax_run):
    """Each level's template (16 px) and target (32 px) set, at the starts
    KLT computes for the rendered pair's corners, through K3's plain version
    against the JAX kernel (interpret mode) and ``_extract_patches``."""
    cfg = jklt.KLTConfig()
    pts = torch.from_numpy(jax_run["xy"].copy())
    for l, (j0, j1) in enumerate(zip(jax_run["pyr0"], jax_run["pyr1"])):
        H, W = j0.shape
        PT, PB = tklt._patch_sides(cfg, (H, W))
        assert (PT, PB) == (16, 32)
        ptl = pts * (0.5 ** l)
        shift = torch.tensor([3.7, -2.2]) * (0.5 ** l)
        for stack, P, c in ((j0, PT, ptl), (j1, PB, ptl + shift)):
            lyx = tklt._lyx(tklt._starts(c[:, 1], P, H), tklt._starts(c[:, 0], P, W))
            got = k3.gather_patch_sets_plain([k3.PatchSet(torch.from_numpy(stack.copy())[None], lyx,
                                                          P, 0)])[0].numpy()
            jl = jnp.asarray(lyx.numpy())
            ref = np.asarray(j_gather(jnp.asarray(stack)[None], jl, P, interpret=True))
            ds = np.asarray(_extract_patches(jnp.asarray(stack)[None], jl[:, 0], jl[:, 1],
                                             jl[:, 2], P))
            assert got.shape == (CAP, P, P)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, ds)


def test_track_pyramids_vs_jax(jax_run, monkeypatch):
    calls = []
    real = tklt.gather_patch_sets

    def counting(sets):
        calls.append([(s.patch, tuple(s.stack.shape)) for s in sets])
        return real(sets)

    monkeypatch.setattr(tklt, "gather_patch_sets", counting)
    p0 = tklt.build_pyramid(F0, device="cpu")
    p1 = tklt.build_pyramid(F1, device="cpu")
    new, st, err = tklt.track_pyramids(p0, p1, torch.from_numpy(jax_run["xy"]),
                                       torch.from_numpy(jax_run["mask"]), device="cpu")
    # One call for every level's templates, then one a level for the targets.
    assert len(calls) == 1 + 3
    assert calls[0] == [(16, (1, 60, 80)), (16, (1, 120, 160)), (16, (1, 240, 320))]
    assert [c[0][0] for c in calls[1:]] == [32, 32, 32]
    st, jst = st.numpy(), jax_run["status"]
    assert jst.sum() > 150
    assert (st == jst).mean() >= 0.99
    both = st & jst
    assert np.abs(new.numpy()[both] - jax_run["new"][both]).max() <= 1e-3
    assert np.abs(err.numpy()[both] - jax_run["err"][both]).max() <= 1e-4


def test_coarse_level_shrink():
    """A 48x64 image: level 2 is 12x16, so both patches shrink to 8 px."""
    rng = np.random.default_rng(5)
    img0 = render_blob_image(rng, (64, 48), 12)
    img1 = np.roll(img0, (1, 2), axis=(0, 1))
    pts = np.array([[20.0, 20.0], [30.0, 24.0], [40.0, 18.0], [25.0, 30.0]], np.float32)
    mask = np.ones(4, bool)
    assert tklt._patch_sides(tklt.KLTConfig(), (12, 16)) == (8, 8)
    jn, js, je = jklt.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                            jnp.asarray(mask))
    tn, ts, te = tklt.track(img0, img1, pts, mask, device="cpu")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-3, rtol=0)


def test_track_pair_vs_jax():
    j0, j1, jst, _ = jklt.track_pair(jnp.asarray(F0), jnp.asarray(F1), capacity=256)
    t0, t1, tst, _ = tklt.track_pair(F0, F1, capacity=256, device="cpu")
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    tst, jst = tst.numpy(), np.asarray(jst)
    assert (tst == jst).mean() >= 0.99
    both = tst & jst
    assert both.sum() > 100
    assert np.abs(t1.numpy()[both] - np.asarray(j1)[both]).max() <= 1e-3


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tklt.shi_tomasi(F0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tklt.track_pair(F0, F1)
