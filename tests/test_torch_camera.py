"""The port's camera models (fastmatch_tpu_torch, CPU) against the JAX
package's: both models' project and unproject round trips, ``K`` and
``intrinsics_vector``, ``normalize_pixels`` / ``project_pixels`` over the
packed vector, and ``normalize_np``'s dispatch on ``cam.model``.

Tolerances, with reasons: the projections are the same float32 formulas
(1e-4 px, a few ulps at 640 px); the round trips invert the distortion by
fixed-count iterations, held to the JAX package's own bounds (1e-5
normalized units for Brown-Conrady, 1e-4 for the fisheye at 75 degrees);
``normalize_np`` iterates in float64 on both sides (1e-9).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core import camera as jcam

from fastmatch_tpu_torch.core import camera as tcam

torch.set_num_threads(1)

RADTAN = dict(k1=-0.28, k2=0.07, k3=-0.01, p1=0.0005, p2=-0.0008)
FISH = dict(k1=-0.05, k2=0.008, k3=-0.002, k4=0.0003)


def _cams(model):
    if model == "pinhole":
        kw = dict(fx=500.0, fy=480.0, cx=320.0, cy=240.0, **RADTAN)
        return tcam.Pinhole(**kw), jcam.Pinhole(**kw)
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, **FISH)
    return tcam.Fisheye(**kw), jcam.Fisheye(**kw)


def _cam_points(rng, n=300, max_tan=0.6):
    xn = rng.uniform(-max_tan, max_tan, (n, 2))
    z = rng.uniform(1.0, 6.0, (n, 1))
    return np.concatenate([xn * z, z], axis=1).astype(np.float32)


@pytest.mark.parametrize("model,max_tan,tol", [("pinhole", 0.6, 1e-5), ("fisheye", 3.7, 1e-4)])
def test_project_unproject(model, max_tan, tol):
    rng = np.random.default_rng(0)
    cam, jc = _cams(model)
    pts = _cam_points(rng, max_tan=max_tan)
    pix = cam.project(torch.from_numpy(pts))
    jpix = np.asarray(jc.project(jnp.asarray(pts)))
    np.testing.assert_allclose(pix.numpy(), jpix, atol=1e-4, rtol=1e-6)
    rays = cam.unproject(pix).numpy()
    np.testing.assert_allclose(rays, np.asarray(jc.unproject(jnp.asarray(jpix))), atol=tol)
    assert np.abs(rays[:, :2] - pts[:, :2] / pts[:, 2:3]).max() < tol
    np.testing.assert_allclose(cam.K().numpy(), np.asarray(jc.K()), atol=0)
    np.testing.assert_array_equal(cam.intrinsics_vector(), jc.intrinsics_vector())
    assert cam.model == jc.model == model


def test_fisheye_is_equidistant_and_finite_at_centre():
    cam = tcam.Fisheye(fx=400.0, fy=400.0, cx=0.0, cy=0.0)
    pix = cam.project(torch.tensor([[1.0, 0.0, 1.0]]))
    assert abs(float(pix[0, 0]) - 400.0 * np.pi / 4) < 1e-3
    cam = tcam.Fisheye(fx=400.0, fy=400.0, cx=320.0, cy=240.0, **FISH)
    rays = cam.unproject(torch.tensor([[320.0, 240.0]]))
    assert torch.isfinite(rays).all() and abs(float(rays[0, 0])) < 1e-6


@pytest.mark.parametrize("model", ["pinhole", "fisheye"])
def test_normalize_and_project_pixels(model):
    rng = np.random.default_rng(1)
    cam, jc = _cams(model)
    pix = np.stack([rng.uniform(0, 640, 200), rng.uniform(0, 480, 200)], 1).astype(np.float32)
    vec = cam.intrinsics_vector()
    xn = tcam.normalize_pixels(torch.from_numpy(pix), torch.from_numpy(vec), model)
    jxn = np.asarray(jcam.normalize_pixels(jnp.asarray(pix), jnp.asarray(vec), model))
    np.testing.assert_allclose(xn.numpy(), jxn, atol=2e-6)
    back = tcam.project_pixels(xn, torch.from_numpy(vec), model)
    jback = np.asarray(jcam.project_pixels(jnp.asarray(jxn), jnp.asarray(vec), model))
    np.testing.assert_allclose(back.numpy(), jback, atol=1e-3)
    np.testing.assert_allclose(back.numpy(), pix, atol=2e-2)
    # The host mirror dispatches on cam.model, as the JAX package's does.
    host = tcam.normalize_np(pix.astype(np.float64), cam)
    np.testing.assert_allclose(host, jcam.normalize_np(pix.astype(np.float64), jc), atol=1e-9)
    np.testing.assert_allclose(host, xn.numpy(), atol=2e-5)


def test_normalize_dispatch_and_unknown_model():
    pix = np.array([[100.0, 50.0], [600.0, 400.0]])
    K = np.array([[450.0, 0, 320.0], [0, 450.0, 240.0], [0, 0, 1]])
    for dist in ((), (-0.2, 0.05)):
        p, jp = tcam.Pinhole.from_K(K, dist), jcam.Pinhole.from_K(jnp.asarray(K), dist)
        f, jf = tcam.Fisheye.from_K(K, dist), jcam.Fisheye.from_K(jnp.asarray(K), dist)
        np.testing.assert_allclose(tcam.normalize_np(pix, p), jcam.normalize_np(pix, jp),
                                   atol=1e-9)
        np.testing.assert_allclose(tcam.normalize_np(pix, f), jcam.normalize_np(pix, jf),
                                   atol=1e-9)
    # The two models differ off the centre even undistorted.
    assert np.abs(tcam.normalize_np(pix, tcam.Fisheye.from_K(K))
                  - tcam.normalize_np(pix, tcam.Pinhole.from_K(K))).max() > 1e-2

    class Odd(tcam.Pinhole):
        model = "orthographic"

    with pytest.raises(ValueError, match="unknown camera model"):
        tcam.normalize_np(pix, Odd(*tcam.Pinhole.from_K(K)))
    with pytest.raises(ValueError, match="unknown camera model"):
        tcam.normalize_pixels(torch.zeros(1, 2), torch.ones(9), "orthographic")
