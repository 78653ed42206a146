"""The port's georegistration (fastmatch_tpu_torch.pipeline.georegister,
CPU) beside the JAX package's on tests/test_georegister.py's consistent
synthetic maps, carried across with ``interop``:

- ``apply_sim3`` within 1e-6 of JAX's (both in float64 on the host);
- ``georegister`` (trimmed Umeyama, PGO with position priors, anchored BA)
  with its summary's scale, RMSE after alignment and final RMSE within
  1e-4 relative of JAX's (plus 2e-6 absolute: the summaries round to
  1e-6), with clean fixes and with a gross outlier under
  the robust prior kernel, and tests/test_georegister.py's error gates;
- fewer than 3 fixes raise; ``align_umeyama``'s mask and ``with_scale``
  as the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fastmatch_tpu.pipeline import georegister as jgeo
from fastmatch_tpu.utils.evaluation import align_umeyama as jalign
from test_georegister import _centers, _consistent_rec, _rand_rot

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import georegister as tgeo
from fastmatch_tpu_torch.utils.evaluation import align_umeyama

torch.set_num_threads(1)
RTOL = 1e-4


def _port(jrec, scene):
    return interop.reconstruction_from_numpy(interop.reconstruction_to_numpy(jrec),
                                             interop.config_from(jrec.cfg),
                                             Pinhole.from_K(scene.K), device="cpu")


def test_apply_sim3_matches_jax():
    rng = np.random.default_rng(0)
    jrec, _, scene, _ = _consistent_rec(rng)
    trec = _port(jrec, scene)
    s, R, t = 2.3, _rand_rot(rng), np.array([4.0, -1.0, 7.0])
    jgeo.apply_sim3(jrec, s, R, t)
    tgeo.apply_sim3(trec, s, R, t)
    for name in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(trec, name), getattr(jrec, name), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["clean", "outlier"])
def test_georegister_matches_jax(case):
    rng = np.random.default_rng(1 if case == "clean" else 2)
    jrec, _, scene, jcfg = _consistent_rec(rng)
    gt = _centers(jrec).copy()
    if case == "clean":
        jgeo.apply_sim3(jrec, 0.37, _rand_rot(rng), np.array([5.0, 2.0, -3.0]))
        idx = np.arange(0, jrec.n_frames, 3)
        gps = gt[idx] + 0.002 * rng.standard_normal((len(idx), 3))
        kw = {}
    else:
        jgeo.apply_sim3(jrec, 0.8, _rand_rot(rng), np.array([1.0, 0.0, 2.0]))
        idx = np.arange(0, jrec.n_frames, 2)
        gps = gt[idx].astype(np.float64)
        gps[2] += [4.0, -4.0, 3.0]
        kw = dict(prior_delta=0.25)
    trec = _port(jrec, scene)
    ref = jgeo.georegister(jrec, idx, gps, jcfg, **kw)
    got = tgeo.georegister(trec, idx, gps, interop.config_from(jcfg), **kw)
    assert got["n_gps"] == ref["n_gps"]
    for key in ("scale", "rmse_aligned", "rmse_final"):
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=2e-6, err_msg=key)
    err = np.sqrt(np.mean(np.sum((_centers(trec) - gt) ** 2, -1)))
    assert err < (0.02 if case == "clean" else 0.25), err


def test_needs_three_fixes():
    rng = np.random.default_rng(3)
    jrec, _, scene, jcfg = _consistent_rec(rng)
    trec = _port(jrec, scene)
    with pytest.raises(ValueError, match=">= 3 GPS"):
        tgeo.georegister(trec, [0, 5], _centers(jrec)[[0, 5]], interop.config_from(jcfg))


def test_align_umeyama_mask_and_scale():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((20, 3)).astype(np.float32)
    Y = (1.7 * X @ _rand_rot(rng).T + 0.3).astype(np.float32)
    Y[3] += 5.0
    mask = np.ones(20, bool)
    mask[3] = False
    for m in (None, mask):
        for with_scale in (True, False):
            js, jR, jt = jalign(jnp.asarray(X), jnp.asarray(Y),
                                mask=None if m is None else jnp.asarray(m), with_scale=with_scale)
            ts, tR, tt = align_umeyama(torch.from_numpy(X), torch.from_numpy(Y),
                                       mask=None if m is None else torch.from_numpy(m),
                                       with_scale=with_scale)
            np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
            np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    s, _, _ = align_umeyama(torch.from_numpy(X), torch.from_numpy(Y), mask=torch.from_numpy(mask))
    assert abs(float(s) - 1.7) < 1e-4
