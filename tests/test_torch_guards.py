"""The port's runtime guards (``utils/guards.py``) under FASTMATCH_CHECKIFY,
beside the JAX package's checkify guards on the same inputs: an
out-of-range index in BA's observation table raises before any launch, a
NaN raises at the first operator that makes one (in the matcher, in BA,
and under ``debug_nans`` alone), an infinite output raises, clean inputs
pass, and with
the flag unset the wrapped functions are the functions themselves and the
results do not change.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core.containers import Descriptors as JDescriptors
from fastmatch_tpu.matching.matcher import match_pair as j_match_pair
from fastmatch_tpu.utils import guards as jguards

from fastmatch_tpu_torch.ba.lm import ba_solve
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.interop import ba_problem_from_numpy
from fastmatch_tpu_torch.matching.matcher import match_pair
from fastmatch_tpu_torch.utils import guards

from test_torch_ba import problem_arrays

torch.set_num_threads(1)


def _descs(rng, cap, n_valid, nan=False):
    d = np.abs(rng.standard_normal((cap, 128))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = np.arange(cap) < n_valid
    d[~mask] = 0.0
    if nan:
        d[3, 5] = np.nan
    return d, mask


def test_flag_and_passthrough(monkeypatch):
    def f(x):
        return x + 1

    monkeypatch.setenv("FASTMATCH_CHECKIFY", "0")
    assert guards.maybe_checked(f) is f and jguards.maybe_checked(f) is f
    monkeypatch.setenv("FASTMATCH_CHECKIFY", "1")
    g = guards.maybe_checked(f)
    assert g is not f and float(g(torch.tensor(1.0))) == 2.0


def test_index_out_of_range_raises(monkeypatch):
    fn = guards.checked(lambda x, i: x[i], bounds=lambda x, i: [("i", i, x.shape[0])])
    x = torch.arange(4.0)
    assert float(fn(x, torch.tensor(3))) == 3.0
    with pytest.raises(IndexError, match="out-of-bounds"):
        fn(x, torch.tensor(7))
    jfn = jguards.checked(lambda x, i: x[i])
    with pytest.raises(Exception, match="out-of-bounds|index"):
        jfn(jnp.arange(4.0), jnp.int32(7))
    # BA: a point index past the table raises before the solve.
    monkeypatch.setenv("FASTMATCH_CHECKIFY", "1")
    arrays = list(problem_arrays(seed=1, n_frames=4, n_points=40, cap_obs=256))
    pt_idx = arrays[4].copy()
    pt_idx[7] = 40
    arrays[4] = pt_idx
    with pytest.raises(IndexError, match="obs.pt_idx"):
        ba_solve(ba_problem_from_numpy(*arrays, device="cpu"), device="cpu", max_iters=2)


def test_nan_raises(monkeypatch):
    rng = np.random.default_rng(0)
    da, ma = _descs(rng, 64, 48, nan=True)
    db, mb = _descs(rng, 64, 48)
    monkeypatch.setenv("FASTMATCH_CHECKIFY", "1")
    with pytest.raises(FloatingPointError, match="NaN produced by aten"):
        match_pair(Descriptors(torch.from_numpy(da), torch.from_numpy(ma)),
                   Descriptors(torch.from_numpy(db), torch.from_numpy(mb)), device="cpu")
    # The JAX package's checkify flags the same NaN.
    with pytest.raises(Exception):
        j_match_pair(JDescriptors(jnp.asarray(da), jnp.asarray(ma)),
                     JDescriptors(jnp.asarray(db), jnp.asarray(mb)), backend="jnp")
    arrays = list(problem_arrays(seed=1, n_frames=4, n_points=40, cap_obs=256))
    uv = arrays[5].copy()
    uv[2, 0] = np.nan
    arrays[5] = uv
    with pytest.raises(FloatingPointError, match="NaN produced by aten"):
        ba_solve(ba_problem_from_numpy(*arrays, device="cpu"), device="cpu", max_iters=2)
    with pytest.raises(FloatingPointError, match="aten.log"):
        with guards.debug_nans():
            torch.log(torch.tensor(-1.0))
    torch.log(torch.tensor(-1.0))  # the mode ends with its scope
    inf = guards.checked(lambda x: x / 0.0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        inf(torch.ones(3))


@pytest.mark.parametrize("flag", ["0", "1"])
def test_clean_inputs_unchanged(monkeypatch, flag):
    """Clean inputs pass the checks, and the results are the same with and
    without the flag (and match the JAX package's decisions)."""
    monkeypatch.setenv("FASTMATCH_CHECKIFY", flag)
    rng = np.random.default_rng(1)
    da, ma = _descs(rng, 128, 64)
    db, mb = _descs(rng, 128, 2)   # an adversarial, nearly dead bank
    m = match_pair(Descriptors(torch.from_numpy(da), torch.from_numpy(ma)),
                   Descriptors(torch.from_numpy(db), torch.from_numpy(mb)), device="cpu")
    jm = j_match_pair(JDescriptors(jnp.asarray(da), jnp.asarray(ma)),
                      JDescriptors(jnp.asarray(db), jnp.asarray(mb)), backend="jnp")
    np.testing.assert_array_equal(m.valid.numpy(), np.asarray(jm.valid))
    assert (m.idx[m.valid] < 2).all()
    arrays = problem_arrays(seed=2, n_frames=4, n_points=40, cap_obs=256)
    res = ba_solve(ba_problem_from_numpy(*arrays, device="cpu"), device="cpu", max_iters=3,
                   pcg_iters=10)
    assert np.isfinite(float(res.cost)) and float(res.cost) < float(res.cost0)
    if flag == "1":
        monkeypatch.setenv("FASTMATCH_CHECKIFY", "0")
        again = ba_solve(ba_problem_from_numpy(*arrays, device="cpu"), device="cpu",
                         max_iters=3, pcg_iters=10)
        assert torch.equal(res.points, again.points) and torch.equal(res.cost, again.cost)
