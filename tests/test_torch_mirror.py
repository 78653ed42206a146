"""The port's mirror matcher (fastmatch_tpu_torch.matching.mirror, CPU)
beside the JAX package's ``match_pair_mirror`` on tests/test_mirror.py's
fixtures: decisions (valid, and idx where valid) identical, distances
within 1e-6, at several ``tau``; the brute-force numpy oracle of
tests/test_mirror.py holds for the port too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fastmatch_tpu.core.containers import Descriptors as JD
from fastmatch_tpu.matching.mirror import match_pair_mirror as jmirror
from test_mirror import _mirror_oracle, _unit

from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.matching.mirror import match_pair_mirror

torch.set_num_threads(1)


def _correlated(seed, n=96, m=80):
    rng = np.random.default_rng(seed)
    a = _unit(rng, n)
    b = a[rng.permutation(n)[:m]] + 0.05 * rng.standard_normal((m, 128)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ma, mb = np.ones(n, bool), np.ones(m, bool)
    ma[-7:] = False
    mb[-5:] = False
    return a, b, ma, mb


def _dup_in_b(seed, n=64):
    rng = np.random.default_rng(seed)
    a = _unit(rng, n)
    b = a + 0.02 * rng.standard_normal((n, 128)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    b[-1] = b[0] + 1e-4 * rng.standard_normal(128).astype(np.float32)
    b[-1] /= np.linalg.norm(b[-1])
    return a, b, np.ones(n, bool), np.ones(n, bool)


def _dup_in_a(seed, n=48):
    rng = np.random.default_rng(seed)
    a = _unit(rng, n)
    a[1] = a[0] + 1e-3 * rng.standard_normal(128).astype(np.float32)
    a[1] /= np.linalg.norm(a[1])
    b = a + 0.02 * rng.standard_normal((n, 128)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return a, b, np.ones(n, bool), np.ones(n, bool)


def _all_masked(seed):
    a = _unit(np.random.default_rng(seed), 8)
    return a, a.copy(), np.zeros(8, bool), np.ones(8, bool)


@pytest.mark.parametrize("make,seed", [(_correlated, 0), (_dup_in_b, 1), (_dup_in_a, 2),
                                       (_all_masked, 3)])
@pytest.mark.parametrize("tau", [1.0, 0.7, 1.3, 100.0])
def test_decisions_match_jax(make, seed, tau):
    a, b, ma, mb = make(seed)
    ref = jmirror(JD(jnp.asarray(a), jnp.asarray(ma)), JD(jnp.asarray(b), jnp.asarray(mb)),
                  tau=tau)
    got = match_pair_mirror(Descriptors(torch.from_numpy(a), torch.from_numpy(ma)),
                            Descriptors(torch.from_numpy(b), torch.from_numpy(mb)), tau=tau,
                            device="cpu")
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx.numpy()[v], np.asarray(ref.idx)[v])
    np.testing.assert_allclose(got.dist.numpy()[v], np.asarray(ref.dist)[v], atol=1e-6)
    if tau == 1.0:
        want = _mirror_oracle(a, b, ma, mb)
        assert {int(i): int(got.idx[i]) for i in np.flatnonzero(v)} == want
