"""The port's trajectory metrics (``fastmatch_tpu_torch/utils/evaluation.py``)
beside the JAX package's on seeded camera centres, on the CPU: ``ate_rmse``
with and without ``mask`` (a third of the rows masked out, and made
outliers, so the mask changes the answer) within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmatch_tpu.utils.evaluation import ate_rmse as jate_rmse

from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)


def _centres(seed, n=30):
    """(est, gt, mask): est a similarity of gt plus noise, its masked rows
    thrown far off."""
    rng = np.random.default_rng(seed)
    gt = rng.standard_normal((n, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    R = q * np.sign(np.linalg.det(q))
    est = 0.6 * gt @ R.T + np.array([0.3, -1.0, 2.0]) + 0.02 * rng.standard_normal((n, 3))
    mask = np.ones(n, bool)
    mask[rng.permutation(n)[:n // 3]] = False
    est[~mask] += 3.0 * rng.standard_normal((int((~mask).sum()), 3))
    return est.astype(np.float32), gt, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ate_rmse_mask_equals_jax(seed):
    est, gt, mask = _centres(seed)
    got = float(ate_rmse(torch.from_numpy(est), torch.from_numpy(gt),
                         mask=torch.from_numpy(mask)))
    want = float(jate_rmse(jnp.asarray(est), jnp.asarray(gt), mask=jnp.asarray(mask)))
    assert abs(got - want) <= 1e-6
    full = float(ate_rmse(torch.from_numpy(est), torch.from_numpy(gt)))
    assert abs(full - float(jate_rmse(jnp.asarray(est), jnp.asarray(gt)))) <= 1e-6
    assert got < 0.1 < full  # the mask leaves out the outliers
