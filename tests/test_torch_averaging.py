"""The port's rotation and translation averaging
(``fastmatch_tpu_torch/geometry/averaging.py``) beside the JAX package's, on
the seeded synthetic view graphs of tests/test_global_sfm.py
(``_make_graph``: exact, noisy with outlier edges, noisier, and the
edge-filter graph), on the CPU.

- ``spanning_tree_rotations`` equal to the JAX package's bit for bit;
- averaged rotations within 1e-4 rad of the JAX package's on exact graphs
  and 1e-3 rad on noisy ones, and the JAX tests' own outcome gates;
- ``filter_edges_by_rotation``'s masks equal, but for edges whose JAX error
  lies within 1e-3 rad of the 0.09 rad threshold;
- unit-RMS centres within 1e-3 (exact) and 5e-3 (noisy) of the JAX
  package's, and the collapse guard;
- the key-set sums (every edge sum goes through K4) equal to an
  ``index_add_`` scatter within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmatch_tpu.geometry import averaging as javg
from fastmatch_tpu.utils.evaluation import ate_rmse as jate_rmse
from test_global_sfm import _make_graph, _rot_err_deg

from fastmatch_tpu_torch.geometry import averaging as tavg
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)

# The graphs of tests/test_global_sfm.py's tests, each from default_rng(0).
GRAPHS = {
    "exact": {},
    "noise_outliers": dict(rot_noise=0.01, out_frac=0.1),
    "noisier": dict(rot_noise=0.05),
    "edge_filter": dict(rot_noise=0.005, out_frac=0.15),
    "trans_noisy": dict(rot_noise=0.01, dir_noise=0.01, out_frac=0.1),
}
ROT_TOL = {"exact": 1e-4}           # rad; 1e-3 for the noisy graphs
CENTRE_TOL = {"exact": 1e-3}        # unit-RMS centres; 5e-3 for noisy graphs
FILTER_MARGIN = 1e-3                # rad around the 0.09 rad threshold


def _graph(name):
    return _make_graph(np.random.default_rng(0), **GRAPHS[name])


def _port(g):
    return tavg.ViewGraph(*(torch.from_numpy(np.array(x)) for x in g))


def _angles(Ra, Rb):
    """(F,) angle in rad between rotation stacks: 2 asin(|Ra - Rb|_F / sqrt(8)),
    well-conditioned near 0 (an arccos of the trace is not, at f32)."""
    diff = np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)
    return 2 * np.arcsin(np.clip(np.linalg.norm(diff, axis=(1, 2)) / np.sqrt(8), 0, 1))


@pytest.fixture(scope="module")
def rotations():
    """{name: (graph, R_gt, C_gt, R0, JAX rotations, port rotations)}."""
    out = {}
    for name in ("exact", "noise_outliers", "noisier", "edge_filter", "trans_noisy"):
        g, R_gt, C_gt = _graph(name)
        F = R_gt.shape[0]
        R0 = javg.spanning_tree_rotations(g.edge_i, g.edge_j, g.R_ij, g.weight, g.mask, F)
        Rj = np.asarray(javg.rotation_averaging(g, F, jnp.asarray(R0)))
        Rt = tavg.rotation_averaging(_port(g), F, torch.from_numpy(R0)).numpy()
        out[name] = (g, R_gt, C_gt, R0, Rj, Rt)
    return out


@pytest.mark.parametrize("name", ["exact", "noise_outliers", "edge_filter"])
def test_spanning_tree_bit_equal(name):
    g, R_gt, _ = _graph(name)
    F = R_gt.shape[0]
    ref = javg.spanning_tree_rotations(g.edge_i, g.edge_j, g.R_ij, g.weight, g.mask, F)
    pg = _port(g)
    got = tavg.spanning_tree_rotations(pg.edge_i, pg.edge_j, pg.R_ij, pg.weight, pg.mask, F)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("name", ["exact", "noise_outliers", "noisier", "edge_filter"])
def test_rotation_averaging_parity(rotations, name):
    g, R_gt, _, R0, Rj, Rt = rotations[name]
    err = _angles(Rt, Rj)
    assert err.max() < ROT_TOL.get(name, 1e-3), (name, err.max())
    # The JAX package's own outcome gates (tests/test_global_sfm.py) hold
    # for the port too.
    e_port = _rot_err_deg(Rt, R_gt)
    if name == "exact":
        assert e_port.max() < 0.1
    elif name == "noise_outliers":
        assert e_port.max() < 3.0
    elif name == "noisier":
        assert e_port.mean() < 0.7 * _rot_err_deg(np.asarray(R0), R_gt).mean()


def test_filter_edges_parity(rotations):
    g, R_gt, _, _, Rj, Rt = rotations["edge_filter"]
    kept_j = np.asarray(javg.filter_edges_by_rotation(g, jnp.asarray(Rj)).mask)
    kept_t = tavg.filter_edges_by_rotation(_port(g), torch.from_numpy(Rt)).mask.numpy()
    E = np.einsum("eab,ebc,edc->ead", np.asarray(g.R_ij), Rj[np.asarray(g.edge_i)],
                  Rj[np.asarray(g.edge_j)])
    err_j = np.linalg.norm(np.asarray(javg.SO3.log(jnp.asarray(E))), axis=-1)
    near = np.abs(err_j - 0.09) < FILTER_MARGIN
    assert np.array_equal(kept_t[~near], kept_j[~near])
    # tests/test_global_sfm.py's outcome: every outlier dropped, nearly all
    # inliers kept.
    Rij_gt = np.einsum("eab,ecb->eac", R_gt[np.asarray(g.edge_j)], R_gt[np.asarray(g.edge_i)])
    err = np.degrees(_angles(np.asarray(g.R_ij), Rij_gt))
    is_out = err > 10.0
    assert not kept_t[is_out].any()
    assert kept_t[~is_out].mean() > 0.9


def test_translation_exact_and_collapse_guard(rotations):
    g, R_gt, C_gt, *_ = rotations["exact"]
    F = C_gt.shape[0]
    Cj = np.asarray(javg.translation_averaging(g, jnp.asarray(R_gt), F))
    Ct = tavg.translation_averaging(_port(g), torch.from_numpy(R_gt.astype(np.float32)),
                                    F).numpy()
    assert np.abs(Ct - Cj).max() < CENTRE_TOL["exact"]
    assert float(ate_rmse(Ct, C_gt)) < 1e-3
    assert abs(float(ate_rmse(Ct, C_gt)) - float(jate_rmse(jnp.asarray(Cj),
                                                           jnp.asarray(C_gt)))) < 1e-3
    # The collapse guard: edge lengths follow the true ones.
    ei, ej = np.asarray(g.edge_i), np.asarray(g.edge_j)
    est_len = np.linalg.norm(Ct[ei] - Ct[ej], axis=-1)
    gt_len = np.linalg.norm(C_gt[ei] - C_gt[ej], axis=-1)
    assert np.corrcoef(est_len / est_len.mean(), gt_len / gt_len.mean())[0, 1] > 0.99


def test_translation_noisy_with_filter(rotations):
    g, R_gt, C_gt, _, Rj, Rt = rotations["trans_noisy"]
    F = C_gt.shape[0]
    gj = javg.filter_edges_by_rotation(g, jnp.asarray(Rj))
    Cj = np.asarray(javg.translation_averaging(gj, jnp.asarray(Rj), F))
    gt_ = tavg.filter_edges_by_rotation(_port(g), torch.from_numpy(Rt))
    Ct = tavg.translation_averaging(gt_, torch.from_numpy(Rt), F).numpy()
    assert np.abs(Ct - Cj).max() < 5e-3
    assert float(ate_rmse(Ct, C_gt)) < 0.3


def test_key_set_sums_match_index_add():
    g, R_gt, _ = _graph("noise_outliers")
    pg = _port(g)
    F = R_gt.shape[0]
    keys = tavg.edge_keys(pg, F)
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((len(g.edge_i), 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((len(g.edge_i), 3)).astype(np.float32))
    got = tavg._into_frames(keys, a, b)
    ref = torch.zeros(F, 3).index_add_(0, pg.edge_j.long(), a).index_add_(
        0, pg.edge_i.long(), b)
    assert torch.allclose(got, ref, rtol=0, atol=1e-6)
    # The (2E, 1) shape of the update mask's sum, and the mask itself.
    m = pg.mask.float()[:, None]
    touched = tavg._into_frames(keys, m, m)
    ref = torch.zeros(F, 1).index_add_(0, pg.edge_j.long(), m).index_add_(0, pg.edge_i.long(), m)
    assert torch.equal(touched, ref)
    upd = tavg._update_mask(pg, keys)
    assert upd[0, 0] == 0 and torch.equal(upd[1:], (ref[1:] > 0).float())
