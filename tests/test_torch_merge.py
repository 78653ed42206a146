"""The port's multi-session map merging (fastmatch_tpu_torch.pipeline.
merge, CPU) beside the JAX package's on tests/test_merge.py's two-map
fixture (maps built directly from a synthetic scene, map B pushed into its
own Sim(3) gauge of scale 1.7), carried across with ``interop``:

- ``n_localized`` and ``n_dedup`` equal to JAX's, the recovered scale
  within 1e-3 of JAX's, the joint BA's final cost within rtol 1e-4 of
  JAX's and its initial cost within 1e-2 (RANSAC's draws differ between
  the packages, and the initial cost follows the localized poses);
- the merged map against the scene as tests/test_merge.py holds it;
- too little overlap raises; ``rec_from_checkpoint`` reads a
  ``save_map`` directory at the saved capacities.
"""

import numpy as np
import pytest
import torch

from fastmatch_tpu.pipeline.merge import merge_maps as jmerge
from test_merge import two_maps  # noqa: F401  (module-scoped fixture)
from test_torch_localize import port_rec

from fastmatch_tpu_torch.pipeline import merge as tmerge

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def merged(two_maps):  # noqa: F811
    scene, _, rec_a, rec_b, gauge = two_maps
    ta, tb = port_rec(rec_a, scene), port_rec(rec_b, scene)
    ref = jmerge(rec_a, rec_b, seed=0)
    got = tmerge.merge_maps(ta, tb, seed=0)
    return dict(scene=scene, ta=ta, tb=tb, ref=ref, got=got, gauge=gauge)


def test_summary_matches_jax(merged):
    (_, ri), (_, gi) = merged["ref"], merged["got"]
    assert gi["n_localized"] == ri["n_localized"] and gi["of"] == ri["of"]
    assert gi["n_dedup"] == ri["n_dedup"] and gi["n_new_points"] == ri["n_new_points"]
    assert abs(gi["scale"] - ri["scale"]) < 1e-3
    np.testing.assert_allclose(gi["dedup_thr"], ri["dedup_thr"], rtol=1e-6)
    # The joint BA's final cost within rtol 1e-4 of JAX's; its initial cost
    # depends on the Sim(3) from the localized poses, whose RANSAC draws
    # differ (measured on this CPU: 0.0057820 against 0.0057921, 0.17%).
    np.testing.assert_allclose(gi["ba_cost"][1], ri["ba_cost"][1], rtol=1e-4)
    np.testing.assert_allclose(gi["ba_cost"][0], ri["ba_cost"][0], rtol=1e-2)
    assert gi["n_localized"] >= 0.6 * gi["of"] and gi["n_dedup"] > 100


def test_merged_map_is_consistent(merged):
    scene = merged["scene"]
    m, info = merged["got"]
    s0 = merged["gauge"][0]
    assert abs(info["scale"] - 1 / s0) < 0.02 * (1 / s0)
    assert info["align_rmse"] < 0.05
    live = m.pose_mask[:m.n_frames]
    assert live.all() and m.n_frames == 14 + 15
    # B's frames land on the scene's trajectory (A is ground truth).
    frames = np.concatenate([np.arange(0, 14), np.arange(9, 24)])
    c = -np.einsum("fji,fj->fi", m.R[:m.n_frames], m.t[:m.n_frames])
    c_gt = -np.einsum("fji,fj->fi", scene.R[frames], scene.t[frames])
    assert np.sqrt(np.mean(np.sum((c - c_gt) ** 2, -1))) < 0.05
    ref_m, _ = merged["ref"]
    assert m.n_points == ref_m.n_points and m.n_obs == ref_m.n_obs


def test_no_overlap_raises(merged):
    tb = merged["tb"]
    import copy

    far = copy.deepcopy(tb)
    far.pt_desc[:] = np.abs(np.random.default_rng(5).standard_normal(far.pt_desc.shape))
    far.pt_desc /= np.linalg.norm(far.pt_desc, axis=1, keepdims=True)
    with pytest.raises(ValueError, match="do not overlap"):
        tmerge.merge_maps(merged["ta"], far, refine=False)


def test_rec_from_checkpoint(merged, tmp_path):
    from fastmatch_tpu_torch.pipeline.checkpoint import save_map

    m, _ = merged["got"]
    save_map(m, str(tmp_path / "merged"))
    r = tmerge.rec_from_checkpoint(str(tmp_path / "merged"), m.camera, device="cpu")
    assert r.pose_mask.shape == m.pose_mask.shape and r.pt_desc.shape == m.pt_desc.shape
    for name in ("R", "t", "points", "obs_pt", "obs_uv"):
        np.testing.assert_array_equal(getattr(r, name), getattr(m, name))
