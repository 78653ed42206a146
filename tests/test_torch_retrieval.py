"""The port's keyframe retrieval and hierarchical localization
(fastmatch_tpu_torch.pipeline.retrieval, CPU) beside the JAX package's on
one map built directly from a tests/synth.py scene (test_torch_localize.
scene_map), the JAX package's vocabulary carried across:

- ``build_keyframe_db`` (both over one vocabulary trained on an
  independent sample) encoded in slabs of 5 frames equals the one-batch
  build bit for bit, its per-frame landmark lists equal JAX's, and its
  VLADs are within 1e-5 of JAX's;
- ``localize_hierarchical``: the retrieved keyframes, their landmark union
  and the match decisions on it equal JAX's; the pose is judged by outcome
  (centre within 0.1, rotation within 1.5 degrees), since RANSAC's draws
  differ between the packages;
- ``map_from_checkpoint`` reads a ``save_map`` directory.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fastmatch_tpu.core.containers import Descriptors as JD
from fastmatch_tpu.matching.matcher import match_pair as jmatch
from fastmatch_tpu.pipeline import retrieval as jret
from test_torch_localize import pose_err, query_view, same_decisions, scene_map

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.matching.matcher import match_pair
from fastmatch_tpu_torch.pipeline import retrieval as tret

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dbs():
    """Both DBs over one JAX vocabulary trained on an independent sample:
    here every frame sees most of the map, and a vocabulary trained on the
    map's own landmarks would leave each word's residual sum at rounding
    noise (centroid = mean of its members), which intra-normalization
    then scales up to unit length in either package."""
    import jax
    from fastmatch_tpu.matching.vlad import train_vocabulary
    from synth import random_descriptors

    scene, base, jrec, trec = scene_map()
    sample = random_descriptors(np.random.default_rng(9), 2048)
    jvocab = train_vocabulary(jax.random.PRNGKey(4), jnp.asarray(sample), jnp.ones(2048, bool),
                              n_words=16)
    jdb = jret.build_keyframe_db(jrec, vocab=jvocab)
    vocab = interop.vocabulary_from_numpy(jvocab, device="cpu")
    tdb = tret.build_keyframe_db(trec, vocab=vocab, slab=5, device="cpu")
    return dict(scene=scene, base=base, jrec=jrec, trec=trec, jdb=jdb, tdb=tdb, vocab=vocab)


def test_slabbed_db_equals_one_batch_and_jax(dbs):
    tdb, jdb = dbs["tdb"], dbs["jdb"]
    one = tret.build_keyframe_db(dbs["trec"], vocab=dbs["vocab"], slab=10 ** 6, device="cpu")
    assert torch.equal(tdb.vlads, one.vlads)
    np.testing.assert_array_equal(tdb.frame_pts, jdb.frame_pts)
    np.testing.assert_array_equal(tdb.frame_npts, jdb.frame_npts)
    np.testing.assert_array_equal(tdb.frame_mask.numpy(), np.asarray(jdb.frame_mask))
    np.testing.assert_allclose(tdb.vlads.numpy(), np.asarray(jdb.vlads), atol=1e-5)
    assert int(tdb.frame_mask.sum()) == 24


@pytest.mark.parametrize("f", [3, 12, 20])
def test_hierarchical_candidates_decisions_and_pose(dbs, f):
    xy, d, m = query_view(dbs["scene"], dbs["base"], f, seed=500 + f)
    _, jids = jret.query_frames(dbs["jdb"], d, m, topk=4)
    _, tids = tret.query_frames(dbs["tdb"], d, m, topk=4)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    cand, bank, bmask, _ = tret.candidate_bank(dbs["trec"], dbs["tdb"], tids.numpy())
    jframe = dbs["jdb"].frame_pts[np.asarray(jids)]
    np.testing.assert_array_equal(cand, np.unique(jframe[jframe >= 0]))
    ref = jmatch(JD(jnp.asarray(d), jnp.asarray(m)), JD(jnp.asarray(bank), jnp.asarray(bmask)),
                 ratio=0.8, cross_check=False)
    got = match_pair(Descriptors(torch.from_numpy(d), torch.from_numpy(m)),
                     Descriptors(torch.from_numpy(bank), torch.from_numpy(bmask)),
                     ratio=0.8, cross_check=False, device="cpu")
    assert same_decisions(got, ref) > 50
    cam = Pinhole.from_K(dbs["scene"].K.astype(np.float32))
    r = tret.localize_hierarchical(dbs["trec"], dbs["tdb"], xy, d, m, cam, topk=4)
    assert bool(r.ok) and int(r.n_matches) == int(np.asarray(ref.valid).sum())
    dc, ang = pose_err(dbs["scene"], f, r.R, r.t)
    assert dc < 0.1 and ang < 1.5, (dc, ang)


def test_map_from_checkpoint(dbs, tmp_path):
    from fastmatch_tpu_torch.pipeline.checkpoint import save_map

    save_map(dbs["trec"], str(tmp_path / "m"))
    md = tret.map_from_checkpoint(str(tmp_path / "m"))
    for name in ("points", "pt_mask", "pt_desc", "obs_cam", "obs_pt", "obs_mask", "pose_mask"):
        np.testing.assert_array_equal(getattr(md, name), getattr(dbs["trec"], name))
    db = tret.build_keyframe_db(md, vocab=dbs["vocab"], device="cpu")
    assert torch.equal(db.vlads, dbs["tdb"].vlads)
