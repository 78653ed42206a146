"""The port's multi-rank SLAM (``dist/pipeline.slam_distributed``) on
tests/test_dist_pipeline.py's 26-frame CircleScene (``dist_fixtures``), on
two gloo ranks and at world size 1 (a bank of one rank: the card's
configuration; its full-window solves without the covisibility
partition, which the two ranks run), beside the port's ``slam_device``
and the JAX package's ``slam_distributed`` (its recorded figures,
``dist_fixtures.JAX``):

- every frame tracked, at least one loop and one PGO run, ATE < 0.25;
- frame sequence and loop edges equal to ``slam_device``'s, camera
  centres within 2e-2 of it;
- the frame sequence and loop count of the JAX package's run, centres
  within 2e-2 of its after a sim(3) alignment (the two packages'
  bootstraps draw differently, which moves the gauge and the scale);
- at two ranks: every rank's result the same bits; the overlapped and the
  serial schedules (the latter with the watchdog armed) bit-identical; a run resumed from a snapshot, on
  features whose first 15 frames are destroyed, bit-identical to the
  uninterrupted run, where a run from scratch on those features fails.

The ranks are spawned once (``dist_ranks.pipeline_cases``); the ``slow``
test re-derives ``dist_fixtures.JAX`` from the JAX package live.
"""

import numpy as np
import pytest
import torch

import dist_fixtures as fx
import dist_ranks

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline.slam_device import slam_device
from fastmatch_tpu_torch.utils.evaluation import align_umeyama

torch.set_num_threads(1)

WORLDS = (2, 1)


def _compute(ckpt_root):
    jobs = {w: dist_ranks.Ranks(dist_ranks.pipeline_cases, w, str(ckpt_root / f"snap{w}"))
            for w in WORLDS}
    # The single-device reference runs here while the ranks run.
    scene, feats = fx.scene_and_features()
    cfg, scfg = fx.configs("fastmatch_tpu_torch")
    ref = fx.summary(slam_device(feats, Pinhole.from_K(scene.K), cfg, scfg, device="cpu"),
                     scene)
    return {"device": ref, **{w: job.results() for w, job in jobs.items()}}


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_pipeline")
    return dist_ranks.once(request, tmp_path_factory, "torch_dist_pipeline",
                           lambda: _compute(root))


@pytest.mark.parametrize("world", WORLDS)
def test_completes_with_loops_and_ate(runs, world):
    out = runs[world][0]["overlap"]
    assert out["frame_seq"] == list(range(26))
    assert len(out["loop_edges"]) >= 1 and out["pgo_runs"] >= 1
    assert out["ate"] < 0.25


@pytest.mark.parametrize("world", WORLDS)
def test_matches_single_device_trajectory(runs, world):
    """Identical decisions (the ring is bit-equal to the in-step match),
    poses within the distributed BA's tolerance (sum order)."""
    out, ref = runs[world][0]["overlap"], runs["device"]
    assert out["frame_seq"] == ref["frame_seq"]
    assert out["loop_edges"] == ref["loop_edges"]
    np.testing.assert_allclose(out["centers"], ref["centers"], atol=2e-2)


@pytest.mark.parametrize("world", WORLDS)
def test_matches_jax_distributed(runs, world):
    out, jax = runs[world][0]["overlap"], fx.JAX
    assert out["frame_seq"] == jax["frame_seq"]
    assert len(out["loop_edges"]) == len(jax["loop_edges"])
    s, R, t = align_umeyama(torch.tensor(out["centers"]), torch.tensor(jax["centers"]))
    aligned = (s * torch.tensor(out["centers"], dtype=torch.float32) @ R.T + t).numpy()
    np.testing.assert_allclose(aligned, jax["centers"], atol=2e-2)


def test_every_rank_holds_the_same_bits(runs):
    a, b = runs[2]
    for run in ("overlap", "serial", "resumed"):
        for k in ("R", "t", "points"):
            np.testing.assert_array_equal(a[run][k], b[run][k], err_msg=f"{run} {k}")
        assert a[run]["frame_seq"] == b[run]["frame_seq"]


def test_overlap_equals_serial_bitwise(runs):
    """Overlapped (prefetched ring retrieval) and serial (fused in-step
    retrieval) schedules are bit-identical: the ring matcher is bit-equal
    to the in-step match and the prefetch sees the same bank."""
    over, serial = runs[2][0]["overlap"], runs[2][0]["serial"]
    assert serial["frame_seq"] == over["frame_seq"]
    assert serial["loop_edges"] == over["loop_edges"]
    for k in ("R", "t", "points"):
        np.testing.assert_array_equal(serial[k], over[k], err_msg=k)


def test_resume_is_load_bearing_and_deterministic(runs):
    """Snapshot mid-run (every 10 frames), resume on a feature list whose
    early frames are destroyed — only the restored map can carry it — and
    require the uninterrupted run's bits; a from-scratch run on the same
    list cannot even bootstrap."""
    got = runs[2][0]
    full, resumed = got["overlap"], got["resumed"]
    assert got["scratch_error"] is not None
    for k in ("R", "t", "points"):
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)
    assert resumed["frame_seq"] == full["frame_seq"]
    assert resumed["ate"] < 0.25


@pytest.mark.slow
def test_jax_figures_live():
    """``dist_fixtures.JAX`` re-derived from the JAX package (~5 min)."""
    import jax

    if len(jax.devices()) < fx.N_BANK:
        pytest.skip(f"needs {fx.N_BANK} CPU devices")
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parent.parent / "tools" / "jax_dist_reference.py"
    spec = importlib.util.spec_from_file_location("jax_dist_reference", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    live = tool.reference()
    for k in ("frame_seq", "loop_edges", "pgo_runs"):
        assert live[k] == fx.JAX[k], k
    np.testing.assert_allclose(live["centers"], fx.JAX["centers"], atol=1e-5)
