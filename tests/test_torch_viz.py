"""The port's figures (``fastmatch_tpu_torch/utils/viz.py``): tests/test_viz.py's
three tests on the port, on the CPU, with the JAX package's outputs beside
them where they are numbers (the drawn and correct match counts, the
trajectory plot's ATE). matplotlib renders on the host with the Agg
backend; where it is missing, each test is skipped with that reason, and
the missing-package error is checked instead."""

import os

import numpy as np
import pytest
import torch

from fastmatch_tpu_torch.utils import viz

torch.set_num_threads(1)



@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_draw_matches_with_gt_coloring(rng, tmp_path):
    pytest.importorskip("matplotlib", reason="matplotlib is not installed")
    from fastmatch_tpu.utils.viz import draw_matches as jdraw

    h, w, n = 120, 160, 40
    img_a = rng.random((h, w)).astype(np.float32)
    img_b = rng.random((h, w)).astype(np.float32)
    xy_a = rng.uniform([0, 0], [w - 1, h - 1], (n, 2)).astype(np.float32)
    H = np.array([[1.0, 0, 5.0], [0, 1.0, -3.0], [0, 0, 1.0]])
    xy_b = xy_a + [5.0, -3.0]
    idx = np.arange(n)
    valid = np.ones(n, bool)
    valid[::5] = False
    idx[1] = 2
    idx[2] = 1
    path = str(tmp_path / "m.png")
    n_drawn, n_correct = viz.draw_matches(img_a, xy_a, img_b, xy_b, idx, valid, path,
                                          H_ab=H, tol=2.0)
    assert os.path.getsize(path) > 2000
    assert n_drawn == int(valid.sum())
    assert 0 < n_correct < n_drawn  # the two swapped matches are wrong
    ref = jdraw(img_a, xy_a, img_b, xy_b, idx, valid, str(tmp_path / "j.png"), H_ab=H, tol=2.0)
    assert (n_drawn, n_correct) == ref
    path2 = str(tmp_path / "m2.png")
    n2, nc2 = viz.draw_matches(img_a, xy_a, img_b, xy_b, idx, valid, path2)
    assert os.path.getsize(path2) > 2000 and nc2 is None and n2 == n_drawn


def test_plot_trajectory_reports_ate(rng, tmp_path):
    pytest.importorskip("matplotlib", reason="matplotlib is not installed")
    from fastmatch_tpu.utils.viz import plot_trajectory as jplot

    t = np.linspace(0, 2 * np.pi, 30)
    gt = np.stack([np.cos(t), 0.1 * t, np.sin(t)], 1)
    ang = 0.7
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    est = 2.0 * gt @ R.T + [1.0, -2.0, 3.0] + 0.01 * rng.standard_normal(gt.shape)
    path = str(tmp_path / "traj.png")
    ate = viz.plot_trajectory(est, path, gt_centers=gt)
    assert os.path.getsize(path) > 2000
    assert ate < 0.05, f"aligned ATE {ate}"
    assert ate == pytest.approx(jplot(est, str(tmp_path / "j.png"), gt_centers=gt), rel=1e-4)
    mask = np.arange(30) % 3 != 0
    ate_m = viz.plot_trajectory(est, str(tmp_path / "m.png"), gt_centers=gt, frame_mask=mask)
    assert ate_m == pytest.approx(jplot(est, str(tmp_path / "jm.png"), gt_centers=gt,
                                        frame_mask=mask), rel=1e-4)
    assert viz.plot_trajectory(est, str(tmp_path / "t2.png")) is None


def test_evaluate_pairs_plot_dir(tmp_path):
    pytest.importorskip("matplotlib", reason="matplotlib is not installed")
    from fastmatch_tpu_torch.datasets import evaluate_pairs, synthesize_warped_pair
    from fastmatch_tpu_torch.features.sift import SIFTConfig

    pairs = [synthesize_warped_pair(0, h=160, w=160)]
    results, agg = evaluate_pairs(pairs, sift_cfg=SIFTConfig(capacity=256),
                                  plot_dir=str(tmp_path), device="cpu")
    files = sorted(os.listdir(tmp_path))
    assert "summary.png" in files
    assert any(f.endswith(".png") and f != "summary.png" for f in files)
    assert os.path.getsize(tmp_path / "summary.png") > 2000
    viz.plot_match_stats(results, str(tmp_path / "again.png"))
    assert os.path.getsize(tmp_path / "again.png") > 2000
    # Without plot_dir nothing is written and the numbers are the same.
    plain, agg2 = evaluate_pairs(pairs, sift_cfg=SIFTConfig(capacity=256), device="cpu")
    assert plain == results and agg2 == agg


def test_missing_matplotlib_names_the_package(monkeypatch):
    """Where matplotlib is missing, a figure raises an ImportError naming
    the package and the CLI options that need it."""
    import builtins

    real_import = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib.*slam --plot.*evaluate --plot-dir"):
        viz.plot_trajectory(np.zeros((3, 3)), "never.png")
