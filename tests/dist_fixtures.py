"""Shared fixtures of the port's distributed-SLAM tests and the JAX
package's figures on them.

The scene is tests/test_dist_pipeline.py's: tests/test_slam.py's 26-frame
``CircleScene`` (seed 0, 300 points) and its features. The JAX package's
SLAM engine compiles for minutes on its first run, which no tier-1 test
file can afford, so the port's tests hold the port against ``JAX``: the JAX
package's ``slam_distributed`` on a 2-device CPU mesh (``bank=2``), printed
by ``python tools/jax_dist_reference.py``. A ``slow`` test
(tests/test_torch_dist_pipeline.py) re-derives the figures live.
"""

from __future__ import annotations

import importlib

import numpy as np

from test_slam import CircleScene, features_of

# tests/test_dist_pipeline.py's configuration.
CFG = dict(ba=dict(interval=5, max_iters=8, pcg_iters=30),
           map=dict(max_frames=32, max_points=4096, max_obs=32768))
SCFG = dict(window=6, loop_gap=10, loop_min_votes=20)
N_BANK = 2


def scene_and_features():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    return scene, features_of(rng, scene)


def configs(pkg: str):
    """(PipelineConfig, SlamConfig) of package ``pkg``."""
    c = importlib.import_module(f"{pkg}.pipeline.config")
    s = importlib.import_module(f"{pkg}.pipeline.slam")
    return (c.PipelineConfig(ba=c.BAConfig(**CFG["ba"]), map=c.MapConfig(**CFG["map"])),
            s.SlamConfig(**SCFG))


def gt_centers(scene, frame_seq):
    return -np.einsum("fji,fj->fi", scene.R, scene.t)[np.asarray(frame_seq)]


def summary(out, scene) -> dict:
    """The figures the tests compare, of a SlamResult of either package."""
    from fastmatch_tpu_torch.utils.evaluation import ate_rmse

    centers = np.asarray(out.rec.camera_centers(), np.float64)
    return dict(frame_seq=[int(f) for f in out.frame_seq],
                loop_edges=[[int(e[0]), int(e[1])] for e in out.loop_edges],
                pgo_runs=int(out.pgo_runs),
                ate=float(ate_rmse(centers, gt_centers(scene, out.frame_seq))),
                centers=centers.tolist())


# python tools/jax_dist_reference.py
JAX = dict(
    frame_seq=[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25],
    loop_edges=[[10, 0], [20, 3]],
    pgo_runs=2,
    ate=0.00442500738427043,
    n_bank=2,
    device='cpu (JAX reference)',
    centers=[
        [-0.0, -0.0, -0.0],
        [-0.9891849160194397, -0.09280730038881302, 0.12349139899015427],
        [-1.9052716493606567, -0.16375182569026947, 0.4730159044265747],
        [-2.7141940593719482, -0.2014578878879547, 1.0341989994049072],
        [-3.364251136779785, -0.1913907527923584, 1.7713812589645386],
        [-3.821493625640869, -0.13715945184230804, 2.6423487663269043],
        [-4.052673816680908, -0.05026673153042793, 3.60031795501709],
        [-4.051077365875244, 0.04852180555462837, 4.582348823547363],
        [-3.8148200511932373, 0.13459278643131256, 5.541049957275391],
        [-3.3548617362976074, 0.1884080320596695, 6.409743785858154],
        [-2.702718734741211, 0.20000958442687988, 7.144038677215576],
        [-1.8918262720108032, 0.164777472615242, 7.701683044433594],
        [-0.9703254699707031, 0.09243959188461304, 8.051233291625977],
        [0.005312612745910883, -0.0023873993195593357, 8.168353080749512],
        [0.9857101440429688, -0.09640830755233765, 8.046438217163086],
        [1.9060943126678467, -0.17065812647342682, 7.694612503051758],
        [2.711848020553589, -0.20655512809753418, 7.139475345611572],
        [3.363494396209717, -0.19198277592658997, 6.396730422973633],
        [3.8193535804748535, -0.13578198850154877, 5.523872375488281],
        [4.05472469329834, -0.053199972957372665, 4.57021427154541],
        [4.051249980926514, 0.045396558940410614, 3.5863606929779053],
        [3.815951347351074, 0.13375747203826904, 2.6323134899139404],
        [3.3587074279785156, 0.19377951323986053, 1.76084566116333],
        [2.7027766704559326, 0.20457282662391663, 1.0241155624389648],
        [1.8945341110229492, 0.16882550716400146, 0.4655163288116455],
        [0.9717282652854919, 0.09886574000120163, 0.11633646488189697],
    ],
)
