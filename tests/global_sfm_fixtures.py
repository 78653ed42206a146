"""The global-SfM fixture of the port's tests and the JAX package's figures on it.

tests/test_global_sfm.py's ``test_sequence_ate``: 10 frames of a
300-point ``SyntheticScene`` from ``default_rng(0)``, features fabricated by
``synthetic_features(noise_px=0.3, shuffle=True)`` (keypoint order permuted
per frame, so a wrong match index shows), window 6. The JAX package's
``global_reconstruct`` takes ~90 s on it on an 8-core CPU, more than a
tier-1 test file can spend, so the port's tests hold the port against
``JAX``, printed by ``python tools/jax_global_reference.py --fixtures``,
and a ``slow`` test re-derives it live.
"""

from __future__ import annotations

import functools

import numpy as np

from synth import SyntheticScene
from test_pipeline import synthetic_features

WINDOW = 6
CFG = dict(ba=dict(max_iters=15, pcg_iters=30),
           map=dict(max_frames=16, max_points=2048, max_obs=16384))


def pipeline_config(pkg):
    """``pkg.pipeline.config.PipelineConfig`` of the fixture."""
    import importlib

    c = importlib.import_module(f"{pkg}.pipeline.config")
    return c.PipelineConfig(ba=c.BAConfig(**CFG["ba"]), map=c.MapConfig(**CFG["map"]))


@functools.cache
def scene_and_features():
    rng = np.random.default_rng(0)
    scene = SyntheticScene(rng, n_points=300, n_frames=10)
    return scene, synthetic_features(rng, scene, noise_px=0.3, shuffle=True)


def gt_centers(scene):
    return -np.einsum("fji,fj->fi", scene.R, scene.t)


def rotvec(R) -> np.ndarray:
    """(E, 3) axis-angle of (E, 3, 3) rotations (float64, host)."""
    R = np.asarray(R, np.float64)
    w = 0.5 * np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                        R[:, 1, 0] - R[:, 0, 1]], -1)
    s = np.linalg.norm(w, axis=-1, keepdims=True)
    c = (np.trace(R, axis1=1, axis2=2)[:, None] - 1) / 2
    theta = np.arctan2(s, c)
    return w * np.where(s > 1e-12, theta / np.maximum(s, 1e-12), 1.0)


def summary(rec, graph, ate) -> dict:
    """The figures a run is judged on: the view graph's edges and relative
    rotations, frames, ATE, BA costs, points and observations."""
    st = rec.frame_stats[-1]
    return dict(
        edges=[[int(i), int(j)] for i, j in zip(np.asarray(graph.edge_i),
                                                 np.asarray(graph.edge_j))],
        rotvec=np.round(rotvec(graph.R_ij), 7).tolist(),
        n_frames=int(rec.n_frames), ate=float(ate), ba_cost0=float(st["ba_cost0"]),
        ba_cost=float(st["ba_cost"]), n_points=int(rec.n_points), n_obs=int(rec.n_obs))


# python tools/jax_global_reference.py --fixtures (~90 s on an 8-core CPU)
JAX = {'ate': 0.0021561882458627224,
 'ba_cost': 0.0007219167891889811,
 'ba_cost0': 0.012586269527673721,
 'edges': [[0, 1], [0, 2], [0, 3], [0, 4], [0, 5], [0, 6], [1, 2], [1, 3], [1, 4], [1, 5], [1, 6],
           [1, 7], [2, 3], [2, 4], [2, 5], [2, 6], [2, 7], [2, 8], [3, 4], [3, 5], [3, 6], [3, 7],
           [3, 8], [3, 9], [4, 5], [4, 6], [4, 7], [4, 8], [4, 9], [5, 6], [5, 7], [5, 8], [5, 9],
           [6, 7], [6, 8], [6, 9], [7, 8], [7, 9], [8, 9]],
 'n_frames': 10,
 'n_obs': 2459,
 'n_points': 312,
 'rotvec': [[0.0107354, -0.0635995, 0.0030038], [0.0212953, -0.1349885, 0.0047913],
            [0.0303263, -0.2004661, 0.0063483], [0.0418364, -0.267266, 0.0069626],
            [0.0511552, -0.3341736, 0.0063076], [0.0630287, -0.3977738, 0.0062246],
            [0.0097548, -0.0674794, 0.0022272], [0.0210005, -0.1347555, 0.0034666],
            [0.0338059, -0.2044532, 0.0039514], [0.0417822, -0.2681698, 0.0035071],
            [0.0534258, -0.3346644, 0.0032598], [0.0633296, -0.3994845, 0.0019872],
            [0.0111285, -0.0683605, 0.0014254], [0.0236915, -0.1368358, 0.0021542],
            [0.0323715, -0.2002289, 0.0017578], [0.0433587, -0.2643641, 0.0015742],
            [0.0546431, -0.3340719, -0.0002], [0.0649461, -0.399225, -0.0014458],
            [0.0120344, -0.0690043, 0.0008277], [0.0224513, -0.1345587, 0.0003079],
            [0.0324017, -0.198173, 4.63e-05], [0.041786, -0.2635972, -0.0009712],
            [0.0522729, -0.33059, -0.0034916], [0.0647066, -0.4001815, -0.0062277],
            [0.0105764, -0.0663088, -0.0005169], [0.0213327, -0.1301481, -0.0008248],
            [0.0300212, -0.1961651, -0.0020794], [0.0410666, -0.2623376, -0.0039953],
            [0.0513146, -0.3326308, -0.0071824], [0.0107905, -0.0674986, -0.0001725],
            [0.022043, -0.1309327, -0.0024444], [0.032582, -0.1986138, -0.0039711],
            [0.0421836, -0.2662017, -0.0067584], [0.0111966, -0.0669285, -0.0015568],
            [0.0203094, -0.1314784, -0.0037148], [0.0317961, -0.2027815, -0.0069928],
            [0.0104642, -0.0676404, -0.0016858], [0.0210209, -0.1363389, -0.0054194],
            [0.0115251, -0.0684032, -0.0026304]]}
