"""JAX-on-CPU reference figures for the port's distributed-SLAM tests.

Runs the JAX package's ``slam_distributed`` (``DistConfig(overlap=True)``)
on ``tests/dist_fixtures.py``'s scene and configuration, on a mesh of
``bank=2`` CPU devices, and prints one JSON object for
``dist_fixtures.JAX``: the frame sequence, the loop edges, the PGO runs,
the ATE and the camera centres. About 4.5 minutes on an 8-core CPU, nearly
all of it compiles.

    python tools/jax_dist_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()


def reference() -> dict:
    """The JAX package's figures (the process must see at least N_BANK
    CPU devices)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import dist_fixtures as fx
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.dist.mesh import make_mesh
    from fastmatch_tpu.dist.pipeline import DistConfig, slam_distributed

    scene, feats = fx.scene_and_features()
    cfg, scfg = fx.configs("fastmatch_tpu")
    mesh = make_mesh(n_data=1, n_bank=fx.N_BANK, devices=jax.devices()[:fx.N_BANK])
    out = slam_distributed(feats, Pinhole.from_K(scene.K), cfg, scfg,
                           DistConfig(overlap=True), mesh=mesh)
    return dict(fx.summary(out, scene), n_bank=fx.N_BANK, device="cpu (JAX reference)")


if __name__ == "__main__":
    t0 = time.perf_counter()
    ref = reference()
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps(ref))
