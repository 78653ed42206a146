"""JAX-on-CPU reference for the scene that ``chip_smoke.py`` reconstructs.

Renders the smoke scene (``chip_smoke.SMOKE_SCENE``) with
``tests/synth.py``, runs the JAX package's ``reconstruct(images=...)`` with
the default ``PipelineConfig`` on the CPU, and prints one JSON line: the
number of frames reconstructed, the ATE after sim(3) alignment, and the
wall time. When the full sequence does not reconstruct, it retries with the
prefix that ends before the failing frame, so the line names the longest
sequence the reference handles.

    python tools/jax_reference_smoke.py [--frames N]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import SMOKE_SCENE, render_smoke_scene
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.pipeline.config import PipelineConfig
    from fastmatch_tpu.pipeline.reconstruct import reconstruct
    from fastmatch_tpu.utils.evaluation import ate_rmse

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=SMOKE_SCENE["n_frames"])
    args = ap.parse_args(argv)

    scene, views = render_smoke_scene(args.frames)
    cam = Pinhole.from_K(scene.K)
    n = args.frames
    attempts = []
    while n >= 3:
        t0 = time.perf_counter()
        try:
            rec = reconstruct(None, cam, PipelineConfig(), images=views[:n])
        except RuntimeError as e:
            attempts.append({"frames": n, "error": str(e)})
            m = re.search(r"frame (\d+)", str(e))
            n = int(m.group(1)) if m else n - 1
            continue
        secs = time.perf_counter() - t0
        gt = -np.einsum("fji,fj->fi", scene.R[:n], scene.t[:n])
        ate = float(ate_rmse(jnp.asarray(rec.camera_centers()),
                             jnp.asarray(gt)))
        print(json.dumps({
            "scene": SMOKE_SCENE, "frames_asked": args.frames,
            "frames_reconstructed": rec.n_frames, "ate": ate,
            "n_points": int(rec.pt_mask.sum()), "n_obs": rec.n_obs,
            "seconds": secs, "failed_attempts": attempts,
            "device": "cpu (JAX reference)",
        }), flush=True)
        return 0
    print(json.dumps({"scene": SMOKE_SCENE, "failed_attempts": attempts}))
    return 1


if __name__ == "__main__":
    sys.exit(main())
