"""JAX-on-CPU reference figure for the IVF parity gate of ``chip_smoke.py``'s
``map_services`` phase.

Runs the JAX package, pinned to the CPU, on ``chip_smoke.CITY_PARITY``'s
inputs: ``chip_smoke.make_city`` (the generator of
``benchmarks/city_bench.py``) at 1024 keyframes x 256 descriptors =
262,144 rows, the IVF index of ``build_map_index``'s default rule (512
clusters, ``build_index_sorted`` from ``PRNGKey(0)``, 10 Lloyd
iterations), then ``match_pair_ann_big(budget=65,536, n_probe=8)`` and the
exact ``match_pair`` over the whole bank, both with the cross-check, and
their shortlist agreement (the fraction of queries valid in both whose
matches agree). Prints one JSON line for ``chip_smoke.JAX_CITY``; about a
minute on a CPU, a few GiB of memory (the exact search's 2048 x 262,144
distances).

    python tools/jax_city_reference.py [--seed 1] [--key 0]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import CITY_PARITY, make_city
    from fastmatch_tpu.core.containers import Descriptors
    from fastmatch_tpu.matching.ann import build_index_sorted, match_pair_ann_big
    from fastmatch_tpu.matching.matcher import match_pair

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=CITY_PARITY["seed"], help="data seed")
    ap.add_argument("--key", type=int, default=0, help="k-means PRNGKey")
    args = ap.parse_args()
    p = CITY_PARITY
    t0 = time.perf_counter()
    bank, q, qmask, j = make_city(p["n_kf"], p["per_kf"], np.random.default_rng(args.seed))
    M = bank.shape[0]
    k = int(min(4096, max(64, 2 ** int(np.ceil(np.log2(max(M, 2) ** 0.5))))))
    db = Descriptors(jnp.asarray(bank), jnp.ones(M, bool))
    qd = Descriptors(jnp.asarray(q), jnp.asarray(qmask))
    idx = build_index_sorted(jax.random.PRNGKey(args.key), db, n_clusters=k, iters=10)
    ivf = match_pair_ann_big(qd, idx, budget=p["budget"], n_probe=p["n_probe"])
    exact = match_pair(qd, db)
    ve, vi = np.asarray(exact.valid), np.asarray(ivf.valid)
    both = ve & vi
    agree = float((np.asarray(exact.idx)[both] == np.asarray(ivf.idx)[both]).mean())
    print(json.dumps(dict(rows=M, n_clusters=k, seed=args.seed, key=args.key, revisit_kf=j,
                          budget=p["budget"], n_probe=p["n_probe"], agreement=agree,
                          co_valid=int(both.sum()), exact_valid=int(ve.sum()),
                          ivf_valid=int(vi.sum()),
                          seconds=round(time.perf_counter() - t0, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
