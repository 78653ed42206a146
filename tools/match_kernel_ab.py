"""K1's and K2's times for one checkout of the port, on one GPU.

Imports ``fastmatch_tpu_torch`` from ``--root`` (default: this checkout), so
two commits are compared on one card by running this script once per
checkout, in turns, inside one call (parent, change, change, parent).
Shapes, as ``chip_smoke.py`` checks them:

- K2 ``distance_topk`` at 2048 x 2048 and 2048 x 8192 (5000 live bank
  rows), exact and fast;
- K1 ``match_batch_fused`` at BASELINE.json config 2's size (64 pairs of
  2048-capacity sets, 1500 live 128-d descriptors): exact, fast, packed
  256-bit binary (every row live), and fast at 256 pairs.

For each: the wrapper's ms per call by CUDA events (``chip_smoke.cuda_ms``,
median of 7 batches), the device us per call of the kernel's own launches
(tiles and finalize, by ``torch.profiler``), and the host us per wrapper
call (``chip_smoke.host_us``, back-to-back calls with no synchronise; few
enough that the launch queue never fills). Prints one JSON line and
appends it to ``chiprun_out/match_kernel_ab.jsonl``.

    python tools/match_kernel_ab.py [--root DIR] [--label NAME]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# Both designs' kernel names: the parent's (topk_tiles, batch_match_tiles)
# and the shared engine's (match_tiles).
K2_NAMES = {"topk_tiles", "match_tiles", "topk_finalize"}
K1_NAMES = {"batch_match_tiles", "match_tiles", "batch_match_finalize"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose src/ to import")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("match_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import (CONFIG2, _config2_sets, _descriptor_sets, cuda_ms, device_us,
                            host_us, nvidia_smi_line)
    import fastmatch_tpu_torch  # noqa: F401  (sets the float32 matmul pin)
    from fastmatch_tpu_torch.core.containers import Descriptors
    from fastmatch_tpu_torch.interop import (batched_descriptors_from_numpy,
                                             binary_descriptors_from_arrays)
    from fastmatch_tpu_torch.kernels import _build
    from fastmatch_tpu_torch.kernels import batch_match as k1
    from fastmatch_tpu_torch.kernels import distance_topk as k2
    from fastmatch_tpu_torch.matching.matcher import BIG

    _build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def measure(fn, names, reps, host_calls, prof_calls):
        us, seen = device_us(fn, names, n=prof_calls)
        return dict(ms=cuda_ms(fn, reps=reps),
                    device_us_per_call=us * seen / prof_calls if seen else None,
                    host_us=host_us(fn, host_calls))

    out = dict(label=args.label, root=os.path.abspath(args.root),
               device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line())
    for n, m, m_live in ((2048, 2048, 2048), (2048, 8192, 5000)):
        q, mq, bank, mb = _descriptor_sets(rng, n, m, m_live, 1500)
        a, b = torch.from_numpy(q).to(dev), torch.from_numpy(bank).to(dev)
        a2m = torch.where(torch.from_numpy(mq).to(dev), (a * a).sum(-1), BIG).contiguous()
        b2m = torch.where(torch.from_numpy(mb).to(dev), (b * b).sum(-1), BIG).contiguous()
        for fast in (False, True):
            out[f"k2_{n}x{m}_{'fast' if fast else 'exact'}"] = measure(
                lambda: k2.distance_topk(a, b, b2m, a2m, fast=fast), K2_NAMES, 20, 200, 50)

    cap, B = CONFIG2["capacity"], CONFIG2["batch"]

    def sets(batch):
        a_sets, b_sets = _config2_sets(rng, batch, matched=True)
        return (batched_descriptors_from_numpy(a_sets, cap, dev),
                batched_descriptors_from_numpy(b_sets, cap, dev))

    da, db = sets(B)
    out["k1_64_exact"] = measure(lambda: k1.match_batch_fused(da, db), K1_NAMES, 5, 20, 10)
    out["k1_64_fast"] = measure(lambda: k1.match_batch_fused(da, db, fast=True), K1_NAMES,
                                10, 20, 10)
    words = rng.integers(0, 2 ** 32, size=(B, cap, 8), dtype=np.uint64).astype(np.uint32)
    ones = np.ones((B, cap), bool)
    wa = binary_descriptors_from_arrays(words, ones, dev)
    wb = binary_descriptors_from_arrays(words[rng.permutation(B)], ones, dev)
    pa, pb = Descriptors(wa.packed, wa.mask), Descriptors(wb.packed, wb.mask)
    out["k1_64_binary"] = measure(
        lambda: k1.match_batch_fused(pa, pb, ratio=0.8 ** 0.5, fast=True, const_sq_norm=256.0,
                                     binary=True), K1_NAMES, 10, 20, 10)
    del da, db
    da, db = sets(CONFIG2["big_batch"])
    out["k1_256_fast"] = measure(lambda: k1.match_batch_fused(da, db, fast=True), K1_NAMES,
                                 4, 10, 5)
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "match_kernel_ab.jsonl"), "a") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
