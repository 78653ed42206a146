"""K4's and K5's wrapper times for one checkout of the port, on one GPU.

Imports ``fastmatch_tpu_torch`` from ``--root`` (default: this checkout), so
two commits are compared on one card by running this script once per
checkout, in turns, inside one call (parent, change, change, parent).
Times, at the smoke map's BA shapes (17788 sorted keys; 5025 of 8192
points, 50 of 64 cameras), each call as BA makes it with that commit's
wrapper (the solve's offsets and longest segment, and the gather's buffer,
where the wrapper takes them):

- K5 ``sorted_gather_rows`` at 8192 x 3, and ``torch.index_select`` into a
  buffer and into a new tensor;
- K4 ``sorted_segment_sum`` point-keyed at D = 3 and 9 and camera-keyed
  (keys sorted) at D = 6 and 36, and ``torch.segment_reduce`` at each.

Each time is the median over 21 batches of the mean ms per call across 100
back-to-back calls, by CUDA events (``chip_smoke.cuda_ms``; host-bound calls
measure the host), and the host us per call over 10,000 calls
(``chip_smoke.host_us``). Prints one JSON line and appends it to
``chiprun_out/segment_wrapper_ab.jsonl``.

    python tools/segment_wrapper_ab.py [--root DIR] [--label NAME]
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose src/ to import")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("segment_wrapper_ab: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms, host_us, nvidia_smi_line
    from fastmatch_tpu_torch.kernels import segment_ops as ops

    def both(fn):
        return dict(ms=cuda_ms(fn, batches=21, reps=100), host_us=host_us(fn))

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    O, N = 17788, 8192
    pts = torch.from_numpy(np.sort(rng.integers(0, 5025, O)).astype(np.int32)).to(dev)
    cams = torch.from_numpy(np.sort(rng.integers(0, 50, O)).astype(np.int32)).to(dev)
    gather_takes_out = "out" in inspect.signature(ops.sorted_gather_rows).parameters
    sum_takes_offsets = "offsets" in inspect.signature(ops.sorted_segment_sum).parameters

    out = dict(label=args.label, root=os.path.abspath(args.root),
               device=torch.cuda.get_device_name(0),
               nvidia_smi=nvidia_smi_line(),
               gather_takes_out=gather_takes_out, sum_takes_offsets=sum_takes_offsets)
    table = torch.randn((N, 3), device=dev)
    buf, lib_buf = table.new_empty((O, 3)), table.new_empty((O, 3))
    if gather_takes_out:
        out["k5"] = both(lambda: ops.sorted_gather_rows(table, pts, out=buf))
    else:
        out["k5"] = both(lambda: ops.sorted_gather_rows(table, pts))
    out["index_select_into_buffer"] = both(
        lambda: torch.index_select(table, 0, pts, out=lib_buf))
    out["index_select"] = both(lambda: torch.index_select(table, 0, pts))
    for what, seg, n, D in (("point", pts, N, 3), ("point", pts, N, 9),
                            ("camera", cams, 64, 6), ("camera", cams, 64, 36)):
        vals = torch.randn((O, D), device=dev)
        lengths = torch.bincount(seg.long(), minlength=n)
        if sum_takes_offsets:
            off = ops.segment_offsets(seg, n)
            longest = int(ops.segment_lengths(off).max())
            k4 = both(lambda: ops.sorted_segment_sum(vals, seg, n, off, longest))
        else:
            k4 = both(lambda: ops.sorted_segment_sum(vals, seg, n))
        out[f"k4_{what}_{D}"] = k4
        out[f"segment_reduce_{what}_{D}"] = both(
            lambda: torch.segment_reduce(vals, "sum", lengths=lengths))
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "segment_wrapper_ab.jsonl"), "a") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
