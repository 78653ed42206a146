"""What bounds K3 (``gather_patch_sets``) on one GPU: its stores or its gather.

Builds ``tools/patch_gather_probe.cu`` (which includes the shipped
``csrc/patch_gather.cu``) with the port's nvcc flags and times, by
``torch.profiler`` device time per launch, on the real patch sets of a
rendered 640x480 smoke frame (SIFT's 8 and ORB's 4, as ``chip_smoke.py``
checks them):

- the shipped kernel, through ``gather_patch_sets``;
- its stores alone: the same blocks write a constant with the same 16-byte
  cache-streaming stores and read nothing;
- its gather alone: the same start table and reads, and no stores.

Each beside the bound ``chip_smoke.py`` computes (bytes over 3.35 TB/s).
Prints one JSON line and appends it to ``chiprun_out/patch_gather_probe.jsonl``.

    python tools/patch_gather_probe.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for sub in ("src", "tests", ""):
    sys.path.insert(0, os.path.join(ROOT, sub))


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("patch_gather_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fastmatch_tpu_torch.kernels import _build
    from fastmatch_tpu_torch.kernels import patch_gather as k3

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "patch_gather_probe.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(ROOT, "tools", "patch_gather_probe.cu")],
                   check=True, capture_output=True, text=True)
    probe = ctypes.CDLL(lib_path).fm_patch_gather_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int] + k3._ARGTYPES

    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=cs.nvidia_smi_line())
    for what, segments in cs._k3_frame_sets(torch.device("cuda")).items():
        sets, dims = k3._checked(segments)
        sizes = [(K, s.patch) for s, (K, _, _, _) in zip(sets, dims)]
        offsets, first_blocks, total, launches = k3.plan_patch_sets(sizes)
        (start, end, blocks), = launches
        table = k3._table(sets, dims, offsets, first_blocks, start, end)
        buf = torch.empty(total, dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run(mode):
            return lambda: _build.check(probe(mode, table.buffer_info()[0], end - start,
                                              blocks, buf.data_ptr(), stream), "probe")

        b_ms, _ = cs.bound(cs._k3_bytes(sets))
        out[what] = dict(
            bound_us=b_ms * 1e3,
            kernel_us=cs.device_us(lambda: k3.gather_patch_sets(sets), cs.K3_KERNELS, n=50)[0],
            stores_only_us=cs.device_us(run(0), {"probe_stores_kernel"}, n=50)[0],
            gathers_only_us=cs.device_us(run(1), {"probe_gathers_kernel"}, n=50)[0])
    line = json.dumps(out)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "patch_gather_probe.jsonl"), "a") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
