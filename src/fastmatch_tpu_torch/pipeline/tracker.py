"""Observation-table compaction for the host-driven BA solves.

The port's copy of ``compact_obs`` from ``fastmatch_tpu/pipeline/tracker.py``.
The JAX package's ``obs_bucket`` (a power-of-two table size, to bound its
compiles) is not ported: eager PyTorch has no per-shape compile, so the
port compacts to the live count. The device-resident tracker waits.
"""

from __future__ import annotations

import torch

from fastmatch_tpu_torch.ba.problem import BAProblem, Observations


def compact_obs(prob: BAProblem, bucket: int) -> BAProblem:
    """Compact the observation table to ``bucket`` rows: live rows first in
    their stable order, dead rows pointing at segment 0. BA cost scales
    with the table size, so a map's fixed capacity would otherwise be paid
    in padding; masked rows contribute exactly zero to every reduction."""
    o = prob.obs
    if bucket >= o.mask.shape[0]:
        return prob
    order = torch.argsort((~o.mask).to(torch.uint8), stable=True)[:bucket]
    live = o.mask[order]
    zero = torch.zeros((), dtype=o.cam_idx.dtype, device=o.cam_idx.device)
    obs = Observations(cam_idx=torch.where(live, o.cam_idx[order], zero),
                       pt_idx=torch.where(live, o.pt_idx[order], zero),
                       uv=o.uv[order], mask=live)
    return prob._replace(obs=obs)
