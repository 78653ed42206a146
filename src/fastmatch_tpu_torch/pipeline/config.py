"""Config system: frozen dataclasses per layer, composed.

The port's own copy of ``fastmatch_tpu/pipeline/config.py`` (same fields,
same defaults, same ``config_hash``), so a configuration hashes identically
in both packages. Fields that only the JAX package's engines read
(``fx_hint``, ``local_obs_cap``, the interval budgets) are kept for the
hash. ``MatchingConfig.backend`` takes the names of both packages: "auto"
(by device), "plain" or the JAX package's "jnp", "kernel" or "pallas"
(``matching.matcher.resolve_backend``), so a config carried across keeps
its name and its hash.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from fastmatch_tpu_torch.features.sift import SIFTConfig


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    ratio: float = 0.8
    cross_check: bool = True
    backend: str = "auto"
    precision: str = "exact"  # exact | fast (bf16 inputs, fp32 accumulation)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    n_hyp: int = 512
    thr_px: float = 2.0          # inlier threshold in pixels (converted by f)
    min_inliers: int = 15
    model_select: bool = True    # bootstrap H-vs-E selection (planar scenes)


@dataclasses.dataclass(frozen=True)
class BAConfig:
    max_iters: int = 15
    pcg_iters: int = 40
    huber_px: float = 2.0
    interval: int = 5            # run BA every N frames
    fx_hint: float = 500.0
    local_obs_cap: int = 8192
    interval_max_iters: int = 6
    interval_pcg_iters: int = 16


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_frames: int = 64
    max_points: int = 8192
    max_obs: int = 65536
    min_parallax_deg: float = 1.0
    desc_dim: int = 128
    # New-landmark dedup: a keypoint whose nearest map descriptor is closer
    # than this squared-L2 distance is a re-observation, not a new landmark.
    dedup_desc_d2: float = 0.35


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sift: SIFTConfig = SIFTConfig()
    matching: MatchingConfig = MatchingConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BAConfig = BAConfig()
    map: MapConfig = MapConfig()

    def config_hash(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {f.name: enc(getattr(o, f.name)) for f in dataclasses.fields(o)}
            if hasattr(o, "_asdict"):
                return dict(o._asdict())
            return o

        return hashlib.sha256(
            json.dumps(enc(self), sort_keys=True, default=str).encode()
        ).hexdigest()[:16]
