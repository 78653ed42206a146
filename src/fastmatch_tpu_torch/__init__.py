"""fastmatch_tpu_torch: the PyTorch/CUDA port of fastmatch-tpu for NVIDIA H100.

The package mirrors ``fastmatch_tpu``'s layout and public names (``core/``,
``features/``, ``matching/``, ``geometry/``, ``ba/``, ``posegraph/``,
``kernels/``, ``pipeline/``, ``utils/``). Plain tensor code is PyTorch; the five TPU
kernels (batched fused matcher, fused distance/top-2, patch gather, sorted
segment sum, sorted row gather) are CUDA C++ kernels under ``csrc/``, built
with ``nvcc`` for ``sm_90a`` at first use. Entry points take a ``device``
argument and run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain PyTorch version.

.. warning:: **Import side effect** — importing this package sets
   ``torch.backends.cuda.matmul.allow_tf32 = False`` and
   ``torch.backends.cudnn.allow_tf32 = False``. This mirrors the JAX
   package's ``jax_default_matmul_precision = "highest"`` pin: geometry and
   bundle adjustment lose about three decimal digits per product in TF32,
   so every float32 product here runs in full float32. bf16 appears only
   where the JAX package opts into it (the matcher's ``precision="fast"``).
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from fastmatch_tpu_torch.ba.lm import ba_solve  # noqa: E402
from fastmatch_tpu_torch.core.containers import (  # noqa: E402
    BinaryDescriptors, Descriptors, Keypoints, Matches)
from fastmatch_tpu_torch.core.lie import Sim3  # noqa: E402
from fastmatch_tpu_torch.features.orb import ORBConfig, detect_and_describe_orb  # noqa: E402
from fastmatch_tpu_torch.features.sift import SIFTConfig, detect_and_describe  # noqa: E402
from fastmatch_tpu_torch.geometry.homography import select_two_view_model  # noqa: E402
from fastmatch_tpu_torch.geometry.pnp import ransac_pnp  # noqa: E402
from fastmatch_tpu_torch.geometry.ransac import ransac_essential  # noqa: E402
from fastmatch_tpu_torch.matching.hamming import (  # noqa: E402
    match_batch_hamming, match_pair_hamming)
from fastmatch_tpu_torch.matching.matcher import match_batch, match_pair  # noqa: E402
from fastmatch_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction, reconstruct  # noqa: E402
from fastmatch_tpu_torch.pipeline.slam import SlamConfig, slam  # noqa: E402
from fastmatch_tpu_torch.posegraph.pgo import PoseGraph, pgo_solve  # noqa: E402

__all__ = [
    "BinaryDescriptors", "Descriptors", "Keypoints", "Matches", "ORBConfig",
    "PipelineConfig", "PoseGraph", "Reconstruction", "SIFTConfig", "Sim3", "SlamConfig",
    "ba_solve", "detect_and_describe", "detect_and_describe_orb", "match_batch",
    "match_batch_hamming", "match_pair", "match_pair_hamming", "pgo_solve",
    "ransac_essential", "ransac_pnp", "reconstruct", "select_two_view_model", "slam",
]
