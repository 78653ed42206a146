"""fastmatch_tpu_torch: the PyTorch/CUDA port of fastmatch-tpu for NVIDIA H100.

The package mirrors ``fastmatch_tpu``'s layout and public names (``core/``,
``features/``, ``matching/``, ``geometry/``, ``ba/``, ``kernels/``,
``pipeline/``, ``utils/``). Plain tensor code is PyTorch; the three TPU
kernels on the incremental-SfM path (fused distance/top-2, patch gather,
sorted segment sum) are CUDA C++ kernels under ``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use. Entry points take a ``device``
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
from fastmatch_tpu_torch.core.containers import Descriptors, Keypoints, Matches  # noqa: E402
from fastmatch_tpu_torch.features.sift import detect_and_describe  # noqa: E402
from fastmatch_tpu_torch.geometry.homography import select_two_view_model  # noqa: E402
from fastmatch_tpu_torch.geometry.pnp import ransac_pnp  # noqa: E402
from fastmatch_tpu_torch.geometry.ransac import ransac_essential  # noqa: E402
from fastmatch_tpu_torch.matching.matcher import match_pair  # noqa: E402
from fastmatch_tpu_torch.pipeline.config import PipelineConfig  # noqa: E402
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction, reconstruct  # noqa: E402

__all__ = [
    "Descriptors", "Keypoints", "Matches", "PipelineConfig", "Reconstruction",
    "ba_solve", "detect_and_describe", "match_pair", "ransac_essential", "ransac_pnp",
    "reconstruct", "select_two_view_model",
]
