from fastmatch_tpu_torch.features.orb import ORBConfig, detect_and_describe_orb
from fastmatch_tpu_torch.features.sift import SIFTConfig, detect_and_describe

__all__ = ["ORBConfig", "SIFTConfig", "detect_and_describe", "detect_and_describe_orb"]
