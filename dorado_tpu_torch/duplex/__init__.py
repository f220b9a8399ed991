from dorado_tpu_torch.duplex.pairing import CandidateRead, DuplexPairer, PairingResult, check_pair
from dorado_tpu_torch.duplex.pipeline import DuplexPipeline, DuplexStats
from dorado_tpu_torch.duplex.stereo import StereoFeatureInputs, generate_stereo_features

__all__ = [
    "CandidateRead",
    "DuplexPairer",
    "DuplexPipeline",
    "DuplexStats",
    "PairingResult",
    "StereoFeatureInputs",
    "check_pair",
    "generate_stereo_features",
]
