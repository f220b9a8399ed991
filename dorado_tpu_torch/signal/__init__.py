from dorado_tpu_torch.signal.chunk import generate_chunks
from dorado_tpu_torch.signal.scaling import Scaler, ScalingResult
from dorado_tpu_torch.signal.stitch import CalledChunk, stitch_chunks

__all__ = [
    "CalledChunk",
    "Scaler",
    "ScalingResult",
    "generate_chunks",
    "stitch_chunks",
]
