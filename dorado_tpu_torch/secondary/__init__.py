"""Draft polishing (port of ``dorado_tpu/secondary``'s polish path): the
counts pileup and the read matrix with their read-level features, the GRU
and LatentSpaceLSTM models, model resolution and the windowed pipeline."""

from dorado_tpu_torch.secondary.model import GRUModel
from dorado_tpu_torch.secondary.pileup import PileupResult, build_pileup
from dorado_tpu_torch.secondary.polish import PolishPipeline

__all__ = ["GRUModel", "PileupResult", "build_pileup", "PolishPipeline"]
