"""Draft polishing and variant calling (port of ``dorado_tpu/secondary``):
the counts pileup and the read matrix with their read-level features, the
GRU, LatentSpaceLSTM, SlotAttentionConsensus and VariantPerceiver models,
model resolution, the windowed polish pipeline, the variant decode and VCF
writer, and the windowed variant caller."""

from dorado_tpu_torch.secondary.model import GRUModel
from dorado_tpu_torch.secondary.pileup import PileupResult, build_pileup
from dorado_tpu_torch.secondary.polish import PolishPipeline

__all__ = ["GRUModel", "PileupResult", "build_pileup", "PolishPipeline"]
