"""Read correction (port of ``dorado_tpu/correct``)."""

from dorado_tpu_torch.correct.corrector import ReadCorrector

__all__ = ["ReadCorrector"]
