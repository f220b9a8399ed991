"""The from-scratch read mapper: minimizer index, chaining, banded extension
(port of ``dorado_tpu/alignment``), the BED reader, and the alignment of
basecalled records (``RecordAligner``)."""

from dorado_tpu_torch.alignment.index import ReferenceIndex
from dorado_tpu_torch.alignment.mapper import Alignment, Mapper

__all__ = ["ReferenceIndex", "Mapper", "Alignment"]
