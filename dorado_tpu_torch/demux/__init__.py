"""Barcode demultiplexing, adapter and primer trimming (port of
``dorado_tpu/demux``)."""

from dorado_tpu_torch.demux.barcoder import (
    BarcodeClassifier,
    BarcodeScoreResult,
    get_barcode_sequence,
    get_kit_info,
    list_kits,
    normalize_barcode_name,
)
from dorado_tpu_torch.demux.custom_kit import (
    parse_custom_arrangement,
    parse_custom_sequences,
)

__all__ = [
    "BarcodeClassifier",
    "BarcodeScoreResult",
    "parse_custom_arrangement",
    "parse_custom_sequences",
    "get_barcode_sequence",
    "get_kit_info",
    "list_kits",
    "normalize_barcode_name",
]
