"""Chunk-offset generation for overlapping signal windows.

Long reads (up to millions of samples) are sliced into fixed-size overlapping
chunks before batched inference; stitching (see ``stitch.py``) reassembles the
per-chunk calls. Offset arithmetic matches the reference behaviour
(dorado/read_pipeline/base/chunk.cpp:11-107) so that stitch trim points agree.
"""

from __future__ import annotations


def generate_chunks(
    num_samples: int, chunk_size: int, stride: int, overlap: int
) -> list[int]:
    """Fixed-size chunk offsets covering ``num_samples``.

    Every chunk is ``chunk_size`` long except that the final chunk is pulled
    back so it ends at (or stride-aligned just past) the end of the read.
    """
    if num_samples == 0:
        raise ValueError("generate_chunks: empty read")
    if stride <= 0:
        raise ValueError(f"generate_chunks: invalid stride {stride}")
    if chunk_size <= 0 or chunk_size % stride != 0 or chunk_size <= overlap:
        raise ValueError(
            f"generate_chunks: invalid chunk size {chunk_size} "
            f"with overlap {overlap} and stride {stride}"
        )
    if overlap % stride != 0:
        raise ValueError(
            f"generate_chunks: invalid overlap {overlap} with stride {stride}"
        )

    offsets = [0]
    offset = 0
    last_offset = num_samples - chunk_size if num_samples > chunk_size else 0
    misalignment = last_offset % stride
    if misalignment:
        # Align the final chunk start up to a stride boundary; the excess
        # samples past the read end are zero-padded by the caller.
        last_offset += stride - misalignment
    chunk_step = chunk_size - overlap
    while offset + chunk_size < num_samples:
        offset = min(offset + chunk_step, last_offset)
        offsets.append(offset)
    return offsets
