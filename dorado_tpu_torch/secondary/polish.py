"""Draft polishing pipeline (the role of `dorado polish`,
dorado/cli/cli_lib/polish.cpp + secondary/consensus/):

draft FASTA + aligned reads -> pileup count features over windows -> GRU
consensus model -> per-window consensus -> stitched polished sequence.

Reads may come pre-aligned (BAM/SAM) or be aligned internally with the
from-scratch mapper.

Port of ``dorado_tpu/secondary/polish.py``: the same windows, features,
seams and stitching, with the model (a ``GRUModel``, ``LatentSpaceLSTM`` or
``TorchScriptConsensusModel``) on ``device`` (CUDA unless the caller asks for
the CPU) and one window a forward, as the JAX pipeline runs it. Argmax and
phred are computed on the host from the float32 logits, as there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dorado_tpu_torch.alignment.index import read_fasta
from dorado_tpu_torch.basecall.runner import on_device, prepare_cuda, resolve_device
from dorado_tpu_torch.secondary.pileup import AlignedRead, build_pileup


@dataclass
class PolishStats:
    windows: int = 0
    contigs: int = 0
    # host clock: pileups and read matrices; the model's forwards, each
    # until its logits are on the host
    features_s: float = 0.0
    forward_s: float = 0.0


def _overlap_split(p1, p2) -> tuple[int, int]:
    """Trim point between two consecutive window pileups.

    Returns (end_1, start_2): window 1 keeps columns [.., end_1), window 2
    keeps [start_2, ..). Mirrors sample_trimming.cpp overlap_indices: when
    the overlapping (major, minor) column runs are structurally identical the
    split is their midpoint; otherwise a heuristic splits at the middle major
    position. Abutted/gapped windows keep everything.
    """
    from bisect import bisect_left, bisect_right

    pos1 = list(zip(p1.positions_major.tolist(), p1.positions_minor.tolist()))
    pos2 = list(zip(p2.positions_major.tolist(), p2.positions_minor.tolist()))
    if not pos1 or not pos2 or pos2[0] > pos1[-1]:
        return len(pos1), 0
    idx1 = bisect_left(pos1, pos2[0])  # overlap start in window 1
    idx2 = bisect_right(pos2, pos1[-1])  # overlap end in window 2
    if pos1[idx1:] == pos2[:idx2]:
        pad_1 = idx2 // 2
        return idx1 + pad_1, pad_1
    # structures differ (e.g. different read sets created different insertion
    # columns): split both at the middle major position of the overlap
    mid = (pos2[0][0] + pos1[-1][0]) // 2 + 1
    return bisect_left(pos1, (mid, 0)), bisect_left(pos2, (mid, 0))


def _matrix_kwargs(feature_opts: dict, window_reads, start: int, end: int) -> dict:
    """build_read_matrix kwargs for a window: the include_* column flags
    plus haplotags resolved per the configured source (compute -> local
    phasing over the window, bam -> per-read HP tag, unphased -> zeros);
    encoder_read_alignment.cpp:292-331."""
    if not feature_opts:
        return {}
    hap_source = feature_opts.get("hap_source", "unphased")
    haplotags = None
    if feature_opts.get("include_haplotags") and hap_source == "compute":
        from dorado_tpu_torch.secondary.features import local_haplotags

        haplotags = local_haplotags(window_reads, start, end)
    elif hap_source == "unphased":
        haplotags = {}  # all reads untagged, ignore HP tags
    return {
        "include_dwells": feature_opts.get("include_dwells", False),
        "include_haplotags": feature_opts.get("include_haplotags", False),
        "include_snp_qv": feature_opts.get("include_snp_qv", False),
        "haplotags": haplotags,
        "max_reads": feature_opts.get("max_reads", 100),
    }


class PolishPipeline:
    def __init__(
        self,
        model: torch.nn.Module,
        window_len: int = 10000,
        window_overlap: int = 1000,
        feature_kind: str = "counts",
        min_depth: int = 0,
        fill_char: str | None = None,
        feature_opts: dict | None = None,
        device: torch.device | str | None = None,
    ):
        """feature_kind "counts" feeds the medaka counts pileup (GRUModel);
        "read_level" feeds the [P, D, 4] read matrix (LatentSpaceLSTM /
        SlotAttentionConsensus / VariantPerceiver, encoder_read_alignment).

        Windows overlap by ``window_overlap`` and consecutive windows are
        trimmed at the midpoint of their overlap, so every emitted column was
        predicted with model context on both sides (the reference's
        secondary/consensus/sample_trimming.cpp trim_samples).

        ``model`` maps [1, P, 10] counts or [1, P, D, F] read matrices to
        [1, P, classes] logits; it is moved to ``device`` (None, "cuda" and
        "auto": the first card, raising without CUDA; "cuda:N"; "cpu")."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            prepare_cuda()
        self.model = model.to(self.device).eval()
        self.window_len = window_len
        self.window_overlap = min(window_overlap, max(0, window_len - 1))
        self.feature_kind = feature_kind
        self.min_depth = min_depth
        # --fill-char: uncovered/low-depth positions take this character
        # instead of the draft base (polish.cpp --fill-char)
        self.fill_char = fill_char
        # read-level encoder options (dwell/haplotag/snp_qv columns +
        # haplotag source), see cli _feature_opts / encoder_factory.cpp
        self.feature_opts = feature_opts or {}
        self.stats = PolishStats()

    def forward(self, feats: np.ndarray) -> np.ndarray:
        """One window's features [1, P, ...] -> its float32 logits [P, C] (the
        first haplotype's for multi-slot outputs) on the host."""
        with torch.inference_mode(), on_device(self.device):
            x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(self.device)
            logits = self.model(x)[0].float().cpu().numpy()
        if logits.ndim == 3:
            # multi-slot/ploidy outputs: haplotype 0 carries the consensus
            # for haploid polishing
            logits = logits[:, 0]
        return logits

    def polish_contig(
        self,
        draft: str,
        reads: list[AlignedRead],
        region_start: int = 0,
        region_end: int | None = None,
        with_quals: bool = False,
        fill_gaps: bool = True,
    ):
        """Polish one contig with overlapping, midpoint-trimmed windows.
        ``region_start/region_end`` restrict polishing to a sub-span (the
        --regions option); flanks outside the span keep the draft.
        With ``with_quals`` returns (seq, qual_phred_string)."""
        n = len(draft)
        region_end = n if region_end is None else min(region_end, n)
        pieces = []
        quals = []
        # (covered?, draft_lo, draft_hi) per piece, for --no-fill-gaps
        meta = []
        if region_start > 0:
            pieces.append(draft[:region_start])
            quals.append("!" * region_start)
            meta.append((False, 0, region_start))

        stride = max(1, self.window_len - self.window_overlap)
        t0 = time.perf_counter()
        piles = []
        start = region_start
        while start < region_end:
            end = min(region_end, start + self.window_len)
            window_reads = [
                r for r in reads if r.ref_start < end and self._read_end(r) > start
            ]
            piles.append((build_pileup(window_reads, start, end), window_reads, start, end))
            if end >= region_end:
                break
            start += stride
        self.stats.features_s += time.perf_counter() - t0

        # per-window trim ranges: midpoint of the positional overlap
        keeps = []
        lo = 0
        for i, (pile, _, _, _) in enumerate(piles):
            if i + 1 < len(piles):
                end_1, start_2 = _overlap_split(pile, piles[i + 1][0])
            else:
                end_1, start_2 = len(pile.positions_major), 0
            keeps.append((lo, end_1))
            lo = start_2

        for (pile, window_reads, start, end), (klo, khi) in zip(piles, keeps):
            self.stats.windows += 1
            if pile.depth.max(initial=0.0) == 0:
                # no coverage: keep the draft over the kept major positions
                majors = pile.positions_major[klo:khi]
                minors = pile.positions_minor[klo:khi]
                kept = [
                    (self.fill_char or draft[m])
                    for m, mi in zip(majors, minors)
                    if mi == 0
                ]
                pieces.append("".join(kept))
                quals.append("!" * len(kept))
                meta.append(
                    (False, int(majors[0]) if len(majors) else start,
                     int(majors[-1]) + 1 if len(majors) else start)
                )
                continue
            if self.feature_kind == "read_level":
                from dorado_tpu_torch.secondary.read_matrix import build_read_matrix

                t0 = time.perf_counter()
                rm = build_read_matrix(
                    window_reads, start, end, **_matrix_kwargs(
                        self.feature_opts, window_reads, start, end
                    )
                )
                self.stats.features_s += time.perf_counter() - t0
                feats = rm.matrix[None, ...]  # [1, P, D, F]
            else:
                feats = pile.counts[None, ...]  # [1, P, 10]
            t0 = time.perf_counter()
            logits = self.forward(feats)
            self.stats.forward_s += time.perf_counter() - t0
            # positions below min coverage keep the draft base
            classes = logits.argmax(axis=-1)
            exp = np.exp(logits - logits.max(axis=-1, keepdims=True))
            probs = exp / exp.sum(axis=-1, keepdims=True)
            out = []
            qual_out = []
            depth_floor = max(1, self.min_depth)
            for i in range(klo, khi):
                if pile.depth[i] < depth_floor:
                    if pile.positions_minor[i] == 0:
                        out.append(
                            self.fill_char or draft[pile.positions_major[i]]
                        )
                        qual_out.append("!")
                    continue
                c = int(classes[i])
                if c != 0:
                    out.append("*ACGT"[c])
                    # phred from the class posterior (decoder_base.cpp qual)
                    err = max(1.0 - float(probs[i, c]), 1e-7)
                    q = min(int(round(-10.0 * np.log10(err))), 70)
                    qual_out.append(chr(33 + q))
            pieces.append("".join(out))
            quals.append("".join(qual_out))
            majors = pile.positions_major[klo:khi]
            meta.append(
                (True, int(majors[0]) if len(majors) else start,
                 int(majors[-1]) + 1 if len(majors) else start)
            )
        if region_end < n:
            pieces.append(draft[region_end:])
            quals.append("!" * (n - region_end))
            meta.append((False, region_end, n))
        if not fill_gaps:
            # emit one record per covered run with its draft coordinates
            # (polish.cpp:480-513 --no-fill-gaps headers "name_i start-end")
            runs = []
            for piece, qual, (cov, lo, hi) in zip(pieces, quals, meta):
                if not cov:
                    continue
                if runs and runs[-1][1] == lo:
                    prev = runs[-1]
                    runs[-1] = (prev[0], hi, prev[2] + piece, prev[3] + qual)
                else:
                    runs.append((lo, hi, piece, qual))
            return [
                (lo, hi, seq, qual) if with_quals else (lo, hi, seq)
                for lo, hi, seq, qual in runs
            ]
        seq = "".join(pieces)
        return (seq, "".join(quals)) if with_quals else seq

    @staticmethod
    def _read_end(read: AlignedRead) -> int:
        import re

        length = 0
        for num, op in re.findall(r"(\d+)([MIDNSHP=X])", read.cigar):
            if op in "M=XDN":
                length += int(num)
        return read.ref_start + length

    def run(
        self,
        draft_fasta: Path | str,
        alignments_by_contig: dict[str, list[AlignedRead]],
        regions: dict | None = None,
        with_quals: bool = False,
        fill_gaps: bool = True,
    ):
        """[(name, polished)] for every draft contig; `regions`
        ({ctg: (start, end) | None}) restricts which contigs/spans run.
        With fill_gaps=False, uncovered spans are dropped and each covered
        run becomes its own record named "name_i start-end"
        (polish.cpp:480-513)."""
        out = []
        for name, seq in read_fasta(draft_fasta):
            if regions is not None and name not in regions:
                continue
            span = regions.get(name) if regions else None
            start, end = span if span else (0, None)
            reads = alignments_by_contig.get(name, [])
            result = self.polish_contig(
                seq, reads, start, end, with_quals, fill_gaps=fill_gaps
            )
            if fill_gaps:
                out.append((name, result))
            else:
                for i, rec in enumerate(result):
                    lo, hi, rest = rec[0], rec[1], rec[2:]
                    label = f"{name}_{i} {lo}-{hi}"
                    out.append(
                        (label, rest[0] if len(rest) == 1 else tuple(rest))
                    )
            self.stats.contigs += 1
        return out
