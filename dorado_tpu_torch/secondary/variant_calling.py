"""The variant-calling flow (the role of `dorado variant`,
dorado/cli/cli_lib/variant.cpp): over each contig, or over the flanked
spans around candidate sites, windows of ``window_len`` with overlap
margins on both sides; each window's counts pileup or read matrix (with
its haplotags) on the host, the model on ``device`` (CUDA unless the caller
asks for the CPU), a softmax and ``decode_variants`` on the host over the
covered columns, and only the window that owns a record's position writes
it (trim_vc_samples / join_samples, polish_impl.cpp:2388-2392).

Port of the window loop of ``dorado_tpu/cli/main.py``'s ``_run_variant``,
with the same windows, features and decode. The slot model's phasing
(``batch_adjacency_phase``) runs on the host inside its forward, as in the
JAX package.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dorado_tpu_torch.basecall.runner import on_device, prepare_cuda, resolve_device
from dorado_tpu_torch.secondary.pileup import AlignedRead, build_pileup
from dorado_tpu_torch.secondary.variant import Variant, VcfWriter, decode_variants

_SPAN_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class VariantStats:
    windows: int = 0
    records: int = 0
    # host clock: pileups, haplotags and read matrices; the model's forwards
    # until their outputs are on the host (the slot model's phasing
    # included); the softmax and the decode
    features_s: float = 0.0
    forward_s: float = 0.0
    decode_s: float = 0.0


def read_candidates(path: Path | str, flank: int) -> dict[str, list[tuple[int, int]]]:
    """A file of candidate sites (contig and 0-based position, whitespace
    separated, a site a line) -> {contig: merged [lo, hi) spans of the sites
    widened by ``flank`` on each side} (variant.cpp:300,482)."""
    flank = max(0, flank)
    per: dict[str, list[int]] = {}
    with open(path) as fh:
        for line in fh:
            f = line.split()
            if len(f) >= 2:
                per.setdefault(f[0], []).append(int(f[1]))
    spans = {}
    for ctg, poss in per.items():
        poss.sort()
        merged: list[tuple[int, int]] = []
        for p in poss:
            lo, hi = max(0, p - flank), p + flank + 1
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        spans[ctg] = merged
    return spans


def _ref_end(read: AlignedRead) -> int:
    span = sum(int(n) for n, op in _SPAN_RE.findall(read.cigar) if op in "MDN=X")
    return read.ref_start + max(span, 1)


class VariantCaller:
    def __init__(
        self,
        model: torch.nn.Module,
        feature_kind: str = "counts",
        feature_opts: dict | None = None,
        device: torch.device | str | None = None,
        window_len: int = 10000,
        window_overlap: int | None = None,
        min_qual: float = 3.0,
        ambig_ref: bool = False,
        gvcf: bool = False,
    ):
        """``model`` maps [1, P, 10] counts (``feature_kind="counts"``) or
        [1, P, D, F] read matrices (``"read_level"``, built with
        ``feature_opts``: the include_* columns, ``hap_source`` "compute",
        "bam" or "unphased", ``max_reads``) to [1, P, C] or [1, P, H, C]
        scores; it is moved to ``device`` (None, "cuda" and "auto": the
        first card, raising without CUDA; "cuda:N"; "cpu"). Windows carry
        ``window_overlap`` columns of margin on each side (default
        min(1000, window_len // 2)); records below ``min_qual`` are LowQual;
        ``gvcf`` adds a reference record at every covered position."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            prepare_cuda()
        self.model = model.to(self.device).eval()
        self.feature_kind = feature_kind
        self.feature_opts = feature_opts or {}
        self.window_len = window_len
        self.margin = window_overlap if window_overlap is not None else min(1000,
                                                                            window_len // 2)
        self.min_qual = min_qual
        self.ambig_ref = ambig_ref
        self.gvcf = gvcf
        self.stats = VariantStats()

    def forward(self, feats: np.ndarray) -> np.ndarray:
        """One window's features [1, P, ...] -> the model's float32 output
        [P, ...] on the host."""
        with torch.inference_mode(), on_device(self.device):
            x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(self.device)
            return self.model(x)[0].float().cpu().numpy()

    def features(self, reads: list[AlignedRead], w_start: int, w_end: int):
        """(pileup, the model's input [1, P, ...]) of one window, or (pileup,
        None) where no read covers it."""
        pile = build_pileup(reads, w_start, w_end)
        if pile.depth.max(initial=0.0) == 0:
            return pile, None
        if self.feature_kind != "read_level":
            return pile, pile.counts[None]
        from dorado_tpu_torch.secondary.polish import _matrix_kwargs
        from dorado_tpu_torch.secondary.read_matrix import build_read_matrix

        rm = build_read_matrix(reads, w_start, w_end,
                               **_matrix_kwargs(self.feature_opts, reads, w_start, w_end))
        return pile, rm.matrix[None]

    def decode(self, seq: str, name: str, pile, logits: np.ndarray) -> list[Variant]:
        """The model's output over one window -> its records (all of them;
        the caller keeps those its window owns). The softmax runs again on
        the output, whatever the model: the JAX command's order."""
        covered = pile.depth > 0
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        return decode_variants(
            seq, name, probs[covered], pile.positions_major[covered],
            pile.positions_minor[covered], min_qual=self.min_qual, ambig_ref=self.ambig_ref,
            return_all=self.gvcf)

    def call_contig(self, name: str, seq: str, reads: list[AlignedRead],
                    spans: list[tuple[int, int]]) -> list[Variant]:
        """The records of one contig's ``spans`` ([lo, hi) each), in window
        order, each from the window that owns its position."""
        read_ends = [_ref_end(r) for r in reads]
        out = []
        for s_lo, s_hi in spans:
            for start in range(s_lo, s_hi, self.window_len):
                end = min(s_hi, start + self.window_len)
                w_start, w_end = max(s_lo, start - self.margin), min(s_hi, end + self.margin)
                t0 = time.perf_counter()
                window_reads = [r for r, e in zip(reads, read_ends)
                                if r.ref_start < w_end and e > w_start]
                pile, feats = self.features(window_reads, w_start, w_end)
                self.stats.features_s += time.perf_counter() - t0
                if feats is None:
                    continue
                self.stats.windows += 1
                t0 = time.perf_counter()
                logits = self.forward(feats)
                self.stats.forward_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                out += [v for v in self.decode(seq, name, pile, logits) if start <= v.pos < end]
                self.stats.decode_s += time.perf_counter() - t0
        return out

    def run(self, contigs: list[tuple[str, str]], alignments_by_contig: dict,
            writer: VcfWriter, regions: dict | None = None,
            candidates: dict[str, list[tuple[int, int]]] | None = None,
            ) -> list[tuple[str, int, int]]:
        """Every contig's records into ``writer``; ``regions`` ({ctg: (start,
        end) | None}) restricts which contigs and spans run, ``candidates``
        (``read_candidates``) replaces each contig's whole span by its
        candidate spans. Returns the spans processed, (contig, lo, hi)."""
        processed = []
        for name, seq in contigs:
            if regions is not None and name not in regions:
                continue
            span = regions.get(name) if regions else None
            r_start, r_end = span if span else (0, len(seq))
            r_end = len(seq) if r_end is None else min(r_end, len(seq))
            if candidates is not None:
                spans = [(max(r_start, lo), min(r_end, hi)) for lo, hi in candidates.get(name, [])
                         if lo < r_end and hi > r_start]
            else:
                spans = [(r_start, r_end)]
            processed += [(name, lo, hi) for lo, hi in spans]
            for v in self.call_contig(name, seq, alignments_by_contig.get(name, []), spans):
                writer.write(v)
                self.stats.records += 1
        return processed
