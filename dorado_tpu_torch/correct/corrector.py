"""Read error correction (the role of `dorado correct`,
dorado/cli/cli_lib/correct.cpp + dorado/correct/); port of
``dorado_tpu/correct/corrector.py``.

Two consensus paths over the same all-vs-all overlap structure: the default
depth-weighted pileup vote, and the HERRO-style NN path (``use_nn``) — window
feature matrices (correct/features.py), NN predictions at supported
positions with the reference inference contract (correct/nn_model.py,
CorrectionInferenceNode.cpp:186-247), and the reference decode
(decode.cpp semantics) with vote fallback elsewhere. The model runs on the
card (``device``, CUDA by default), one window a forward; the features,
windows and decode are host numpy.

Overlaps come from the port's minimizer mapper (the reference uses minimap2
all-vs-all, correct.cpp:439), mapped on ``threads`` host threads with the
records in the reads' order.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from dorado_tpu_torch.alignment import Mapper, ReferenceIndex
from dorado_tpu_torch.correct import nn_model as nnm
from dorado_tpu_torch.correct.features import decode_window, get_features_for_window
from dorado_tpu_torch.correct.windows import _Aln, extract_windows
from dorado_tpu_torch.secondary.pileup import AlignedRead, build_pileup
from dorado_tpu_torch.utils.sequence import reverse_complement

# JAX's NN path ignores FASTQ qualities: every base is scored at this phred+33
NN_QUAL = 73.0


@dataclass
class CorrectStats:
    reads_total: int = 0
    reads_corrected: int = 0
    overlaps: int = 0
    # the NN path's windows and where their time went (host clock; the
    # forward's includes fetching the predictions, so it ends on the device)
    windows: int = 0
    mapping_s: float = 0.0
    extract_s: float = 0.0
    features_s: float = 0.0
    forward_s: float = 0.0
    decode_s: float = 0.0


class ReadCorrector:
    def __init__(self, min_depth: int = 2, min_overlap_reads: int = 2,
                 max_overlaps_per_read: int = 20, use_nn: bool = False,
                 nn_model: nnm.CorrectionModel | None = None, nn_scorer=None,
                 window_size: int = 4096, kmer_size: int = 15, ovl_window_size: int = 10,
                 min_chain_score: int | None = None, device=None, threads: int = 1):
        """use_nn enables the HERRO-style path: window feature matrices +
        NN predictions at supported positions + majority decode elsewhere.
        The default is the pileup-vote consensus (equivalent to the decode
        fallback). The NN path's model (seeded random weights unless
        ``nn_model`` or ``nn_scorer`` is given) runs on ``device``: CUDA by
        default, raising without it; ``"cpu"`` runs it on the CPU."""
        self.min_depth = min_depth
        self.min_overlap_reads = min_overlap_reads
        # overlap-index tuning (correct.cpp:65-67 --kmer-size /
        # --ovl-window-size / --min-chain-score); defaults match the mapper
        self.kmer_size = kmer_size
        self.ovl_window_size = ovl_window_size
        self.min_chain_score = min_chain_score
        self.max_overlaps_per_read = max_overlaps_per_read
        self.use_nn = use_nn or nn_scorer is not None
        self.nn_scorer = nn_scorer  # e.g. TorchScriptScorer for herro-v1
        self.window_size = window_size  # target bases per window (4096)
        self.threads = threads or os.cpu_count() or 1
        self.device = None
        self.nn_model = nn_model
        if self.use_nn and nn_scorer is None:
            from dorado_tpu_torch.basecall.runner import resolve_device

            self.device = resolve_device(device)
            if self.nn_model is None:
                self.nn_model = _default_model()
            self.nn_model = self.nn_model.to(self.device).eval()
        self.stats = CorrectStats()

    def compute_overlap_records(
        self, reads: list[tuple[str, str]], target_names: set[str] | None = None
    ) -> list[tuple]:
        """All-vs-all overlaps as PAF-shaped tuples (qname, qlen, qstart,
        qend, strand, tname, tlen, tstart, tend, nmatch, alnlen, mapq,
        cigar) — the --to-paf payload (correct.cpp CorrectionPafWriterNode).
        ``target_names`` restricts the index to one block's targets
        (--run-block-id: mm2 builds the index per block and streams every
        read as a query)."""
        t0 = time.perf_counter()
        index = ReferenceIndex.build(
            [(n, s) for n, s in reads if target_names is None or n in target_names],
            k=self.kmer_size, w=self.ovl_window_size,
        )
        mapper_kwargs = {}
        if self.min_chain_score is not None:
            mapper_kwargs["min_chain_score"] = self.min_chain_score
        mapper = Mapper(index, max_alignments=self.max_overlaps_per_read, **mapper_kwargs)
        lens = {n: len(s) for n, s in reads}
        # the banded alignments run in C++ without the interpreter lock
        with ThreadPoolExecutor(self.threads) as pool:
            mapped = list(pool.map(lambda read: mapper.map(read[1]), reads))
        recs = []
        for (name, seq), alignments in zip(reads, mapped):
            for a in alignments:
                if a.ref_name == name:
                    continue  # self-hit
                span = a.ref_end - a.ref_start
                # PAF qstart/qend are ALWAYS original-strand coordinates;
                # the mapper reports reverse hits in RC-frame, so flip
                if a.is_reverse:
                    q0, q1 = len(seq) - a.q_end, len(seq) - a.q_start
                else:
                    q0, q1 = a.q_start, a.q_end
                recs.append((
                    name, len(seq), q0, q1, "-" if a.is_reverse else "+",
                    a.ref_name, lens[a.ref_name], a.ref_start, a.ref_end,
                    max(span - a.nm, 0), span, a.mapq, a.cigar,
                ))
        self.stats.mapping_s += time.perf_counter() - t0
        return recs

    def overlaps_from_records(
        self, reads: list[tuple[str, str]], recs: list[tuple]
    ) -> dict[str, list[AlignedRead]]:
        """PAF-shaped tuples -> per-target AlignedRead evidence lists."""
        seqs = dict(reads)
        overlaps: dict[str, list[AlignedRead]] = {n: [] for n, _ in reads}
        for r in recs:
            qname, strand, tname, tstart, cigar = r[0], r[4], r[5], r[7], r[12]
            seq = seqs.get(qname)
            if seq is None or tname not in overlaps:
                continue
            oriented = reverse_complement(seq) if strand == "-" else seq
            overlaps[tname].append(AlignedRead(int(tstart), cigar, oriented, strand == "-"))
            self.stats.overlaps += 1
        return overlaps

    def correct(
        self,
        reads: list[tuple[str, str]],
        targets: set[str] | None = None,
        overlap_records: list[tuple] | None = None,
    ) -> list[tuple[str, str]]:
        """[(name, seq)] -> [(name, corrected seq)] via all-vs-all overlap
        consensus. ``targets`` restricts which reads are corrected/emitted
        (resume / --run-block-id) while every read still serves as overlap
        evidence — matching the reference, where resumed runs re-align
        against the full index but only emit the remaining targets.
        ``overlap_records`` short-circuits the overlap computation
        (--from-paf)."""
        if overlap_records is None:
            overlap_records = self.compute_overlap_records(reads, targets)
        overlaps = self.overlaps_from_records(reads, overlap_records)

        out = []
        for name, seq in reads:
            if targets is not None and name not in targets:
                continue
            self.stats.reads_total += 1
            ovl = overlaps[name]
            if len(ovl) < self.min_overlap_reads:
                out.append((name, seq))  # insufficient coverage: unchanged
                continue
            corrected = self._consensus_nn(seq, ovl) if self.use_nn else self._consensus(seq, ovl)
            self.stats.reads_corrected += 1
            out.append((name, corrected))
        return out

    def windows(self, target: str, ovl: list[AlignedRead]):
        """(win_tstart, win_len, WindowFeatures or None) for each window of
        ``target``: None where fewer than two pieces support it. The target
        is cut into window_size chunks, each alignment split per window by
        one CIGAR walk with the TOP_K most accurate pieces kept (windows.cpp
        extract_windows/split_alignment); every base scores NN_QUAL."""
        t0 = time.perf_counter()
        alns = [
            _Aln(seq=r.seq, qual=np.full(len(r.seq), NN_QUAL, np.float32), cigar=r.cigar,
                 tstart=r.ref_start, fwd=not r.is_reverse, qname=f"aln{i}")
            for i, r in enumerate(ovl)
        ]
        tqual = np.full(len(target), NN_QUAL, np.float32)
        extracted = extract_windows(target, alns, window_size=self.window_size)
        self.stats.extract_s += time.perf_counter() - t0
        for win_tstart, win_len, wovs in extracted:
            if len(wovs) < 2:
                yield win_tstart, win_len, None
                continue
            t0 = time.perf_counter()
            wf = get_features_for_window(target, tqual, wovs, win_tstart, win_len)
            self.stats.features_s += time.perf_counter() - t0
            yield win_tstart, win_len, wf

    def predict(self, wf) -> str:
        """The NN's bases at one window's supported positions."""
        t0 = time.perf_counter()
        if self.nn_scorer is not None:
            bases = self.nn_scorer.predict(wf)
        else:
            bases = nnm.predict_supported(self.nn_model, wf, self.device)
        self.stats.forward_s += time.perf_counter() - t0
        self.stats.windows += 1
        return bases

    def _consensus_nn(self, target: str, ovl: list[AlignedRead]) -> str:
        """HERRO-contract path: NN inference at supported positions +
        majority decode per window, concatenated (the CorrectionNode window
        loop)."""
        pieces = []
        for win_tstart, win_len, wf in self.windows(target, ovl):
            if wf is None:
                # windows the NN cannot support keep the draft chunk
                # (decode.cpp emits nothing for n_alns < 2; the reference
                # read then falls back to the uncorrected sequence there)
                pieces.append(target[win_tstart : win_tstart + win_len])
                continue
            wf.inferred_bases = self.predict(wf)
            t0 = time.perf_counter()
            pieces.append(decode_window(wf))
            self.stats.decode_s += time.perf_counter() - t0
        return "".join(pieces)

    def _consensus(self, target: str, ovl: list[AlignedRead]) -> str:
        """Pileup majority vote; target base wins below min_depth."""
        pile = build_pileup(ovl, 0, len(target), normalise=False)
        counts = pile.counts
        # combine strands: A/C/G/T totals and deletions
        base_counts = counts[:, 0:4] + counts[:, 4:8]
        del_counts = counts[:, 8] + counts[:, 9]
        stacked = np.concatenate([del_counts[:, None], base_counts], axis=1)  # [*,A,C,G,T]
        best = stacked.argmax(axis=1)
        depth = stacked.sum(axis=1)

        out = []
        for i in range(len(best)):
            is_minor = pile.positions_minor[i] > 0
            if depth[i] < self.min_depth:
                if not is_minor:
                    out.append(target[pile.positions_major[i]])
                continue
            c = int(best[i])
            if c == 0:
                continue  # deletion wins
            out.append("*ACGT"[c])
        return "".join(out)


def _default_model() -> nnm.CorrectionModel:
    """The NN path's model when none is given: seeded random weights at the
    full width (the JAX package's ``PRNGKey(0)`` role)."""
    return nnm.init_correction_model(torch.Generator().manual_seed(0))
