"""Seed-chain-extend read mapper (the role of dorado's AlignerNode +
ont-minimap2, built from scratch).

Per query: minimizer anchors against the reference index -> colinear
chaining (gap-penalised DP with bounded lookback, minimap2-style scoring) ->
banded global extension of the chained span with the native aligner ->
CIGAR/NM/AS and a chain-score-based MAPQ. Primary/secondary selection keeps
the best chain per query with mapq downweighted when the runner-up is close.

Port of ``dorado_tpu/alignment/mapper.py``: the same anchors, chains, CIGAR,
NM, MAPQ and strands, over the port's aligner (``utils/align.py``, HW mode)
and chaining (``utils/chain.py``), each built from its own C++ source.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dorado_tpu_torch.alignment.index import ReferenceIndex
from dorado_tpu_torch.alignment.minimizer import minimizers
from dorado_tpu_torch.utils.align import MODE_HW
from dorado_tpu_torch.utils.align import align as nat_align
from dorado_tpu_torch.utils.chain import chain as chain_native
from dorado_tpu_torch.utils.sequence import reverse_complement


@dataclass
class Alignment:
    ref_name: str
    ref_start: int  # 0-based
    ref_end: int
    q_start: int
    q_end: int
    is_reverse: bool
    mapq: int
    cigar: str
    nm: int
    score: int
    is_secondary: bool = False


_OPS = {0: "M", 3: "M", 1: "I", 2: "D"}  # edlib-style op -> CIGAR (M for =/X)


def _ops_to_cigar(ops: np.ndarray) -> str:
    if len(ops) == 0:
        return "*"
    syms = np.array([_OPS[o] for o in ops])
    out = []
    run_start = 0
    for i in range(1, len(syms) + 1):
        if i == len(syms) or syms[i] != syms[run_start]:
            out.append(f"{i - run_start}{syms[run_start]}")
            run_start = i
    return "".join(out)


def _chain(q_pos: np.ndarray, r_pos: np.ndarray, k: int, max_gap: int = 5000,
           lookback: int = 50) -> tuple[np.ndarray, int]:
    """Colinear chaining over anchors sorted by (r_pos, q_pos); returns the
    indices of the best chain and its score (minimap2 chaining recurrence
    with a simplified gap cost). The sequential DP runs in C++
    (csrc/chain.cpp) — a 110 kb read carries ~20k anchors, far too many
    for a Python inner loop."""
    order = np.lexsort((q_pos, r_pos))
    q = q_pos[order]
    r = r_pos[order]
    chain, score = chain_native(q, r, k, max_gap=max_gap, lookback=lookback)
    return order[chain.astype(np.int64)], int(score)


class Mapper:
    def __init__(self, index: ReferenceIndex, min_chain_anchors: int = 3,
                 min_chain_score: int = 40, max_alignments: int = 1):
        self.index = index
        self.min_chain_anchors = min_chain_anchors
        self.min_chain_score = min_chain_score
        self.max_alignments = max_alignments

    def map(self, query: str) -> list[Alignment]:
        idx = self.index
        qh, qp, qs = minimizers(query, idx.k, idx.w)
        if len(qh) == 0:
            return []
        lo, hi = idx.lookup(qh)
        counts = hi - lo
        keep = (counts > 0) & (counts <= idx.max_occ)
        if not keep.any():
            return []

        # collect anchors per (seq_id, strand) — fully vectorised: a long
        # read touches tens of thousands of index hits, far too many for a
        # Python inner loop
        qlen = len(query)
        kept = np.flatnonzero(keep)
        reps = counts[kept]
        t_idx = np.repeat(lo[kept], reps) + (
            np.arange(int(reps.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(reps) - reps, reps)
        )
        qi_all = np.repeat(kept, reps)
        sid_all = idx.seq_ids[t_idx].astype(np.int64)
        rpos_all = idx.positions[t_idx].astype(np.int64)
        strand_all = (qs[qi_all] ^ idx.strands[t_idx]).astype(np.int64)
        qpos_all = np.where(
            strand_all == 0, qp[qi_all], qlen - qp[qi_all] - idx.k
        ).astype(np.int64)

        candidates = []
        group_key = (sid_all << 1) | strand_all
        order = np.argsort(group_key, kind="stable")
        group_sorted = group_key[order]
        bounds = np.flatnonzero(
            np.concatenate([[True], group_sorted[1:] != group_sorted[:-1]])
        )
        for gi, g_lo in enumerate(bounds):
            g_hi = bounds[gi + 1] if gi + 1 < len(bounds) else len(order)
            if g_hi - g_lo < self.min_chain_anchors:
                continue
            sel = order[g_lo:g_hi]
            sid = int(sid_all[sel[0]])
            strand = int(strand_all[sel[0]])
            arr = np.stack([qpos_all[sel], rpos_all[sel]], axis=1)
            # peel chains: after taking the best chain, drop its reference
            # span's anchors and re-chain, so same-contig repeats still
            # surface as secondary candidates (minimap2 finds all chains)
            remaining = arr
            for _ in range(self.max_alignments):
                if len(remaining) < self.min_chain_anchors:
                    break
                chain_idx, score = _chain(remaining[:, 0], remaining[:, 1], idx.k)
                if (
                    len(chain_idx) < self.min_chain_anchors
                    or score < self.min_chain_score
                ):
                    break
                chain = remaining[chain_idx]
                candidates.append((score, sid, strand, chain))
                r_lo = int(chain[:, 1].min()) - idx.k
                r_hi = int(chain[:, 1].max()) + idx.k
                remaining = remaining[
                    (remaining[:, 1] < r_lo) | (remaining[:, 1] > r_hi)
                ]

        if not candidates:
            return []
        candidates.sort(key=lambda c: -c[0])

        results = []
        best_score = candidates[0][0]
        second_score = candidates[1][0] if len(candidates) > 1 else 0
        for rank, (score, sid, strand, chain) in enumerate(
            candidates[: self.max_alignments]
        ):
            q_lo = int(chain[0, 0])
            q_hi = int(chain[-1, 0]) + idx.k
            r_lo = int(chain[0, 1])
            r_hi = int(chain[-1, 1]) + idx.k

            qseq = query if strand == 0 else reverse_complement(query)
            # extend the chained span toward the query ends, but never by
            # more than the reference that exists in that direction (plus
            # slack): a read overhanging the contig end must be soft-clipped,
            # not absorbed as a giant insertion (minimap2 end handling) —
            # otherwise the banded aligner starts at band ~= the overhang.
            ref_len = int(idx.lengths[sid])
            ext_l = min(q_lo, int(r_lo * 1.1) + 64)
            ext_r = min(len(qseq) - q_hi, int((ref_len - r_hi) * 1.1) + 64)
            ql0 = q_lo - ext_l
            qhi0 = q_hi + ext_r
            r_start = max(0, r_lo - int(ext_l * 1.2) - 32)
            r_end = min(ref_len, r_hi + int(ext_r * 1.2) + 32)
            ref_seq = idx.seqs[sid][r_start:r_end]

            res = nat_align(qseq[ql0:qhi0], ref_seq, mode=MODE_HW)  # free ref end gaps
            if res.distance < 0:
                continue
            # leading/trailing insertions become soft clips (query bases that
            # consumed no reference)
            ops = res.ops
            lead = 0
            while lead < len(ops) and ops[lead] == 1:
                lead += 1
            trail = 0
            while trail < len(ops) - lead and ops[len(ops) - 1 - trail] == 1:
                trail += 1
            core = ops[lead : len(ops) - trail]
            if len(core) == 0:
                continue
            q_start = ql0 + lead
            q_end = qhi0 - trail
            clips_l = q_start
            clips_r = len(qseq) - q_end
            cigar = (
                (f"{clips_l}S" if clips_l else "")
                + _ops_to_cigar(core)
                + (f"{clips_r}S" if clips_r else "")
            )
            # primary = the first alignment that SURVIVED extension (a
            # rank-0 candidate whose extension failed must not leave the
            # read with only secondary records), and secondaries carry
            # mapq 0 rather than inheriting the primary's confidence
            is_secondary = bool(results)
            results.append(
                Alignment(
                    ref_name=idx.names[sid],
                    ref_start=r_start + res.t_start,
                    ref_end=r_start + res.t_end,
                    q_start=q_start,
                    q_end=q_end,
                    is_reverse=bool(strand),
                    mapq=0 if is_secondary else self._mapq(best_score, second_score),
                    cigar=cigar,
                    nm=int(res.distance) - lead - trail,
                    score=score,
                    is_secondary=is_secondary,
                )
            )
        return results

    @staticmethod
    def _mapq(best: float, second: float) -> int:
        if best <= 0:
            return 0
        frac = 1.0 - (second / best)
        return int(min(60, max(0, 40 * frac * min(1.0, best / 100.0) + 20 * frac)))
