"""Planted concatemers: basecalled reads of several strands joined at known
bases, for the read splitter's tests and ``chip_smoke.py``.

Each junction is a spacer base at which the signal has an open-pore spike
(well past the splitter's 5000-sample prefix), with low qualities over it
and the four bases after it, followed by a few random bases and, unless the
junction is adapter-free, the sequencing adapter with up to 3 edits. In a
duplex read each strand is the reverse complement of the one before, with up
to 10% edits; in a simplex read the strands are unrelated. Elsewhere the
signal stays below the pore threshold, but for decoy spikes inside strands,
where no adapter or flank matches (with low qualities too, so that the
splitter weighs them). Numpy only: no JAX, no torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ADAPTER = "TACTTCGTTCAGTTACGTATTGCT"
SPIKE = 4.0  # above both pore thresholds (2.4, and 2.8 for pA-scaled models)
_COMPLEMENT = str.maketrans("ACGT", "TGCA")


@dataclass
class Concatemer:
    seq: str
    qstring: str
    moves: np.ndarray  # uint8, one entry a stride
    signal: np.ndarray  # float32, len(moves) * stride samples
    junctions: list[int]  # the spacer base of each junction
    with_adapter: list[bool]  # whether each junction has an adapter

    def pieces(self, cuts: list[int]) -> list[str]:
        """The sequences of the subreads that cutting at ``cuts`` (each cut
        base dropped) leaves."""
        bounds = [-1, *cuts, len(self.seq)]
        return [self.seq[a + 1 : b] for a, b in zip(bounds, bounds[1:])]


def _random_bases(rs: np.random.RandomState, n: int) -> str:
    return "".join(rs.choice(list("ACGT"), n))


def mutate(rs: np.random.RandomState, seq: str, n_edits: int) -> str:
    """``seq`` with ``n_edits`` random substitutions, insertions and deletions."""
    out = list(seq)
    for _ in range(n_edits):
        i = int(rs.randint(0, len(out)))
        kind = rs.randint(3)
        if kind == 0:
            out[i] = "ACGT"[(("ACGT".index(out[i]) + rs.randint(1, 4)) % 4)]
        elif kind == 1:
            out.insert(i, "ACGT"[rs.randint(4)])
        elif len(out) > 1:
            del out[i]
    return "".join(out)


def concatemer(rs: np.random.RandomState, strand_lengths: list[int], stride: int,
               duplex: bool, adapter_free: tuple[int, ...] = (), quiet: tuple[int, ...] = (),
               decoys: int = 1) -> Concatemer:
    """A read of ``len(strand_lengths)`` strands; the junctions whose index is
    in ``adapter_free`` have no adapter, those in ``quiet`` no spike."""
    strands = [_random_bases(rs, strand_lengths[0])]
    for n in strand_lengths[1:]:
        if duplex:
            rc = strands[-1][::-1].translate(_COMPLEMENT)
            strands.append(mutate(rs, rc, int(rs.uniform(0, 0.1) * len(rc)))[:n])
        else:
            strands.append(_random_bases(rs, n))
    seq_parts, junctions, with_adapter = [strands[0]], [], []
    for k, strand in enumerate(strands[1:]):
        junctions.append(sum(map(len, seq_parts)))
        adapter = "" if k in adapter_free else mutate(rs, ADAPTER, int(rs.randint(0, 4)))
        with_adapter.append(bool(adapter))
        seq_parts += [_random_bases(rs, 1 + int(rs.randint(0, 6))), adapter, strand]
    seq = "".join(seq_parts)
    spikes = [b for k, b in enumerate(junctions) if k not in quiet]
    for _ in range(decoys):  # mid-strand spikes: no adapter, no flank match
        k = int(rs.randint(len(strands)))
        start = sum(map(len, seq_parts[: 3 * k + 1])) - len(strands[k])
        spikes.append(start + len(strands[k]) // 2)
    q = rs.randint(12, 30, len(seq))
    for b in spikes:
        q[b : b + 5] = 3
    qstring = (q + 33).astype(np.uint8).tobytes().decode()
    # one move a base and 0-3 stays after it
    stays = rs.randint(0, 4, len(seq))
    moves = np.zeros(len(seq) + int(stays.sum()), np.uint8)
    base_move = np.concatenate([[0], np.cumsum(stays + 1)[:-1]])
    moves[base_move] = 1
    signal = np.clip(rs.normal(0.0, 0.6, len(moves) * stride), -2.0, 2.0).astype(np.float32)
    for b in spikes:
        s0 = base_move[b] * stride
        signal[s0 : s0 + 3] = SPIKE
    return Concatemer(seq, qstring, moves, signal, junctions, with_adapter)
