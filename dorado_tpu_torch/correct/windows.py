"""Window extraction for read correction (port of
``dorado_tpu/correct/windows.py``: numpy, the same pieces in the same order).

Parity with dorado/correct/windows.cpp (itself derived from HERRO's
windowing.rs): the target read is cut into fixed ``window_size`` chunks,
each full-read alignment is split into per-window pieces by one walk of
its CIGAR (split_alignment, windows.cpp:365-590), per-window pieces are
scored by alignment accuracy and the TOP_K most accurate kept
(features.cpp:437-452), and overhang windows at the read ends are only
admitted for alignments starting/ending within 10% of the window size
(extract_windows, windows.cpp:133-200).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from dorado_tpu_torch.correct.features import TOP_K, WindowOverlap

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class _Aln:
    seq: str  # fwd-oriented query sequence
    qual: np.ndarray
    cigar: str
    tstart: int
    fwd: bool
    qname: str = ""


def _split_alignment(aln: _Aln, windows: list[tuple[int, int]]):
    """One CIGAR walk -> {win_idx: WindowOverlap piece}
    (split_alignment, windows.cpp:365-590). M/D runs split at window
    boundaries; insertions belong to the window holding the preceding
    target base; the query sub-range is sliced per window."""
    ops = [(int(n), op) for n, op in _CIGAR_RE.findall(aln.cigar)]
    pieces: dict[int, list] = {}  # win_idx -> [ops, qstart, qend, tstart]
    tpos = aln.tstart
    qpos = 0

    def win_of(t):
        for i, (ws, we) in enumerate(windows):
            if ws <= t < we:
                return i
        return None

    def add(widx, n, op, q_advance):
        nonlocal qpos
        if widx is not None:
            if widx not in pieces:
                pieces[widx] = [[], qpos, qpos, tpos]
            p = pieces[widx]
            if p[0] and p[0][-1][1] == op:
                p[0][-1][0] += n
            else:
                p[0].append([n, op])
            p[2] = qpos + (n if q_advance else 0)
        if q_advance:
            qpos += n

    for n, op in ops:
        if op in "M=X":
            while n > 0:
                widx = win_of(tpos)
                if widx is None:
                    break
                we = windows[widx][1]
                take = min(n, we - tpos)
                add(widx, take, "M", True)
                tpos += take
                n -= take
            if n > 0:  # ran past the last window
                qpos += n
                tpos += n
        elif op in "DN":
            while n > 0:
                widx = win_of(tpos)
                if widx is None:
                    break
                we = windows[widx][1]
                take = min(n, we - tpos)
                add(widx, take, "D", False)
                tpos += take
                n -= take
            if n > 0:
                tpos += n
        elif op == "I":
            add(win_of(tpos - 1), n, "I", True)
        elif op == "S":
            qpos += n

    out = {}
    for widx, (wops, qs, qe, ts) in pieces.items():
        cig = "".join(f"{n}{op}" for n, op in wops)
        out[widx] = WindowOverlap(
            seq=aln.seq[qs:qe],
            qual=aln.qual[qs:qe],
            cigar=cig,
            tstart=max(ts, windows[widx][0]),
            fwd=aln.fwd,
        )
    return out


def _accuracy(target: str, piece: WindowOverlap) -> float:
    """match / (match + miss + ins + del) over the window piece
    (calculate_accuracy, features.cpp:47-94)."""
    n_match = n_miss = n_ins = n_del = 0
    tpos = piece.tstart
    qpos = 0
    for n, op in _CIGAR_RE.findall(piece.cigar):
        n = int(n)
        if op in "M=X":
            for j in range(n):
                if (
                    tpos + j < len(target)
                    and qpos + j < len(piece.seq)
                    and target[tpos + j] == piece.seq[qpos + j]
                ):
                    n_match += 1
                else:
                    n_miss += 1
            tpos += n
            qpos += n
        elif op == "I":
            n_ins += n
            qpos += n
        elif op in "DN":
            n_del += n
            tpos += n
    total = n_match + n_miss + n_ins + n_del
    return n_match / total if total else 0.0


def extract_windows(
    target: str,
    alignments: list[_Aln],
    window_size: int = 4096,
) -> list[tuple[int, int, list[WindowOverlap]]]:
    """[(win_tstart, win_len, top-K overlap pieces)] per window.

    Mirrors extract_windows (windows.cpp:133-200): alignments spanning less
    than a window on either axis are skipped, edge windows only accept
    alignments reaching within 10% of the read ends, and each window keeps
    the TOP_K pieces by accuracy (features.cpp:437-452). Deviation for
    short reads: the effective window is ``min(window_size, len(target))``
    so sub-window targets still correct (the reference only ever sees
    window-sized reads after its own length filters)."""
    tlen = len(target)
    if tlen == 0:
        return []
    wsize = min(window_size, tlen)
    bounds = [(s, min(tlen, s + wsize)) for s in range(0, tlen, wsize)]
    per_window: list[list[tuple[float, str, WindowOverlap]]] = [
        [] for _ in bounds
    ]

    zeroth_thresh = int(0.1 * wsize)
    nth_thresh = tlen - zeroth_thresh

    for aln in alignments:
        tstart = aln.tstart
        tend = tstart
        qspan = 0
        for n, op in _CIGAR_RE.findall(aln.cigar):
            n = int(n)
            if op in "M=X":
                tend += n
                qspan += n
            elif op in "DN":
                tend += n
            elif op == "I":
                qspan += n
        if (tend - tstart) < wsize or qspan < wsize:
            continue
        # edge-overhang admission (windows.cpp:158-168)
        first_window = 0 if tstart < zeroth_thresh else (tstart + wsize - 1) // wsize
        last_window = (
            (tend - 1) // wsize + 1 if tend > nth_thresh else tend // wsize
        )
        if first_window >= last_window:
            continue
        pieces = _split_alignment(aln, bounds)
        for widx in range(first_window, min(last_window, len(bounds))):
            piece = pieces.get(widx)
            if piece is None or not piece.cigar:
                continue
            per_window[widx].append((_accuracy(target, piece), aln.qname, piece))

    out = []
    for (ws, we), cands in zip(bounds, per_window):
        # accuracy desc, qname asc for deterministic ties
        cands.sort(key=lambda t: (-t[0], t[1]))
        out.append((ws, we - ws, [p for _, _, p in cands[:TOP_K]]))
    return out
