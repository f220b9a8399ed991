"""HERRO-style correction window features (port of
``dorado_tpu/correct/features.py``: numpy, the same arrays and strings).

Parity with dorado/correct/features.cpp + conversions.cpp: each window of
the target read becomes a [1 + TOP_K, L] base/qual matrix over an
insertion-expanded axis, where bases use the "ACGT*acgt#." encoding
(uppercase = forward aligned read, lowercase = reverse, '*'/'#' = gap on
fwd/rev, '.' = no coverage), and quals are normalised to [-1, 1]
(conversions.cpp:8). "Supported" columns (features.cpp:346-388) — where at
least two symbols have count >= 3 — are the positions the NN predicts;
everything else falls to the majority-vote decode (decode.cpp:43-135).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

TOP_K = 30  # features.cpp:24
MAX_INDEL_LEN = 30
MIN_QSCORE, MAX_QSCORE = 33.0, 126.0

BASES = "ACGT*acgt#."
ENC = {b: i for i, b in enumerate(BASES)}
DEC = list(BASES)
PAD = ENC["."]
GAP_FWD = ENC["*"]
GAP_REV = ENC["#"]
# forward-mapping: case-fold and '#'->'*' (conversions.cpp:10-23)
FWD_MAP = [ENC[b.upper() if b not in "#." else ("*" if b == "#" else ".")] for b in BASES]
# encoding -> 5-class index "ACGT*" (decode.cpp:46-59)
ENC_TO_IDX = [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0]

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def normalize_quals(q: np.ndarray | float):
    return 2.0 * (np.asarray(q, np.float32) - MIN_QSCORE) / (MAX_QSCORE - MIN_QSCORE) - 1.0


@dataclass
class WindowFeatures:
    bases: np.ndarray  # [1+TOP_K, L] int32
    quals: np.ndarray  # [1+TOP_K, L] float32
    supported: list  # [(tpos, ins)]
    indices: np.ndarray  # [S] column index per supported position
    n_alns: int
    win_tstart: int
    inferred_bases: str = ""


@dataclass
class WindowOverlap:
    """One aligned query restricted to a target window."""

    seq: str  # query subsequence, already fwd-oriented w.r.t. target
    qual: np.ndarray  # phred+33 floats aligned to seq
    cigar: str  # target-vs-query cigar covering the window
    tstart: int  # target start of this piece (absolute)
    fwd: bool


def get_max_ins_for_window(
    overlaps: list[WindowOverlap], win_tstart: int, win_len: int
) -> np.ndarray:
    """Max insertion run after each target position (features.cpp:102-146)."""
    max_ins = np.zeros(win_len, np.int32)
    for ov in overlaps:
        tpos = ov.tstart - 1
        for n, op in _CIGAR_RE.findall(ov.cigar):
            n = int(n)
            if op in "M=X":
                tpos += n
            elif op in "DN":
                tpos += n
            elif op == "I":
                idx = tpos - win_tstart
                if 0 <= idx < win_len:
                    max_ins[idx] = max(max_ins[idx], n)
            # S consumes query only; handled during fill
    return max_ins


def get_features_for_window(
    target_seq: str,
    target_qual: np.ndarray,
    overlaps: list[WindowOverlap],
    win_tstart: int,
    win_len: int,
) -> WindowFeatures:
    """Build the [1+TOP_K, L] window matrix (features.cpp:148-344)."""
    overlaps = overlaps[:TOP_K]
    max_ins = get_max_ins_for_window(overlaps, win_tstart, win_len)
    length = int(max_ins.sum()) + win_len
    reads = 1 + TOP_K

    bases = np.full((reads, length), PAD, np.int32)
    quals = np.full((reads, length), normalize_quals(ord("!")), np.float32)

    # column offset of each target position in the expanded axis
    col_of = np.zeros(win_len + 1, np.int64)
    col_of[1:] = np.cumsum(1 + max_ins)

    # target row: gaps between bases at insertion columns (features.cpp:180)
    bases[0, :] = GAP_FWD
    for i in range(win_len):
        bases[0, col_of[i]] = ENC.get(target_seq[win_tstart + i], PAD)
        quals[0, col_of[i]] = normalize_quals(float(target_qual[win_tstart + i]))

    for w, ov in enumerate(overlaps):
        row = w + 1
        gap = GAP_FWD if ov.fwd else GAP_REV
        offset = ov.tstart - win_tstart
        bases[row, :] = gap
        if offset > 0:
            bases[row, : col_of[offset]] = PAD

        tpos = offset
        qpos = 0
        col = int(col_of[offset]) if offset >= 0 else 0
        enc_case = (lambda b: ENC.get(b, PAD)) if ov.fwd else (
            lambda b: ENC.get(b.lower(), PAD)
        )
        for n, op in _CIGAR_RE.findall(ov.cigar):
            n = int(n)
            if op in "M=X":
                for j in range(n):
                    if 0 <= tpos + j < win_len:
                        c = col_of[tpos + j]
                        if qpos + j < len(ov.seq):
                            bases[row, c] = enc_case(ov.seq[qpos + j])
                            quals[row, c] = normalize_quals(float(ov.qual[qpos + j]))
                tpos += n
                qpos += n
            elif op == "I":
                anchor = tpos - 1
                if 0 <= anchor < win_len:
                    base_col = col_of[anchor]
                    for j in range(min(n, int(max_ins[anchor]))):
                        if qpos + j < len(ov.seq):
                            bases[row, base_col + 1 + j] = enc_case(ov.seq[qpos + j])
                            quals[row, base_col + 1 + j] = normalize_quals(
                                float(ov.qual[qpos + j])
                            )
                qpos += n
            elif op in "DN":
                tpos += n  # leaves gap encoding in place
            elif op == "S":
                qpos += n
        # positions past the overlap's end revert to pad
        if tpos < win_len:
            bases[row, col_of[tpos] :] = PAD

    supported = get_supported(bases)
    indices = get_indices(bases, supported)
    return WindowFeatures(
        bases=bases,
        quals=quals,
        supported=supported,
        indices=indices,
        n_alns=len(overlaps),
        win_tstart=win_tstart,
    )


def get_supported(bases: np.ndarray) -> list:
    """Columns where >= 2 forward-folded symbols occur >= 3 times
    (features.cpp:346-388)."""
    reads, length = bases.shape
    supported = []
    tpos, ins = -1, 0
    fwd_map = np.asarray(FWD_MAP)
    folded = fwd_map[bases]  # [R, L]
    for c in range(length):
        if bases[0, c] == GAP_FWD:
            ins += 1
        else:
            tpos += 1
            ins = 0
        col = folded[:, c]
        col = col[bases[:, c] != PAD]
        counts = np.bincount(col, minlength=len(BASES))
        if (counts >= 3).sum() >= 2:
            supported.append((tpos, ins))
    return supported


def get_indices(bases: np.ndarray, supported: list) -> np.ndarray:
    """Supported (tpos, ins) -> expanded column index (features.cpp:392-412)."""
    target_cols = np.flatnonzero(bases[0] != GAP_FWD)
    return np.asarray(
        [int(target_cols[pos]) + ins for pos, ins in supported], np.int32
    )


def decode_window(wf: WindowFeatures) -> str:
    """Model predictions at supported positions; majority vote elsewhere
    (decode.cpp:43-135)."""
    if wf.n_alns < 2:
        return ""
    bases_map = dict(zip(wf.supported, wf.inferred_bases))
    bases = wf.bases
    reads = wf.n_alns + 1
    length = bases.shape[1]
    out = []
    tpos, ins = -1, 0
    for c in range(length):
        tbase = int(bases[0, c])
        if DEC[tbase] == "*":
            ins += 1
        else:
            tpos += 1
            ins = 0
        found = bases_map.get((tpos, ins))
        if found is not None:
            if found != "*":
                out.append(found)
            continue
        counts = np.zeros(5, np.int64)
        rep = np.zeros(5, np.int64)
        for r in range(reads):
            b = int(bases[r, c])
            if DEC[b] == ".":
                continue
            idx = ENC_TO_IDX[b]
            rep[idx] = b
            counts[idx] += 1
        order = np.argsort(-counts, kind="stable")
        first, second = order[0], order[1]
        if counts[first] < 2 or (
            counts[first] == counts[second]
            and (first == ENC_TO_IDX[tbase] or second == ENC_TO_IDX[tbase])
        ):
            new_base = DEC[tbase]
        else:
            new_base = DEC[int(rep[first])]
        new_base = DEC[FWD_MAP[ENC[new_base]]]
        if new_base != "*":
            out.append(new_base)
    return "".join(out)
