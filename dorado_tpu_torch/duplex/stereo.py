"""Stereo (duplex) feature encoding.

Port of ``dorado_tpu/duplex/stereo.py`` (parity with dorado/read_pipeline/
base/stereo_features.cpp), vectorised numpy on the host as there: walk the
template-vs-RC(complement) alignment and build a 13-feature float tensor on
the expanded (per-alignment-position, max-of-both-signal-segments) time axis:

  0: template signal          1: complement signal (flipped)
  2-5: template base one-hot  6-9: complement base one-hot
  10: move table              11: template qscore  12: complement qscore

Signal segments come from stride-expanded move tables; qscores are scaled
(q-33)/90; the signal rows are padded with 0.8 times the smaller of the two
signals' minima. Per-alignment-position segment lengths from the move tables
give cumulative output offsets, and those flat gather and scatter indices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUM_FEATURES = 13
F_TEMPLATE_SIGNAL = 0
F_COMPLEMENT_SIGNAL = 1
F_TEMPLATE_BASE = 2
F_COMPLEMENT_BASE = 6
F_MOVE = 10
F_TEMPLATE_Q = 11
F_COMPLEMENT_Q = 12

_BASE_IDX = np.full(256, 0, dtype=np.int64)
for i, b in enumerate(b"ACGT"):
    _BASE_IDX[b] = i


@dataclass
class StereoFeatureInputs:
    alignment: np.ndarray  # uint8 edlib ops (0 match,1 tmpl-only,2 comp-only,3 mm)
    template_seq: str
    template_qstring: str
    template_moves: np.ndarray  # uint8 at stride resolution
    template_signal: np.ndarray  # float, model-scaled
    complement_seq: str  # ALREADY reverse-complemented
    complement_qstring: str  # original orientation (indexed reversed)
    complement_moves: np.ndarray
    complement_signal: np.ndarray  # ALREADY flipped
    signal_stride: int
    template_seq_start: int = 0
    complement_seq_start: int = 0


def _expand_moves(moves: np.ndarray, stride: int, signal_len: int) -> np.ndarray:
    out = np.zeros(signal_len, dtype=np.uint8)
    idx = np.arange(len(moves)) * stride
    out[idx[idx < signal_len]] = np.asarray(moves)[idx < signal_len]
    return out


def _reverse_complement_moves(moves_expanded: np.ndarray) -> np.ndarray:
    """Reference trick (stereo_features.cpp:75-78): append 1, reverse, pop."""
    ext = np.concatenate([moves_expanded, [1]])
    return ext[::-1][:-1].copy()


def _segments(moves_expanded: np.ndarray, start_cursor: int, count: int):
    """(starts, lengths) of the signal segment for ``count`` consecutive
    bases beginning at signal cursor ``start_cursor``.

    Each segment spans from its move position to the next move position
    inclusive (sample_count+1 in the reference's add_signal)."""
    move_pos = np.flatnonzero(moves_expanded[start_cursor + 1 :]) + start_cursor + 1
    bounds = np.concatenate([[start_cursor], move_pos, [len(moves_expanded)]])
    starts = bounds[:count]
    # segment for base k spans [move_pos_k, move_pos_{k+1}) — the reference's
    # add_signal copies sample_count+1 samples and lands exactly on the next
    # move (stereo_features.cpp:119-139)
    lengths = bounds[1 : count + 1] - starts
    return starts.astype(np.int64), lengths.astype(np.int64)


def _signal_cursor_for_base(moves_expanded: np.ndarray, base_index: int) -> int:
    """Signal index of the move that emits base ``base_index``
    (stereo_features.cpp:57-62 cursor seek)."""
    move_pos = np.flatnonzero(moves_expanded)
    return int(move_pos[base_index])


def generate_stereo_features(inp: StereoFeatureInputs) -> np.ndarray:
    """Returns float32 [13, T_stereo]."""
    stride = inp.signal_stride

    t_moves = _expand_moves(
        inp.template_moves, stride, len(inp.template_signal)
    )
    c_moves_fwd = _expand_moves(
        inp.complement_moves, stride, len(inp.complement_signal)
    )
    c_moves = _reverse_complement_moves(c_moves_fwd)

    aln = np.asarray(inp.alignment)
    consumes_template = aln != 2
    consumes_complement = aln != 1

    n_template = int(consumes_template.sum())
    n_complement = int(consumes_complement.sum())

    t_cursor = _signal_cursor_for_base(t_moves, inp.template_seq_start)
    c_cursor = _signal_cursor_for_base(c_moves, inp.complement_seq_start)

    t_starts, t_lens = _segments(t_moves, t_cursor, n_template)
    c_starts, c_lens = _segments(c_moves, c_cursor, n_complement)

    # per-alignment-position segment length = max of contributing sides
    tl = np.zeros(len(aln), dtype=np.int64)
    cl = np.zeros(len(aln), dtype=np.int64)
    tl[consumes_template] = t_lens
    cl[consumes_complement] = c_lens
    seg_len = np.maximum(tl, cl)

    offsets = np.concatenate([[0], np.cumsum(seg_len)])
    total = int(offsets[-1])

    pad_value = 0.8 * min(
        float(np.min(inp.template_signal)), float(np.min(inp.complement_signal))
    )
    features = np.zeros((NUM_FEATURES, total), dtype=np.float32)
    features[0:2] = pad_value

    def scatter_signal(feature_idx, starts, lens, out_offsets, signal):
        # flat destination indices: for row r, out_offsets[r] + arange(lens[r])
        within = np.arange(int(lens.sum())) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        dst = np.repeat(out_offsets, lens) + within
        src = np.repeat(starts, lens) + within
        features[feature_idx, dst] = np.asarray(signal, dtype=np.float32)[src]

    t_out_off = offsets[:-1][consumes_template]
    c_out_off = offsets[:-1][consumes_complement]
    scatter_signal(F_TEMPLATE_SIGNAL, t_starts, t_lens, t_out_off, inp.template_signal)
    scatter_signal(F_COMPLEMENT_SIGNAL, c_starts, c_lens, c_out_off, inp.complement_signal)

    # bases + qscores fill the FULL per-position segment (max length)
    def fill_base_q(consumes, seq, qstring, q_reversed, seq_start, base_feature, q_feature):
        pos = np.flatnonzero(consumes)
        if not len(pos):
            return
        count = len(pos)
        seq_idx = seq_start + np.arange(count)
        seq_arr = np.frombuffer(seq.encode(), dtype=np.uint8)
        q_arr = np.frombuffer(qstring.encode(), dtype=np.uint8)
        bases = _BASE_IDX[seq_arr[seq_idx]]
        qv = (
            q_arr[len(q_arr) - 1 - seq_idx] if q_reversed else q_arr[seq_idx]
        ).astype(np.float32)
        qv = (qv - 33.0) / 90.0

        lens = seg_len[pos]
        out_off = offsets[:-1][pos]
        within = np.arange(int(lens.sum())) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        dst = np.repeat(out_off, lens) + within
        features[base_feature + np.repeat(bases, lens), dst] = 1.0
        features[q_feature, dst] = np.repeat(qv, lens)

    fill_base_q(
        consumes_template,
        inp.template_seq,
        inp.template_qstring,
        False,
        inp.template_seq_start,
        F_TEMPLATE_BASE,
        F_TEMPLATE_Q,
    )
    fill_base_q(
        consumes_complement,
        inp.complement_seq,
        inp.complement_qstring,
        True,
        inp.complement_seq_start,
        F_COMPLEMENT_BASE,
        F_COMPLEMENT_Q,
    )

    features[F_MOVE, offsets[:-1]] = 1.0
    return features
