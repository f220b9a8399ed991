"""Duplex modified-base calling.

Port of ``dorado_tpu/duplex/modbase.py`` (after ModBaseCallerNode::
duplex_mod_call, dorado/read_pipeline/nodes/ModBaseCallerNode.cpp:155-300):
each strand's simplex signal is reused by realigning its move table onto
the duplex consensus (the template's direction: the duplex as it is; the
complement's: the reverse-complemented duplex against the complement call
in its own orientation), the modbase models run on the realigned windows of
both strands in one ``call_reads``, and the two directions' probabilities
merge into one [len(duplex) * num_states] array. The complement direction's
hits land at reverse-complemented duplex positions, their channels already
indexed by the complement base (ModBaseCallerNode.cpp:552-560).
"""

from __future__ import annotations

import numpy as np

from dorado_tpu_torch.modbase.encode import sequence_to_ints
from dorado_tpu_torch.utils.align import EDOP_INSERT, EDOP_MATCH, EDOP_MISMATCH, MODE_HW, align
from dorado_tpu_torch.utils.sequence import reverse_complement


def realign_moves(
    query_seq: str, target_seq: str, moves: np.ndarray
) -> tuple[int, int, np.ndarray]:
    """Remap a move table from ``query_seq`` (the simplex call the signal
    belongs to) onto ``target_seq`` (the duplex consensus).

    Returns (old_moves_offset, target_start, new_moves): the block of the
    old move table where the remapped window starts, the offset into
    ``target_seq`` of its first base, and the new move table (one entry per
    signal block of the window); (-1, -1, empty) when no usable alignment
    exists. As utils::realign_moves (dorado/utils/sequence_utils.cpp:
    327-440), with ``utils.align``'s infix alignment in place of the
    minimap2 overlap and edlib pair."""
    failed = (-1, -1, np.zeros(0, np.uint8))
    moves = np.asarray(moves, np.uint8)
    if not query_seq or not target_seq or not moves.any():
        return failed

    # infix alignment of the duplex consensus inside the simplex call (free
    # gaps at the simplex ends: both strands cover the duplex span)
    res = align(target_seq, query_seq, mode=MODE_HW)
    ops = np.asarray(res.ops, np.uint8)
    if len(ops) == 0:
        return failed

    # advance to the first exactly matching base (sequence_utils.cpp:351-358)
    di = 0  # position in target_seq (duplex)
    si = int(res.t_start)  # position in query_seq (simplex)
    k = 0
    while k < len(ops) and ops[k] != EDOP_MATCH:
        if ops[k] == EDOP_MISMATCH:
            di += 1
            si += 1
        elif ops[k] == EDOP_INSERT:  # a duplex base only
            di += 1
        else:  # a simplex base only
            si += 1
        k += 1
    if k == len(ops):
        return failed
    target_start = di

    ones = np.flatnonzero(moves)
    if si >= len(ones):
        return failed
    old_moves_offset = int(ones[si])

    # walk the alignment, rebuilding the move table in duplex space
    # (sequence_utils.cpp:383-437, with the resync after an insertion that
    # lets an inserted duplex base borrow its neighbours' signal)
    new_moves: list[int] = []
    old_cursor = old_moves_offset
    n_old = len(moves)
    for op in ops[k:]:
        if op == EDOP_MATCH or op == EDOP_MISMATCH:
            new_moves.append(1)
            old_cursor += 1
            while old_cursor < n_old and moves[old_cursor] == 0:
                if old_cursor < old_moves_offset + len(new_moves):
                    old_cursor += 1  # resync after an earlier insertion
                else:
                    new_moves.append(0)
                    old_cursor += 1
        elif op == EDOP_INSERT:  # a duplex base with no simplex counterpart
            new_moves.append(1)
        else:  # EDOP_DELETE: a simplex base with no duplex one; its blocks stay
            new_moves.append(0)
            old_cursor += 1
            while old_cursor < n_old and moves[old_cursor] == 0:
                new_moves.append(0)
                old_cursor += 1
    return old_moves_offset, target_start, np.asarray(new_moves, np.uint8)


def call_duplex_mods(
    caller,
    duplex_seq: str,
    stride: int,
    template_seq: str,
    template_moves: np.ndarray,
    template_signal: np.ndarray,
    complement_seq: str,
    complement_moves: np.ndarray,
    complement_signal: np.ndarray,
) -> np.ndarray:
    """Modified-base probabilities of a duplex read, both directions.

    The complement's three inputs are in its call's own orientation: the
    complement direction aligns the reverse-complemented duplex onto that
    call (the reference keeps the stereo inputs reverse-complemented and
    flipped, and undoes both for the mod call, ModBaseCallerNode.cpp:
    188-208). Returns uint8 [len(duplex_seq) * num_states], initialised
    canonical: the reference gives every duplex read its probabilities once
    mod models are loaded, also where a direction fails to realign or no
    motif occurs. Both directions' chunks go to one ``caller.call_reads``."""
    num_states = caller.info.num_states
    n = len(duplex_seq)
    probs = caller.init_canonical_probs(sequence_to_ints(duplex_seq))
    if n == 0:
        return probs

    prepared = []
    metas = []  # (is_template, t_start)
    strands = (
        (True, template_seq, template_moves, template_signal, duplex_seq),
        (False, complement_seq, complement_moves, complement_signal,
         reverse_complement(duplex_seq)),
    )
    for is_template, simplex_seq, simplex_moves, simplex_signal, duplex_dir in strands:
        moves_offset, t_start, new_moves = realign_moves(
            simplex_seq, duplex_dir, np.asarray(simplex_moves, np.uint8)
        )
        if moves_offset < 0 or len(new_moves) == 0:
            continue
        sig_lo = moves_offset * stride
        window = np.ascontiguousarray(
            np.asarray(simplex_signal)[sig_lo : sig_lo + len(new_moves) * stride]
        )
        # the window may end at the signal's end: trim the move table with it
        usable_blocks = len(window) // stride
        if usable_blocks == 0:
            continue
        new_moves = new_moves[:usable_blocks]
        window = window[: usable_blocks * stride]
        num_bases = int(new_moves.sum())
        if num_bases == 0:
            continue
        new_seq = duplex_dir[t_start : t_start + num_bases]
        prepared.append(caller.prepare_read(new_seq, new_moves, window))
        metas.append((is_template, t_start))

    if prepared:
        for result, (is_template, t_start) in zip(caller.call_reads(prepared), metas):
            for p in np.flatnonzero(result.motif_hits):
                p = int(p)
                dpos = t_start + p if is_template else n - (p + t_start + 1)
                if 0 <= dpos < n:
                    probs[dpos * num_states : (dpos + 1) * num_states] = (
                        result.base_mod_probs[p * num_states : (p + 1) * num_states]
                    )
    return probs
