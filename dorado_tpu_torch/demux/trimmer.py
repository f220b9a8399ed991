"""Record trimming: apply a retained [start, end) interval to sequence,
qstring, move table, ts/ns tags and MM/ML modbase info.

Port of ``dorado_tpu/demux/trimmer.py`` over the port's ``io/sam.py``
(parity: dorado/demux/Trimmer.cpp trim_sequence,
dorado/torch_utils/trim.cpp trim_move_table / trim_modbase_info)."""

from __future__ import annotations

import numpy as np

from dorado_tpu_torch.io.sam import SamRecord, SamTag


def trim_move_table(moves: np.ndarray, interval: tuple[int, int]) -> tuple[int, np.ndarray]:
    """(positions trimmed from front, trimmed moves)."""
    start, end = interval
    moves = np.asarray(moves, dtype=np.uint8)
    if moves.size == 0 or end <= start:
        return 0, np.zeros(0, dtype=np.uint8)
    seq_pos = np.cumsum(moves) - 1  # base index each move position belongs to
    keep = (seq_pos >= start) & (seq_pos < end)
    n_front = int(np.searchsorted(seq_pos, start, side="left"))
    return n_front, moves[keep]


def trim_modbase_info(
    seq: str, mm: str, ml: np.ndarray, interval: tuple[int, int]
) -> tuple[str, np.ndarray]:
    """Adjust MM delta-counts and ML probs for a trimmed [start, end) of seq
    (torch_utils/trim.cpp trim_modbase_info)."""
    start, end = interval
    if not mm:
        return "", np.zeros(0, dtype=np.uint8)

    counts_start: dict[str, int] = {}
    for c in seq[:start]:
        counts_start[c] = counts_start.get(c, 0) + 1
    counts_end: dict[str, int] = {}
    for c in seq[:end]:
        counts_end[c] = counts_end.get(c, 0) + 1

    out_parts = []
    out_probs: list[int] = []
    prob_pos = 0
    for mod in mm.split(";"):
        if not mod:
            continue
        fields = mod.split(",")
        prefix = fields[0]
        cardinal = prefix[0]
        card_start = counts_start.get(cardinal, 0)
        card_end = counts_end.get(cardinal, 0)
        seen = 0
        found_start = False
        kept = []
        for f in fields[1:]:
            skips = int(f)
            seen += skips
            if seen >= card_end:
                pass  # trimmed from the end
            elif seen >= card_start:
                if not found_start:
                    kept.append(seen - card_start)
                    found_start = True
                else:
                    kept.append(skips)
                out_probs.append(int(ml[prob_pos]) if prob_pos < len(ml) else 0)
            seen += 1  # the modified base itself is a cardinal base
            prob_pos += 1
        out_parts.append(prefix + "".join(f",{k}" for k in kept) + ";")
    return "".join(out_parts), np.asarray(out_probs, dtype=np.uint8)


def _get_tag(rec: SamRecord, name: str):
    for t in rec.tags:
        if t.tag == name:
            return t
    return None


def _set_tag(rec: SamRecord, name: str, typ: str, value, subtype: str = "") -> None:
    t = _get_tag(rec, name)
    if t is None:
        rec.tags.append(SamTag(name, typ, value, subtype=subtype))
    else:
        t.type, t.value, t.subtype = typ, value, subtype


def _del_tag(rec: SamRecord, name: str) -> None:
    rec.tags = [t for t in rec.tags if t.tag != name]


def trim_record(rec: SamRecord, interval: tuple[int, int], is_rna: bool = False) -> SamRecord:
    """Trim a record in place to the retained interval (forward orientation)."""
    start, end = interval
    seq = rec.seq if rec.seq != "*" else ""
    n = len(seq)
    if end <= start or (start == 0 and end >= n):
        return rec

    rec.seq = seq[start:end]
    if rec.qual != "*":
        rec.qual = rec.qual[start:end]

    mv_tag = _get_tag(rec, "mv")
    ts_tag = _get_tag(rec, "ts")
    ns_tag = _get_tag(rec, "ns")
    if mv_tag is not None and len(mv_tag.value) > 1:
        stride = int(mv_tag.value[0])
        moves = np.asarray(mv_tag.value[1:], dtype=np.uint8)
        mv_interval = (n - end, n - start) if is_rna else (start, end)
        n_front, trimmed = trim_move_table(moves, mv_interval)
        ts = int(ts_tag.value) if ts_tag is not None else -1
        if ts >= 0:
            ts += n_front * stride
            _set_tag(rec, "ts", "i", ts)
        if ns_tag is not None:
            _set_tag(rec, "ns", "i", int(len(trimmed) * stride) + max(0, ts))
        mv = np.concatenate([[np.uint8(stride)], trimmed])
        _set_tag(rec, "mv", "B", mv, subtype="c")

    mm_tag = _get_tag(rec, "MM")
    ml_tag = _get_tag(rec, "ML")
    if mm_tag is not None:
        ml = np.asarray(ml_tag.value, dtype=np.uint8) if ml_tag is not None else np.zeros(0, np.uint8)
        new_mm, new_ml = trim_modbase_info(seq, mm_tag.value, ml, (start, end))
        _set_tag(rec, "MM", "Z", new_mm)
        _set_tag(rec, "ML", "B", new_ml, subtype="C")
        _set_tag(rec, "MN", "i", len(rec.seq))
    return rec
