"""MM/ML/MN modified-base tags.

Port of ``dorado_tpu/modbase/tags.py`` for simplex and duplex reads
(parity: dorado/read_pipeline/base/messages.cpp:182-338 generate_modbase_tags
and dorado/modbase/ModBaseContext.cpp's mask).
"""

from __future__ import annotations

import numpy as np

from dorado_tpu_torch.modbase.caller import CARDINAL_BASES, ModBaseInfo
from dorado_tpu_torch.modbase.motif import MotifMatcher
from dorado_tpu_torch.utils.sequence import reverse_complement

_BASE_TO_INT = {b: i for i, b in enumerate(CARDINAL_BASES)}
_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _decode_context(context: str) -> list[tuple[str, int] | None]:
    """A "CX:_:_:_"-style context string -> each base's (motif, offset)."""
    tokens = context.split(":")
    if len(tokens) != 4:
        raise ValueError(f"invalid modbase context string {context!r}")
    out: list[tuple[str, int] | None] = []
    for i, tok in enumerate(tokens):
        if tok == "_":
            out.append(None)
        else:
            x = tok.find("X")
            if x < 0:
                raise ValueError(f"invalid context token {tok!r}")
            out.append((tok[:x] + CARDINAL_BASES[i] + tok[x + 1 :], x))
    return out


def _sequence_mask(seq: str, contexts) -> np.ndarray:
    mask = np.zeros(len(seq), dtype=bool)
    for ctx in contexts:
        if ctx is not None:
            for hit in MotifMatcher(*ctx).get_motif_hits(seq):
                mask[hit] = True
    return mask


def _update_mask(
    mask: np.ndarray, seq: str, alphabet: list[str], probs: np.ndarray, threshold: int, contexts
) -> None:
    """A cardinal base without a context is kept where any of its
    modifications' probabilities reaches ``threshold``
    (ModBaseContext::update_mask)."""
    num_channels = len(alphabet)
    current_cardinal = None
    adjustments: dict[str, list[int]] = {}
    for ch, code in enumerate(alphabet):
        if code in CARDINAL_BASES:
            current_cardinal = code
        elif contexts[_BASE_TO_INT[current_cardinal]] is None:
            adjustments.setdefault(current_cardinal, []).append(ch)
    if not adjustments:
        return
    seq_arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    probs2d = probs.reshape(-1, num_channels)
    for base, channels in adjustments.items():
        sel = seq_arr == ord(base)
        flag = (probs2d[:, channels] >= threshold).any(axis=1)
        mask[sel] = flag[sel]


def generate_modbase_tags(
    seq: str,
    base_mod_probs: np.ndarray,
    info: ModBaseInfo,
    motif_hits: np.ndarray | None,
    threshold: int,
    is_duplex: bool = False,
) -> tuple[str, np.ndarray, int]:
    """(MM string, ML uint8 array, MN value) of a read.

    A duplex read (``is_duplex``) carries both strands' calls: its include
    mask is the sequence's motif mask (not ``motif_hits``, messages.cpp:202)
    combined with the reverse complement's (over the reverse-complemented
    sequence and row-reversed probabilities), and after the '+' channels
    every modification comes again on the complement cardinal with a '-'
    strand flag (messages.cpp:223-330)."""
    num_channels = info.num_states
    if len(seq) * num_channels != base_mod_probs.size:
        raise ValueError("base_mod_probs size mismatch")

    contexts = _decode_context(info.context) if info.context else [None] * 4
    # a single-base motif is no context for the MM flag: '.' rather than '?'
    # (messages.cpp:212-214), though its motif mask and the update_mask skip
    # still apply (ModBaseContext.cpp:115-119)
    base_has_context = [c is not None and len(c[0]) > 1 for c in contexts]

    if not is_duplex and motif_hits is not None and len(motif_hits):
        mask = np.asarray(motif_hits, dtype=bool).copy()
    else:
        mask = _sequence_mask(seq, contexts)
    _update_mask(mask, seq, info.alphabet, base_mod_probs, threshold, contexts)
    if is_duplex:
        rc_seq = reverse_complement(seq)
        mask_rc = _sequence_mask(rc_seq, contexts)
        probs_rev = np.ascontiguousarray(base_mod_probs.reshape(-1, num_channels)[::-1])
        _update_mask(mask_rc, rc_seq, info.alphabet, probs_rev.reshape(-1), threshold, contexts)
        mask = mask | mask_rc[::-1]

    seq_arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    probs2d = base_mod_probs.reshape(-1, num_channels)
    ml: list[int] = []
    parts = []
    for strand in ("+", "-") if is_duplex else ("+",):
        current_cardinal = None
        for ch, code in enumerate(info.alphabet):
            if code in CARDINAL_BASES:
                current_cardinal = code
                continue
            cardinal = current_cardinal if strand == "+" else _COMPLEMENT[current_cardinal]
            head = f"{cardinal}{strand}{code}"
            head += "?" if base_has_context[_BASE_TO_INT[current_cardinal]] else "."
            positions = np.flatnonzero(seq_arr == ord(cardinal))
            # skipped-base counts between the included positions of the cardinal
            deltas = []
            skipped = 0
            for pos, inc in zip(positions, mask[positions]):
                if inc:
                    deltas.append(skipped)
                    skipped = 0
                    ml.append(int(probs2d[pos, ch]))
                else:
                    skipped += 1
            parts.append(head + "".join(f",{d}" for d in deltas) + ";")
    return "".join(parts), np.asarray(ml, dtype=np.uint8), len(seq)


def modbase_threshold_uint8(threshold_frac: float) -> int:
    """--modified-bases-threshold as a fraction -> the uint8 score threshold
    (ReadToBamTypeNode.cpp:93-98)."""
    return int(min(threshold_frac * 256.0, 255.0))
