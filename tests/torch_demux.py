"""Seeded barcoded reads for the demux, trim and poly(A) tests and
``chip_smoke.py`` (numpy and the port only): a kit's front context
(flank, barcode, flank) before an insert and, for a double-ended kit, its
reverse complement after it, with substitutions, deletions and insertions
at a given rate."""

from __future__ import annotations

import numpy as np

from dorado_tpu_torch.demux.adapters import ADAPTERS
from dorado_tpu_torch.demux.barcoder import get_barcode_sequence, get_kit_info
from dorado_tpu_torch.io.sam import SamRecord, SamTag
from dorado_tpu_torch.utils.sequence import reverse_complement

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_seq(rng: np.random.RandomState, n: int) -> str:
    return BASES[rng.randint(0, 4, n)].tobytes().decode()


def mutate(rng: np.random.RandomState, seq: str, rate: float) -> str:
    """A third each of ``rate`` substitutions (by another base), deletions
    and insertions (of a random base after the base)."""
    arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    r = rng.rand(len(arr))
    out = arr.copy()
    sub = r < rate / 3
    index = np.searchsorted(BASES, arr[sub])
    out[sub] = BASES[(index + rng.randint(1, 4, int(sub.sum()))) % 4]
    counts = np.where(r < rate / 3, 1, np.where(r < 2 * rate / 3, 0, np.where(r < rate, 2, 1)))
    expanded = np.repeat(out, counts)
    inserted = (np.cumsum(counts) - 1)[counts == 2]
    expanded[inserted] = BASES[rng.randint(0, 4, len(inserted))]
    return expanded.tobytes().decode()


def barcoded_read(rng, kit_name: str, barcode_name: str, insert_len: int = 600,
                  error: float = 0.0, custom: dict | None = None, kit_info: dict | None = None,
                  both_ends: bool | None = None) -> str:
    """20 random bases, the front context, the insert, the rear context
    (double-ended kits, or ``both_ends``), 10 random bases; then errors. A
    rear-only kit's context follows the insert instead."""
    info = kit_info or get_kit_info(kit_name)
    bc = get_barcode_sequence(barcode_name, custom)
    front = info["top_front_flank"] + bc + info["top_rear_flank"]
    if info["rear_only_barcodes"]:
        read = random_seq(rng, insert_len) + front
        return mutate(rng, random_seq(rng, 20) + read + random_seq(rng, 10), error)
    read = front + random_seq(rng, insert_len)
    if info["double_ends"] if both_ends is None else both_ends:
        i = info["barcodes"].index(barcode_name)
        if info["ends_different"]:
            bc2 = get_barcode_sequence(info["barcodes2"][i], custom)
            rear = info["bottom_front_flank"] + bc2 + info["bottom_rear_flank"]
        else:
            rear = front
        read += reverse_complement(rear)
    read = random_seq(rng, 20) + read + random_seq(rng, 10)
    return mutate(rng, read, error) if error > 0 else read


def planted_records(seed: int, kit_name: str, n: int, lengths=(1_000, 10_001),
                    error: float = 0.05, unbarcoded: float = 0.1, stride: int = 5,
                    adapters: bool = False):
    """``n`` records of ``kit_name`` barcodes with a move table (stride
    ``stride``, a base every 1-3 steps) and qualities, a share
    ``unbarcoded`` of them with no barcode, and with ``adapters`` the LSK110
    adapters outside (before the errors); and each record's planted barcode
    name (None for the unbarcoded)."""
    rng = np.random.RandomState(seed)
    info = get_kit_info(kit_name)
    records, truth = [], []
    for i in range(n):
        insert = int(rng.randint(*lengths))
        front, rear = ADAPTERS["LSK110"] if adapters else ("", "")
        if rng.rand() < unbarcoded:
            name, seq = None, mutate(rng, front + random_seq(rng, insert) + rear, error)
        else:
            name = info["barcodes"][rng.randint(len(info["barcodes"]))]
            seq = mutate(rng, front + barcoded_read(rng, kit_name, name, insert) + rear, error)
        steps = rng.randint(1, 4, len(seq))
        moves = np.zeros(int(steps.sum()), dtype=np.uint8)
        moves[np.concatenate([[0], np.cumsum(steps)[:-1]])] = 1
        qual = (rng.randint(5, 40, len(seq)) + 33).astype(np.uint8).tobytes().decode()
        records.append(SamRecord(qname=f"read-{i:05d}", seq=seq, qual=qual, tags=[
            SamTag("qs", "f", 12.5),
            SamTag("ns", "i", len(moves) * stride + 10),
            SamTag("ts", "i", 10),
            SamTag("mv", "B", np.concatenate([[stride], moves]).astype(np.uint8), subtype="c"),
            SamTag("RG", "Z", "run_model"),
        ]))
        truth.append(name)
    return records, truth
