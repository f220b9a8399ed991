"""Duplex inputs for the port's tests and ``chip_smoke.py`` (numpy only).

A random-weight model calls few bases at low qscores, so no synthetic pair
passes ``check_pair``'s length and qscore gates: ``ForcedPairer`` pairs
reads without them. ``duplex_read_layout`` places template and complement
reads on shared channels and muxes, each complement starting within 100 ms
of its template's end, and one read alone on its channel;
``duplex_fixture_reads`` makes the committed ``duplex.pod5``'s reads from
their seed (``python -m tests.torch_duplex`` rewrites that file, with
``tests/torch_pod5_writer.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

DUPLEX_FIXTURE = Path(__file__).parent / "data" / "torch_port" / "duplex.pod5"
DUPLEX_FIXTURE_SEED = 2025
DUPLEX_FIXTURE_PAIRS = 21
DUPLEX_FIXTURE_LENGTHS = (20_000, 30_001)
MAX_GAP_SAMPLES = 500  # 100 ms at 5 kHz


class ForcedPairer:
    """Pairs each read that has a call with the last unpaired read with a
    call on its channel and mux, whatever the gates; the one that started
    first is the template. ``result_cls`` is the package's
    ``PairingResult``; ``pushed`` keeps every candidate in the order it came."""

    def __init__(self, result_cls):
        self.result_cls = result_cls
        self._last = {}
        self.pairs_found = 0
        self.pushed = []

    def push(self, read):
        self.pushed.append(read)
        if not read.seq:
            return None
        key = (read.channel, read.mux)
        prev = self._last.pop(key, None)
        if prev is None:
            self._last[key] = read
            return None
        t, c = sorted((prev, read), key=lambda r: r.start_time_ms)
        self.pairs_found += 1
        return self.result_cls(t, c, 0, len(t.seq) - 1, 0, len(c.seq) - 1)


def duplex_read_layout(rs: np.random.RandomState, lengths: list[int], pairs: int):
    """(channel, well, start sample) of each read for ``lengths``: the first
    ``2 * pairs`` reads in template-complement pairs, each pair on its own
    channel and well, the complement starting 0-500 samples after its
    template's end; each read after them alone on its channel."""
    layout = []
    for i, n in enumerate(lengths):
        if i < 2 * pairs and i % 2:
            channel, well, start = layout[-1]
            layout.append((channel, well, start + lengths[i - 1]
                           + int(rs.randint(0, MAX_GAP_SAMPLES + 1))))
        else:
            layout.append((i + 1, 1 + i % 4, int(rs.randint(10**6, 10**8))))
    return layout


def duplex_fixture_reads():
    """The committed ``duplex.pod5``'s reads and run infos: 21 pairs and 2
    lone reads of 20-30k samples, in one run."""
    from tests.torch_pod5_writer import make_reads, run_info

    rs = np.random.RandomState(DUPLEX_FIXTURE_SEED)
    lengths = [int(n) for n in rs.randint(*DUPLEX_FIXTURE_LENGTHS, 2 * DUPLEX_FIXTURE_PAIRS + 2)]
    infos = [run_info(5)]
    reads = make_reads(DUPLEX_FIXTURE_SEED + 1, lengths, infos)
    for r, (channel, well, start) in zip(reads, duplex_read_layout(rs, lengths,
                                                                   DUPLEX_FIXTURE_PAIRS)):
        r.update(channel=channel, well=well, start=start)
    return reads, infos


if __name__ == "__main__":
    from tests.torch_pod5_writer import write_pod5

    write_pod5(DUPLEX_FIXTURE, *duplex_fixture_reads())
    print(DUPLEX_FIXTURE, DUPLEX_FIXTURE.stat().st_size, "bytes")
