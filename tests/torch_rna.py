"""Seeded direct-RNA reads for the port's tests and ``chip_smoke.py``
(numpy only): raw int16 signal at 0.2 pA an ADC step, as an RNA004 run
gives it, with the parts that the RNA path reads.

- the DNA adapter: a low stretch at the read's start, which
  ``determine_rna_adapter_pos`` finds by the rise of its window medians;
- a poly(A) stretch after it, flat (the 3' end is read first);
- the body, noise about the standardisation mean (91.88 pA);
- optional open-pore spikes (above the RNA splitter's 1500) inside the body,
  each of which splits the read in two."""

from __future__ import annotations

import numpy as np

ADAPTER_LEVEL = 250  # ADC: 50 pA, 210 steps below the body
BODY_LEVEL, BODY_SD = 460, 113
POLYA_LEVEL, POLYA_SD = 520, 6
SPIKE_LEVEL = 1900


def rna_signal(rng: np.random.RandomState, n: int, adapter: int = 3000, polya: int = 0,
               spikes: int = 0) -> np.ndarray:
    """``n`` samples: ``adapter`` of them the DNA adapter, then ``polya`` of a
    flat poly(A) stretch, then the body with ``spikes`` open-pore spikes of
    60 samples spread over its middle."""
    sig = rng.normal(BODY_LEVEL, BODY_SD, n)
    sig[:adapter] = rng.normal(ADAPTER_LEVEL, 30, adapter)
    sig[adapter:adapter + polya] = rng.normal(POLYA_LEVEL, POLYA_SD, min(polya, n - adapter))
    body = adapter + polya
    for k in range(spikes):
        at = body + (n - body) * (k + 1) // (spikes + 1)
        sig[at:at + 60] = rng.normal(SPIKE_LEVEL, 40, len(sig[at:at + 60]))
    return np.clip(np.round(sig), -32768, 32767).astype(np.int16)


def rna_signals(seed: int, lengths) -> list[np.ndarray]:
    """One signal a length, each with the adapter; every third with a spike,
    every second with a poly(A) stretch of 600-1500 samples."""
    rng = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(lengths):
        adapter = int(rng.randint(min(2000, n // 4), min(4000, n // 3) + 1))
        polya = int(rng.randint(600, 1501)) if i % 2 == 0 else 0
        out.append(rna_signal(rng, int(n), adapter, polya, spikes=int(i % 3 == 1)))
    return out


RNA_FIXTURE_SEED = 24


def rna_fixture_reads() -> tuple[list[dict], list[dict]]:
    """The committed RNA fixture's reads and run info: 12 reads of 15-35k
    samples at 4 kHz on an RNA004 flow cell, with ``rna_signals``' parts."""
    from tests.torch_pod5_writer import make_reads, run_info

    info = run_info(5, rate=4000)
    info.update(flow_cell_product_code="FLO-MIN004RA", sequencing_kit="SQK-RNA004")
    lengths = [int(n) for n in np.random.RandomState(RNA_FIXTURE_SEED).randint(15_000, 35_001, 12)]
    reads = make_reads(RNA_FIXTURE_SEED + 1, lengths, [info], noise=True)
    for read, signal in zip(reads, rna_signals(RNA_FIXTURE_SEED + 2, lengths)):
        read["signal"] = signal
    return reads, [info]


if __name__ == "__main__":
    from pathlib import Path

    from tests.torch_pod5_writer import write_pod5

    path = Path(__file__).resolve().parent / "data" / "torch_port" / "rna.pod5"
    write_pod5(path, *rna_fixture_reads())
    print(path, path.stat().st_size, "bytes")
