"""Runtime stats sampling: ``--dump-stats-file``.

Port of ``StatsSampler`` of ``dorado_tpu/utils/stats.py`` (the reference's
dorado/utils/stats.h: named stats polled every 100 ms into an optional CSV).
The final summary lines are the command line's own (``cli.main``). Unlike
the JAX sampler, ``stop`` takes one last sample, so that a run shorter than a
period still dumps a row and every dump ends on the run's final counts.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, TextIO

NamedStats = dict[str, float]
StatsProvider = Callable[[], NamedStats]


class StatsSampler:
    """Polls named providers on a fixed period; each row holds
    ``elapsed_ms`` and every provider's stats as ``<name>.<stat>`` (those
    whose name holds ``dump_filter``, when it is given), and goes to
    ``records`` and, as a CSV line, to ``dump_stream`` (the first row's
    names make the header). A provider that raises is left out of that row."""

    def __init__(
        self,
        providers: dict[str, StatsProvider],
        period_s: float = 0.1,
        dump_stream: TextIO | None = None,
        dump_filter: str = "",
    ):
        self._providers = providers
        self._period = period_s
        self._dump = dump_stream
        self._filter = dump_filter
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._records: list[NamedStats] = []
        self._header_written = False

    def _sample(self) -> NamedStats:
        row: NamedStats = {"elapsed_ms": (time.perf_counter() - self._t0) * 1e3}
        for prefix, provider in self._providers.items():
            try:
                for k, v in provider().items():
                    name = f"{prefix}.{k}"
                    if self._filter and self._filter not in name:
                        continue
                    row[name] = float(v)
            except Exception:
                pass
        return row

    def _record(self) -> None:
        row = self._sample()
        self._records.append(row)
        if self._dump is not None:
            if not self._header_written:
                self._dump.write(",".join(row.keys()) + "\n")
                self._header_written = True
            self._dump.write(",".join(f"{v:g}" for v in row.values()) + "\n")

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            self._record()

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._record()
        if self._dump is not None:
            self._dump.flush()

    @property
    def records(self) -> list[NamedStats]:
        return self._records
