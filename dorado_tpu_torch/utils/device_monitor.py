"""Device health: memory accounting and dispatch latency of a card.

Port of ``dorado_tpu/utils/device_monitor.py`` (the reference's NVML poller,
dorado/torch_utils/include/torch_utils/gpu_monitor.h ``DeviceStatusInfo``
and gpu_monitor.cpp). The fields are the JAX module's, filled from
PyTorch's CUDA allocator and ``cudaMemGetInfo``; like the JAX module it
reads no temperature or power. Snapshots feed the ``StatsSampler``
(``device.`` columns of ``--dump-stats-file``), and the command line's crash
handler prints ``describe_devices()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class DeviceStatusInfo:
    """gpu_monitor.h ``DeviceStatusInfo`` for one device: every field
    optional, with an error string where it could not be read."""

    device_index: int = 0
    device_kind: str = ""
    platform: str = ""
    bytes_in_use: int | None = None
    bytes_limit: int | None = None
    peak_bytes_in_use: int | None = None
    bytes_reserved: int | None = None
    num_allocs: int | None = None
    memory_error: str = ""
    # round trip of a tiny op and a synchronise
    probe_latency_s: float | None = None
    probe_error: str = ""
    errors: list[str] = field(default_factory=list)

    @property
    def hbm_utilization(self) -> float | None:
        if self.bytes_in_use is None or not self.bytes_limit:
            return None
        return self.bytes_in_use / self.bytes_limit


class DeviceMonitor:
    """Samples one device's health (the first visible card unless given);
    cheap enough for the 100 ms stats tick: the memory counters are the
    allocator's, and the latency probe, which costs a round trip to the
    card, runs only when asked."""

    def __init__(self, device: torch.device | str | None = None):
        self._device = None if device is None else torch.device(device)
        self._last_probe: float | None = None

    def _dev(self) -> torch.device:
        if self._device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available")
            self._device = torch.device("cuda", 0)
        return self._device

    def status(self, probe: bool = False) -> DeviceStatusInfo:
        info = DeviceStatusInfo()
        try:
            dev = self._dev()
            cuda = dev.type == "cuda"
            info.device_index = (dev.index or 0) if cuda else 0
            info.device_kind = torch.cuda.get_device_name(dev) if cuda else dev.type
            info.platform = "gpu" if cuda else dev.type
        except Exception as e:  # no device at all
            info.errors.append(f"device: {e}")
            return info
        try:
            if not cuda:
                raise RuntimeError(f"{dev} keeps no memory statistics")
            info.bytes_in_use = torch.cuda.memory_allocated(dev)
            info.peak_bytes_in_use = torch.cuda.max_memory_allocated(dev)
            info.bytes_reserved = torch.cuda.memory_reserved(dev)
            info.bytes_limit = torch.cuda.mem_get_info(dev)[1]
            info.num_allocs = torch.cuda.memory_stats(dev).get("allocation.all.current", 0)
        except Exception as e:
            info.memory_error = str(e)
        if probe:
            try:
                info.probe_latency_s = self.probe_latency()
            except Exception as e:
                info.probe_error = str(e)
        else:
            info.probe_latency_s = self._last_probe
        return info

    def probe_latency(self) -> float:
        """Seconds for one tiny op on the device and a synchronise."""
        dev = self._dev()
        t0 = time.perf_counter()
        x = torch.zeros(8, device=dev) + 1.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        float(x[0])
        self._last_probe = time.perf_counter() - t0
        return self._last_probe

    def sample_stats(self) -> dict:
        """A ``StatsSampler`` provider: numeric columns only."""
        info = self.status()
        row = {}
        if info.bytes_in_use is not None:
            row["hbm_bytes_in_use"] = info.bytes_in_use
        if info.peak_bytes_in_use is not None:
            row["hbm_peak_bytes"] = info.peak_bytes_in_use
        if info.bytes_limit:
            row["hbm_bytes_limit"] = info.bytes_limit
            if info.bytes_in_use is not None:
                row["hbm_utilization"] = info.bytes_in_use / info.bytes_limit
        if info.probe_latency_s is not None:
            row["probe_latency_ms"] = info.probe_latency_s * 1e3
        return row

    def health_warnings(
        self,
        hbm_threshold: float = 0.95,
        latency_threshold_s: float = 5.0,
    ) -> list[str]:
        """Warnings in words, as the reference logs its throttling and
        temperature notices."""
        info = self.status()
        out = []
        util = info.hbm_utilization
        if util is not None and util > hbm_threshold:
            out.append(
                f"device {info.device_index} HBM nearly full: "
                f"{info.bytes_in_use / 2**30:.2f} / "
                f"{info.bytes_limit / 2**30:.2f} GiB ({util:.0%})"
            )
        if info.probe_latency_s is not None and info.probe_latency_s > latency_threshold_s:
            out.append(
                f"device {info.device_index} dispatch latency degraded: "
                f"{info.probe_latency_s:.1f}s round trip"
            )
        return out


def describe_devices() -> list[str]:
    """One line for each visible card (gpu_monitor.cpp
    get_devices_status_info's role), for crash reports."""
    if not torch.cuda.is_available():
        return ["no CUDA devices: CUDA is not available"]
    lines = []
    for i in range(torch.cuda.device_count()):
        info = DeviceMonitor(torch.device("cuda", i)).status()
        mem = ""
        if info.bytes_in_use is not None and info.bytes_limit:
            mem = f" hbm={info.bytes_in_use / 2**30:.2f}/{info.bytes_limit / 2**30:.2f}GiB"
        lines.append(f"device {i}: {info.device_kind} [{info.platform}]{mem}")
    return lines
