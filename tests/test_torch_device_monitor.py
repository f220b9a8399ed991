"""The port's device monitor, stats sampler and ``--dump-stats-file`` on the
CPU: the JAX package's surface (``DeviceStatusInfo``'s fields, the sampler's
CSV columns, ``sample_stats``' keys) with what a CPU device can fill, and
the health warnings on a stubbed status, as ``tests/test_device_monitor.py``
checks them."""

import csv
import dataclasses
import io
import time

import pytest
import torch

from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.pipeline.basecaller import BasecallerPipeline as JaxPipeline
from dorado_tpu.utils import device_monitor as jax_monitor
from dorado_tpu.utils.stats import StatsSampler as JaxSampler
from dorado_tpu_torch.cli.main import main
from dorado_tpu_torch.models.crf_model import LSTMCRFModel
from dorado_tpu_torch.models.presets import hac_v43_config
from dorado_tpu_torch.pipeline import BasecallerPipeline
from dorado_tpu_torch.utils.device_monitor import DeviceMonitor, DeviceStatusInfo, describe_devices
from dorado_tpu_torch.utils.stats import StatsSampler
from tests.test_torch_cli import inputs  # noqa: F401  (a fixture)
from tests.test_torch_runner import _narrow_hac, jax_params_with_moves


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the command line's many small operators crawl
    on thread-pool barriers when the test workers oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_status_fields_are_the_jax_fields():
    assert [f.name for f in dataclasses.fields(DeviceStatusInfo)] == \
        [f.name for f in dataclasses.fields(jax_monitor.DeviceStatusInfo)]


def test_cpu_device_fills_what_it_can():
    mon = DeviceMonitor("cpu")
    info = mon.status()
    assert (info.platform, info.device_kind, info.errors) == ("cpu", "cpu", [])
    assert info.bytes_in_use is None and "no memory statistics" in info.memory_error
    assert mon.sample_stats() == {}
    lat = mon.probe_latency()
    assert 0 < lat < 60
    assert mon.status().probe_latency_s == lat
    assert mon.sample_stats() == {"probe_latency_ms": lat * 1e3}


def test_no_cuda_is_an_error_not_a_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = DeviceMonitor().status()
    assert info.errors and info.errors[0].startswith("device:")
    assert describe_devices() == ["no CUDA devices: CUDA is not available"]


def test_health_warnings_thresholds():
    class FakeMon(DeviceMonitor):
        def status(self, probe=False):
            return DeviceStatusInfo(
                device_index=0, bytes_in_use=960 * 2**20, bytes_limit=1000 * 2**20,
                probe_latency_s=10.0,
            )

    warnings = FakeMon().health_warnings()
    assert any("HBM nearly full" in w for w in warnings)
    assert any("latency degraded" in w for w in warnings)
    assert FakeMon().health_warnings(hbm_threshold=1.1, latency_threshold_s=1e9) == []
    assert DeviceMonitor("cpu").health_warnings() == []


@pytest.mark.parametrize("dump_filter", ["", "a.", "y"])
def test_sampler_csv_has_the_jax_columns(dump_filter):
    providers = {"a": lambda: {"x": 1, "y": 2.5}, "b": lambda: {"y": 3}, "bad": lambda: 1 / 0}
    heads = []
    for cls in (StatsSampler, JaxSampler):
        buf = io.StringIO()
        sampler = cls(providers, period_s=0.01, dump_stream=buf, dump_filter=dump_filter)
        sampler.start()
        time.sleep(0.1)
        sampler.stop()
        rows = list(csv.reader(io.StringIO(buf.getvalue())))
        assert len(rows) > 1 and all(len(r) == len(rows[0]) for r in rows)
        assert {k for r in sampler.records for k in r} == set(rows[0])
        heads.append(rows[0])
    assert heads[0] == heads[1]


def test_sample_stats_has_the_jax_keys():
    cfg = _narrow_hac(hac_v43_config())
    port = BasecallerPipeline(cfg, LSTMCRFModel(cfg), chunk_size=1200, batch_size=8,
                              device="cpu")
    jax_pipe = JaxPipeline(_narrow_hac(jax_hac_config()), jax_params_with_moves(2),
                           chunk_size=1200, batch_size=8)
    assert list(port.sample_stats()) == list(jax_pipe.sample_stats())
    assert all(isinstance(v, (int, float)) for v in port.sample_stats().values())


def test_dump_stats_file_on_the_cpu(inputs, tmp_path):
    model, data = inputs
    stats = tmp_path / "stats.csv"
    assert main(["basecaller", str(model), str(data), "-c", "1200", "-b", "8", "--emit-sam",
                 "-x", "cpu", "-o", str(tmp_path / "calls.sam"),
                 "--dump-stats-file", str(stats)]) == 0
    rows = list(csv.reader(stats.open()))
    assert len(rows) > 1
    assert rows[0][0] == "elapsed_ms" and "basecaller.reads_called" in rows[0]
    assert all(k.startswith("basecaller.") for k in rows[0][1:])  # no card memory on the CPU
    assert float(rows[-1][rows[0].index("basecaller.samples_processed")]) > 0
    filtered = tmp_path / "filtered.csv"
    assert main(["basecaller", str(model), str(data), "-c", "1200", "-b", "8", "--emit-sam",
                 "-x", "cpu", "-o", str(tmp_path / "calls2.sam"),
                 "--dump-stats-file", str(filtered), "--dump-stats-filter", "bases"]) == 0
    assert next(csv.reader(filtered.open())) == ["elapsed_ms", "basecaller.bases_called"]
