"""``-b 0``: the port's batch-size sweep and memory cap (``basecall/
batch_size.py``) against the JAX module's formulas, and the sweep and its
cache on the CPU at a narrow model."""

import json

import pytest
import torch

from dorado_tpu.basecall import batch_size as jax_batch_size
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu_torch.basecall import batch_size
from dorado_tpu_torch.models.crf_model import init_lstm_crf_params
from dorado_tpu_torch.models.presets import fast_v40_config, hac_v43_config, sup_v50_config

GB = 1024**3


@pytest.mark.parametrize("memory_gb", [16, 80])
def test_memory_cap_matches_jax_for_lstm_models(memory_gb):
    ours, theirs = hac_v43_config(), jax_hac_config()
    assert batch_size.bytes_per_chunk_timestep(ours) == jax_batch_size.bytes_per_chunk_timestep(theirs)
    for chunk in (9996, 4998):
        got = batch_size.max_safe_batch_size(ours, chunk, memory_gb * GB)
        assert got == jax_batch_size.max_safe_batch_size(theirs, chunk, hbm_bytes=memory_gb * GB)
        assert got % 64 == 0 and got >= 64


def test_memory_cap_uses_the_transformer_width():
    """A transformer's config holds lstm_size = -1: its activations are
    sized from d_model (the JAX module's estimate takes the -1)."""
    cfg = sup_v50_config()
    per = batch_size.bytes_per_chunk_timestep(cfg)
    assert per == int((12 * 512 * 2 + 4 * 4096 + 3 * 1024 * 4 + 32 * 6) * 1.5)
    assert batch_size.max_safe_batch_size(cfg, 12288, 80 * GB) > 0


@pytest.fixture
def one_thread():
    """One intra-op thread: the sweep's 64- and 128-row steps are many small
    operators, whose thread-pool barriers crawl when the test workers
    oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_sweep_on_the_cpu_and_its_cache(tmp_path, monkeypatch, one_thread):
    monkeypatch.setenv("DORADO_TPU_TORCH_CACHE_DIR", str(tmp_path))
    # fast v4.0 at H = 32 (64 states): the sweep's 64- and 128-row steps stay
    # cheap on the CPU
    cfg = fast_v40_config()
    cfg.lstm_size = cfg.convs[2].size = 32
    model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs max_batch"):
        batch_size.auto_batch_size(cfg, model, 1200, device="cpu")
    timings = []
    chosen = batch_size.auto_batch_size(cfg, model, 1200, device="cpu", max_batch=128,
                                        timings=timings)
    assert [n for n, _ in timings] == [64, 128] and chosen in (64, 128)
    assert all(s > 0 for _, s in timings)
    cache = json.loads((tmp_path / "batch_benchmarks.json").read_text())
    # keyed by the compute dtype too (float32, the CPU's default)
    assert cache == {f"cpu|{cfg.model_name}|1200|float32": chosen}
    # a cached choice is taken without a sweep
    cache[f"cpu|{cfg.model_name}|1200|float32"] = 192
    (tmp_path / "batch_benchmarks.json").write_text(json.dumps(cache))
    assert batch_size.auto_batch_size(cfg, model, 1200, device="cpu", max_batch=128) == 192
    assert batch_size.auto_batch_size(cfg, model, 1200, device="cpu", max_batch=64,
                                      use_cache=False) == 64
