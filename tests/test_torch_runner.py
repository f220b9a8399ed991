"""``TorchBasecallRunner`` on the CPU against the JAX ``BasecallRunner`` on
the same f16 batch: sequences and moves equal, qstrings within one phred
step at no more than 1% of positions.

The qstring tolerance: both runners round the per-block probabilities to
bf16 before the phred calc (dorado_tpu/basecall/runner.py:377-381), and the
float32 sums in front of that rounding (model, posteriors, the weighted
posterior sum) run in another order in each framework, so a value near a
bf16 rounding boundary can land on the other side and move its qual char
by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dorado_tpu.basecall.runner import BasecallRunner
from dorado_tpu.models.crf_model import init_lstm_crf_params as jax_init
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config

CHUNK = 1200
# a multiple of the conftest's 8 virtual devices, so the JAX runner keeps it
BATCH = 8


def _narrow_hac(cfg):
    cfg.lstm_size = 32
    cfg.convs[2].size = 32
    return cfg


def jax_params_with_moves(seed):
    """hac-shaped random weights whose CRF head is scaled up so the Viterbi
    path emits bases (unscaled random weights mostly stay)."""
    params = jax.tree_util.tree_map(
        np.array, jax_init(_narrow_hac(jax_hac_config()), jax.random.PRNGKey(seed))
    )
    params["linear1"]["w"] *= 12.0
    return params


def assert_qstrings_close(a: str, b: str, counts: list) -> None:
    qa = np.frombuffer(a.encode(), np.uint8).astype(np.int32)
    qb = np.frombuffer(b.encode(), np.uint8).astype(np.int32)
    assert len(qa) == len(qb)
    assert np.abs(qa - qb).max(initial=0) <= 1
    counts[0] += int((qa != qb).sum())
    counts[1] += len(qa)


@pytest.fixture(scope="module")
def runners():
    params = jax_params_with_moves(2)
    jr = BasecallRunner(
        _narrow_hac(jax_hac_config()), params, chunk_size=CHUNK, batch_size=BATCH,
        decoder="viterbi", compute_dtype=jnp.float32,
    )
    cfg = _narrow_hac(hac_v43_config())
    tr = TorchBasecallRunner(
        cfg, params_from_jax(params, cfg), chunk_size=CHUNK, batch_size=BATCH, device="cpu"
    )
    return jr, tr


def test_lane_surface_matches(runners):
    jr, tr = runners
    assert tr.chunk_sizes == jr.chunk_sizes == [CHUNK, CHUNK * 3 // 4]
    for lane in range(2):
        assert tr.lane_batch_size(lane) == jr.lane_batch_size(lane)
        assert tr.lane_for(tr.chunk_sizes[lane]) == jr.lane_for(jr.chunk_sizes[lane])
        buf = tr.make_input_buffer(lane)
        assert buf.dtype == np.float16 and buf.shape == jr.make_input_buffer(lane).shape
    short = np.arange(500, dtype=np.float32)
    a, b = tr.make_input_buffer(1), jr.make_input_buffer(1)
    tr.accept_chunk(a, 0, short)
    jr.accept_chunk(b, 0, short)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lane", [0, 1])
def test_call_chunks_matches_jax(runners, lane):
    jr, tr = runners
    buf = tr.make_input_buffer(lane)
    buf[:] = np.random.RandomState(lane).randn(*buf.shape).astype(np.float16)
    n = buf.shape[0] - 1  # leave a padding row, as a partial batch does
    batches = tr.stats.batches_called
    ref = jr.call_chunks(buf.copy(), n)
    out = tr.call_chunks(buf.copy(), n)
    assert tr.stats.batches_called == batches + 1
    assert len(out) == n
    counts = [0, 0]
    for x, y in zip(ref, out):
        assert y.sequence == x.sequence
        np.testing.assert_array_equal(y.moves, x.moves)
        assert_qstrings_close(y.qstring, x.qstring, counts)
    assert counts[1] > 100 * n  # the path emits bases
    assert counts[0] <= 0.01 * counts[1]
