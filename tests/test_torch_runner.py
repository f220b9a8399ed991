"""``TorchBasecallRunner`` on the CPU against the JAX ``BasecallRunner`` on
the same f16 batch for the conv+LSTM (hac-shaped) models: the lanes, both
decoders, and W8A8 input projections on one set of weights. Sequences and
moves equal, qstrings within one phred step at no more than 1% of positions.

The qstring tolerance: both runners round the per-block probabilities to
bf16 before the phred calc (dorado_tpu/basecall/runner.py:377-381), and the
float32 sums in front of that rounding (model, posteriors, the weighted
posterior sum) run in another order in each framework, so a value near a
bf16 rounding boundary can land on the other side and move its qual char
by one.

The W8A8 cases on further seeds and head gains, where a wider, stated bound
takes the place of that one, are in ``tests/test_torch_runner_w8a8.py``; the
transformer (sup) cases in ``tests/test_torch_runner_tx.py``. The three
files are one family each so that ``--dist loadfile`` runs them on three
workers: together they took 1169 s of one worker's time in a whole run.
This module's helpers are theirs (and other files') too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.basecall.runner import BasecallRunner
from dorado_tpu.models.crf_model import init_lstm_crf_params as jax_init
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config

CHUNK = 1200
# a multiple of the conftest's 8 virtual devices, so the JAX runner keeps it
BATCH = 8
TX_CHUNK = 1152  # 6 x the chunk granularity of 192: lanes of 1152 and 768 samples


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the models' small operators crawl at their
    thread-pool barriers when the test workers oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


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


def _hac128(cfg):
    """hac v4.3's shape at LSTM width 128, the narrowest the W8A8 path takes,
    with 3 LSTM layers."""
    cfg.lstm_size = 128
    cfg.convs[2].size = 128
    cfg.lstm_layers = 3
    return cfg


# the JAX runner's device program is a function of the config, the decoder
# and the options; the weights are its argument. One program compiled for
# each decoder serves every seed and gain of a test module.
_JAX_PROGRAMS = {}


def _w8a8_runners(decoder, seed, gain):
    """Both runners with W8A8 input projections at H = 128, on random weights
    from ``seed`` whose CRF head is scaled by ``gain`` so that both decoders
    emit bases. The JAX runner takes them with its Pallas stack on
    (``use_pallas=True``: the LSTM kernel in interpret mode), which is how it
    runs hac on the TPU."""
    params = jax.tree_util.tree_map(
        np.array, jax_init(_hac128(jax_hac_config()), jax.random.PRNGKey(seed))
    )
    params["linear1"]["w"] *= gain
    jr = BasecallRunner(
        _hac128(jax_hac_config()), params, chunk_size=CHUNK, batch_size=BATCH,
        decoder=decoder, compute_dtype=jnp.float32, use_pallas=True,
    )
    assert "w_ih_q" in jr.params["lstms"][0]
    jr._device_fn = _JAX_PROGRAMS.setdefault(decoder, jr._device_fn)
    cfg = _hac128(hac_v43_config())
    tr = TorchBasecallRunner(
        cfg, params_from_jax(params, cfg), chunk_size=CHUNK, batch_size=BATCH, device="cpu",
        decoder=decoder, lstm_precision="w8a8",
    )
    assert tr.model.lstms[0].w_ih_q.dtype == torch.int8
    return jr, tr


def _call_both(jr, tr, lane):
    buf = tr.make_input_buffer(lane)
    buf[:] = np.random.RandomState(lane).randn(*buf.shape).astype(np.float16)
    n = buf.shape[0] - 1  # leave a padding row, as a partial batch does
    ref = jr.call_chunks(buf.copy(), n)
    out = tr.call_chunks(buf.copy(), n)
    assert len(out) == len(ref) == n
    return ref, out


def _assert_calls_match(jr, tr, lane, min_bases_per_chunk):
    ref, out = _call_both(jr, tr, lane)
    counts = [0, 0]
    for x, y in zip(ref, out):
        assert y.sequence == x.sequence
        np.testing.assert_array_equal(y.moves, x.moves)
        assert_qstrings_close(y.qstring, x.qstring, counts)
    assert counts[1] > min_bases_per_chunk * len(out)  # the path emits bases
    assert counts[0] <= 0.01 * counts[1]


@pytest.mark.parametrize("decoder", ["beam", "viterbi"])
def test_w8a8_call_chunks_matches_jax(decoder):
    """The slice as a whole (W8A8 model, either decoder), on weights where
    neither decoder meets a near-tie: sequences and moves equal, qstrings
    within the module's tolerance. Other weights: the two tests below."""
    jr, tr = _w8a8_runners(decoder, 5, 32.0)
    _assert_calls_match(jr, tr, 0, 50)



@functools.lru_cache(maxsize=None)
def _beam_runners():
    """Both runners with the beam decoder on the narrow model of the Viterbi
    test, made once for both lanes."""
    params = jax_params_with_moves(2)
    jr = BasecallRunner(
        _narrow_hac(jax_hac_config()), params, chunk_size=CHUNK, batch_size=BATCH,
        decoder="beam", compute_dtype=jnp.float32,
    )
    cfg = _narrow_hac(hac_v43_config())
    tr = TorchBasecallRunner(
        cfg, params_from_jax(params, cfg), chunk_size=CHUNK, batch_size=BATCH, device="cpu",
        decoder="beam", lstm_precision="w8a8",
    )
    return jr, tr


@pytest.mark.parametrize("lane", [0, 1])
def test_beam_call_chunks_matches_jax(lane):
    """``decoder="beam"`` against the JAX runner's on-device beam, on the
    narrow model of the Viterbi test (its H = 32 stays unquantised under
    ``lstm_precision="w8a8"``, as fast's H = 96 does)."""
    jr, tr = _beam_runners()
    assert not hasattr(tr.model.lstms[0], "w_ih_q")
    _assert_calls_match(jr, tr, lane, 50)


def test_decoder_and_precision_arguments():
    cfg = _narrow_hac(hac_v43_config())
    model = params_from_jax(jax_params_with_moves(2), cfg)
    kw = dict(chunk_size=CHUNK, batch_size=BATCH, device="cpu")
    for bad in ("beam-host", "greedy"):
        with pytest.raises(ValueError, match="unknown decoder"):
            TorchBasecallRunner(cfg, model, decoder=bad, **kw)
    with pytest.raises(ValueError, match="unknown lstm_precision"):
        TorchBasecallRunner(cfg, model, lstm_precision="int4", **kw)
    # unquantised by default on the CPU, as the JAX runner is off the TPU
    runner = TorchBasecallRunner(cfg, model, **kw)
    assert (runner.decoder, runner.lstm_precision) == ("viterbi", "bf16")
