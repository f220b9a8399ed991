"""``TorchBasecallRunner`` on the CPU against the JAX ``BasecallRunner`` on
the same f16 batch, for both decoders and with W8A8 input projections:
sequences and moves equal, qstrings within one phred step at no more than 1%
of positions.

The qstring tolerance: both runners round the per-block probabilities to
bf16 before the phred calc (dorado_tpu/basecall/runner.py:377-381), and the
float32 sums in front of that rounding (model, posteriors, the weighted
posterior sum) run in another order in each framework, so a value near a
bf16 rounding boundary can land on the other side and move its qual char
by one.

The W8A8 cases run on one set of weights where all of that holds, and on
further seeds and head gains where a wider, stated bound takes its place:
see the two ``..._on_other_weights`` tests.

The transformer (sup) cases at the end run the small sup configuration of
``tests/test_torch_tx_model.py`` through both runners, in float32, with W8A8
and with int8 encoder matmuls, on the port's other attention and norm
routes, and with the beam decoder at its 1024 states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.basecall.runner import BasecallRunner
from dorado_tpu.models.crf_model import init_lstm_crf_params as jax_init
from dorado_tpu.models.crf_model import lstm_crf_forward
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.models.presets import sup_v50_config as jax_sup_config
from dorado_tpu.ops import beam as jax_beam
from dorado_tpu.ops import crf_scan as jax_crf_scan
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config, sup_v50_config
from dorado_tpu_torch.models.tx_model import tx_params_from_jax
from dorado_tpu_torch.ops import beam, crf_cuda, crf_scan
from dorado_tpu_torch.ops.beam import beam_search_plain
from tests.test_torch_tx_model import jax_tx_params, small_sup

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


def _hac128(cfg):
    """hac v4.3's shape at LSTM width 128, the narrowest the W8A8 path takes,
    with 3 LSTM layers."""
    cfg.lstm_size = 128
    cfg.convs[2].size = 128
    cfg.lstm_layers = 3
    return cfg


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


# (seed of the weights, gain of the CRF head): every case that was tried
# while the test above was written, whatever it showed
W8A8_CASES = [(5, 40.0), (5, 48.0), (11, 32.0), (23, 40.0)]


@pytest.mark.parametrize("seed,gain", W8A8_CASES)
def test_w8a8_viterbi_matches_jax_on_other_weights(seed, gain):
    """Viterbi with W8A8 on further weights: sequences and moves equal on
    every one. Qual chars are held to 2 steps at no more than 25% of
    positions, wider than the module's tolerance, and only at the top of the
    scale: a block probability within one bf16 step (2^-8) of 1 moves its
    char by 2 when it rounds the other way, and a saturated random head
    gives many positions the same probability, so at one gain a fifth of
    them sit on that boundary (measured: 0 to 22% of positions, none below
    phred 40 by more than 1)."""
    jr, tr = _w8a8_runners("viterbi", seed, gain)
    ref, out = _call_both(jr, tr, 0)
    different = total = 0
    for x, y in zip(ref, out):
        assert y.sequence == x.sequence
        np.testing.assert_array_equal(y.moves, x.moves)
        qa = np.frombuffer(x.qstring.encode(), np.uint8).astype(np.int32) - 33
        qb = np.frombuffer(y.qstring.encode(), np.uint8).astype(np.int32) - 33
        assert np.abs(qa - qb).max(initial=0) <= 2
        assert np.all(np.minimum(qa, qb)[np.abs(qa - qb) > 1] >= 40)
        different += int((qa != qb).sum())
        total += len(qa)
    assert different <= 0.25 * total


@pytest.mark.parametrize("seed,gain", W8A8_CASES)
def test_w8a8_beam_near_jax_on_other_weights(seed, gain):
    """Beam with W8A8 on further weights, where the whole runners can part,
    held part by part so that the cause is shown and not assumed.

    The beam search amplifies its inputs' last bits: a near-tie in the merge
    or the cutoff goes the other way and the path's moves shift. The two
    packages' float32 sums run in another order, so (a) the models' scores
    differ in the last bits, and by more where that flips an activation's
    int8 rounding (mean under 1e-4, max under 2e-2; measured 1.5e-5 and
    4.5e-3), and (b) on the same scores the backward scores differ by one
    unit in the last place (under 1e-3 on values up to 1e3; measured
    1.2e-4). (c) On the same scores and the same back guide the two beams agree
    exactly, whichever package made the back guide: the JAX beam moves as far as
    the port's when it is given the port's back guide. So (d) the runners' moves
    are only bounded: no more than 10% of positions (measured 0 to 4.4%)."""
    jr, tr = _w8a8_runners("beam", seed, gain)
    buf = tr.make_input_buffer(0)
    buf[:] = np.random.RandomState(0).randn(*buf.shape).astype(np.float16)
    n = buf.shape[0] - 1
    jax_scores = np.array(
        lstm_crf_forward(
            jr.params, jnp.asarray(buf[:n]).astype(jnp.float32), _hac128(jax_hac_config()),
            use_pallas=True, time_major=True,
        )
    )
    with torch.inference_mode():
        scores = tr.model(torch.from_numpy(buf[:n]))
    err = np.abs(scores.numpy() - jax_scores)
    assert err.mean() < 1e-4 and err.max() < 2e-2  # (a)

    blank = float(tr.options.blank_score)
    width, cut = int(tr.options.beam_width), float(tr.options.beam_cut)
    jax_back_guide = np.array(jax_crf_scan.backward_scores(jnp.asarray(jax_scores), blank))
    back_guide = crf_scan.backward_scores(torch.from_numpy(jax_scores), blank).numpy()
    assert np.abs(back_guide - jax_back_guide).max() < 1e-3  # (b)
    for g in (jax_back_guide, back_guide):  # (c)
        want = jax_beam.beam_search_device(
            jnp.asarray(jax_scores), jnp.asarray(g), width, cut, blank
        )
        got = beam_search_plain(
            torch.from_numpy(jax_scores), torch.from_numpy(g), width, cut, blank
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    ref, out = jr.call_chunks(buf.copy(), n), tr.call_chunks(buf.copy(), n)  # (d)
    different = sum(int((x.moves != y.moves).sum()) for x, y in zip(ref, out))
    positions = sum(len(x.moves) for x in ref)
    assert sum(int(y.moves.sum()) for y in out) > 50 * n  # the path emits bases
    assert different <= 0.10 * positions, (different, positions)


@pytest.mark.parametrize("lane", [0, 1])
def test_beam_call_chunks_matches_jax(lane):
    """``decoder="beam"`` against the JAX runner's on-device beam, on the
    narrow model of the Viterbi test (its H = 32 stays unquantised under
    ``lstm_precision="w8a8"``, as fast's H = 96 does)."""
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


# ---------------------------------------------------------------------------
# transformer (sup) models
# ---------------------------------------------------------------------------

TX_CHUNK = 1152  # 6 x the chunk granularity of 192: lanes of 1152 and 768 samples


@functools.lru_cache(maxsize=None)
def _jax_tx_runner(precision, seed=3, decoder="viterbi"):
    """The JAX runner on the small sup configuration, made once for each
    precision and decoder: it reads its precision from
    ``DORADO_TPU_TX_PRECISION`` when it is built; off the TPU it runs the
    strip-loop attention, the unfused norms and the int8 kernels' XLA
    fallbacks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DORADO_TPU_TX_PRECISION", precision)
        jr = BasecallRunner(
            small_sup(jax_sup_config()), jax_tx_params(seed), chunk_size=TX_CHUNK,
            batch_size=BATCH, decoder=decoder, compute_dtype=jnp.float32,
        )
    quantised = {"w8a8": "wqkv_w8", "int8": "wqkv_q"}
    assert all((key in jr.params["layers"][0]) == (precision == p) for p, key in quantised.items())
    return jr


@functools.lru_cache(maxsize=None)
def _tx_runners(precision, seed=3, attention=None, fused_norm=None, decoder="viterbi"):
    """Both runners on the small sup configuration with the same random
    weights, float32 on the CPU; the port's on the given routes."""
    jr = _jax_tx_runner(precision, seed, decoder)
    cfg = small_sup(sup_v50_config())
    tr = TorchBasecallRunner(
        cfg, tx_params_from_jax(jax_tx_params(seed), cfg), chunk_size=TX_CHUNK,
        batch_size=BATCH, device="cpu", tx_precision=precision, tx_attention=attention,
        tx_fused_norm=fused_norm, decoder=decoder,
    )
    assert tr.model.precision == {"bf16": "float"}.get(precision, precision)
    assert (tr.model.attention, tr.model.fused_norm) == (attention or "extf", bool(fused_norm))
    assert tr.chunk_sizes == jr.chunk_sizes == [TX_CHUNK, TX_CHUNK * 2 // 3]
    return jr, tr


def _assert_tx_calls_match(jr, tr, lane, max_share_different):
    """Sequences and moves equal; qual chars one step apart at most, but at
    the top of the scale (both at phred 40 or more), where a block
    probability within one bf16 step of 1 moves its char by up to 3 when it
    rounds the other way (the note in this module's docstring and the hac
    W8A8 test above); ``max_share_different`` of all positions may differ."""
    ref, out = _call_both(jr, tr, lane)
    different = total = 0
    for x, y in zip(ref, out):
        assert y.sequence == x.sequence
        np.testing.assert_array_equal(y.moves, x.moves)
        qa = np.frombuffer(x.qstring.encode(), np.uint8).astype(np.int32) - 33
        qb = np.frombuffer(y.qstring.encode(), np.uint8).astype(np.int32) - 33
        assert np.abs(qa - qb).max(initial=0) <= 3
        assert np.all(np.minimum(qa, qb)[np.abs(qa - qb) > 1] >= 40)
        different += int((qa != qb).sum())
        total += len(qa)
    assert total > 50 * len(out)  # the path emits bases
    assert different <= max_share_different * total, (different, total)


@pytest.mark.parametrize("lane", [0, 1])
def test_tx_call_chunks_matches_jax(lane):
    """The sup slice as a whole, unquantised: 1% of qual chars may differ
    (measured 0.7%)."""
    jr, tr = _tx_runners("bf16")
    assert tr.tx_precision == "bf16" and tr.lstm_precision is None
    _assert_tx_calls_match(jr, tr, lane, 0.01)


@pytest.mark.parametrize("lane", [0, 1])
def test_tx_w8a8_call_chunks_matches_jax(lane):
    """The sup slice as a whole with W8A8 encoder matmuls. The scores of the
    two packages part by 3e-4 on average where an activation's int8 rounding
    flips (``tests/test_torch_tx_model.py``), which moves more posteriors
    across a bf16 boundary than float32 sums alone do: 10% of qual chars may
    differ by one step (measured 1.5% and 4.5% on the two lanes); sequences
    and moves stay equal."""
    jr, tr = _tx_runners("w8a8")
    _assert_tx_calls_match(jr, tr, lane, 0.10)


@pytest.mark.parametrize("lane", [0, 1])
def test_tx_int8_call_chunks_matches_jax(lane):
    """``tx_precision="int8"`` against the JAX runner's: the tolerance of the
    W8A8 case above (measured: 1.0% and 5.0% of qual chars differ on the two
    lanes)."""
    jr, tr = _tx_runners("int8")
    assert tr.tx_precision == "int8" and tr.model.layers[0].fc1_q.dtype == torch.int8
    _assert_tx_calls_match(jr, tr, lane, 0.10)


@pytest.mark.parametrize(
    "precision,attention,fused_norm",
    [("w8a8", "extf", True), ("w8a8", "ext", False), ("w8a8", "ext", True),
     ("w8a8", "hp", False), ("w8a8", "hp", True),
     ("bf16", "ext", True), ("int8", "hp", False), ("int8", "ext", True)],
)
def test_tx_routes_call_chunks_match_jax(precision, attention, fused_norm):
    """The port's other routes through the runner against the JAX runner's
    default route: they compute the same function, so the tolerances are
    the precision's own (1% of qual chars unquantised, 10% quantised;
    measured 0.7% and 1.0%: on the CPU the routes' scores are equal)."""
    jr, tr = _tx_runners(precision, attention=attention, fused_norm=fused_norm)
    _assert_tx_calls_match(jr, tr, 0, 0.01 if precision == "bf16" else 0.10)


@pytest.mark.parametrize("precision", ["bf16", "w8a8"])
@pytest.mark.parametrize("lane", [0, 1])
def test_tx_beam_call_chunks_matches_jax(precision, lane):
    """``decoder="beam"`` on the sup slice (1024 states: the forward and
    backward scans, their posteriors and the beam over the head's float32
    scores) against the JAX runner's ``device_beam`` on the same weights:
    sequences and moves equal, qual chars to the precision's tolerance of
    the Viterbi cases above (1% unquantised, 10% with W8A8; measured 0.6-0.7%
    and 0.9-5.1%)."""
    jr, tr = _tx_runners(precision, decoder="beam")
    assert tr.decoder == jr.decoder == "beam"
    _assert_tx_calls_match(jr, tr, lane, 0.01 if precision == "bf16" else 0.10)


def test_tx_decoder_and_precision_arguments():
    cfg = small_sup(sup_v50_config())
    model = tx_params_from_jax(jax_tx_params(3), cfg)
    kw = dict(chunk_size=TX_CHUNK, batch_size=BATCH, device="cpu")
    # the beam decoder is taken on a transformer and, on the CPU, runs the
    # plain versions of its kernels: nothing is launched
    beam_runner = TorchBasecallRunner(cfg, model, decoder="beam", **kw)
    wrappers = (crf_cuda.forward_backward_scores, beam.beam_forward, beam.beam_traceback)
    before = [w.launches for w in wrappers]
    out = beam_runner.call_chunks(beam_runner.make_input_buffer(1), 1)
    assert beam_runner.decoder == "beam" and len(out) == 1
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="unknown tx_precision"):
        TorchBasecallRunner(cfg, model, tx_precision="fp8", **kw)
    with pytest.raises(ValueError, match="unknown attention route"):
        TorchBasecallRunner(cfg, model, tx_attention="qkv_rope", **kw)
    with pytest.raises(ValueError, match="lstm_precision does not apply"):
        TorchBasecallRunner(cfg, model, lstm_precision="w8a8", **kw)
    hac = _narrow_hac(hac_v43_config())
    hac_model = params_from_jax(jax_params_with_moves(2), hac)
    for name, value in (("tx_precision", "w8a8"), ("tx_attention", "hp"), ("tx_fused_norm", True)):
        with pytest.raises(ValueError, match=f"{name} does not apply"):
            TorchBasecallRunner(hac, hac_model, **{name: value}, **kw)
    # unquantised by default on the CPU, as the JAX runner is off the TPU,
    # on the JAX runner's default routes
    runner = TorchBasecallRunner(cfg, model, **kw)
    assert (runner.decoder, runner.tx_precision) == ("viterbi", "bf16")
    assert (runner.tx_attention, runner.tx_fused_norm) == ("extf", False)
    assert runner.replicas[0].qual_table.shape == (1024, 1024)
    # int8 is taken: the quantisation, the routes and the precision are the model's
    runner = TorchBasecallRunner(
        cfg, model, tx_precision="int8", tx_attention="hp", tx_fused_norm=True, **kw
    )
    assert (runner.model.precision, runner.model.attention, runner.model.fused_norm) == (
        "int8", "hp", True)
    assert model.precision == "float" and model.attention == "extf"  # the caller's model stays
