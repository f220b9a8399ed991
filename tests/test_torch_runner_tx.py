"""``TorchBasecallRunner`` on the CPU against the JAX ``BasecallRunner`` for
the transformer (sup) models: the small sup configuration of
``tests/test_torch_tx_model.py`` through both runners, in float32, with W8A8
and with int8 encoder matmuls, on the port's other attention and norm
routes, and with the beam decoder at its 1024 states. The qual-char
tolerance of ``tests/test_torch_runner.py``'s docstring applies, widened
where a case says why.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.basecall.runner import BasecallRunner
from dorado_tpu.models.presets import sup_v50_config as jax_sup_config
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config, sup_v50_config
from dorado_tpu_torch.models.tx_model import tx_params_from_jax
from dorado_tpu_torch.ops import beam, crf_cuda
from tests.test_torch_runner import (  # noqa: F401
    BATCH, TX_CHUNK, _call_both, _narrow_hac, jax_params_with_moves, one_thread,
)
from tests.test_torch_tx_model import jax_tx_params, small_sup


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
