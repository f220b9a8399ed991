"""``TorchBasecallRunner`` with W8A8 input projections on the CPU against
the JAX ``BasecallRunner`` (its Pallas stack in interpret mode) on further
seeds and CRF head gains, where the runners' qual chars, or with the beam
decoder their moves, are held to wider, stated bounds than the single set
of weights of ``tests/test_torch_runner.py``; each bound says why.

The JAX work the cases share runs once a module: one compiled device
program for each decoder (``_w8a8_runners``) and one compiled model
forward for every seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.models.crf_model import lstm_crf_forward
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.ops import beam as jax_beam
from dorado_tpu.ops import crf_scan as jax_crf_scan
from dorado_tpu_torch.ops import crf_scan
from dorado_tpu_torch.ops.beam import beam_search_plain
from tests.test_torch_runner import _call_both, _hac128, _w8a8_runners, one_thread  # noqa: F401

# the JAX model forward with its Pallas LSTM (interpret mode), time-major
# scores, compiled once for all weights of the module's shape
_jax_scores = jax.jit(functools.partial(
    lstm_crf_forward, config=_hac128(jax_hac_config()), use_pallas=True, time_major=True))


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
    jax_scores = np.array(_jax_scores(jr.params, jnp.asarray(buf[:n]).astype(jnp.float32)))
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
