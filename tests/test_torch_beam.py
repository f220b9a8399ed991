"""The port's beam search (CPU, plain version) against the JAX package's
``beam_search_device`` and its CRC helpers.

States and moves must be identical: both sides gather exactly, add the same
float32 terms in the same order and pick survivors in the same candidate
order. The one place they could part is the last bit of ``log1p(exp(-d))``
in a merge; on these cases they do not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.ops import beam as jax_beam
from dorado_tpu.ops.crf_scan import backward_scores as jax_backward_scores
from dorado_tpu_torch.ops import beam

STAY = 2.0


def _case(num_states, t, scale, n=6):
    rng = np.random.RandomState(num_states + t)
    scores = (rng.randn(t, n, num_states * 4) * scale).astype(np.float32)
    beta = np.array(jax_backward_scores(jnp.asarray(scores), STAY))
    return scores, beta


# the cases the JAX package holds against its C++ oracle
@pytest.mark.parametrize(
    "num_states,t,scale", [(256, 120, 2.0), (1024, 60, 2.0), (256, 90, 0.5)]
)
def test_plain_beam_matches_jax(num_states, t, scale):
    scores, beta = _case(num_states, t, scale)
    st_ref, mv_ref = jax_beam.beam_search_device(
        jnp.asarray(scores), jnp.asarray(beta), 32, 100.0, STAY
    )
    calls = beam.beam_forward.launches, beam.beam_traceback.launches
    st, mv = beam.beam_search_device(
        torch.from_numpy(scores), torch.from_numpy(beta), 32, 100.0, STAY
    )
    assert (beam.beam_forward.launches, beam.beam_traceback.launches) == calls
    assert st.dtype == torch.int32 and mv.dtype == torch.uint8 and st.shape == (6, t)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))
    assert 0.05 < mv.float().mean() < 0.95  # paths both stay and step


# T below the kernel's ring of steps (16, 8 at 1024 states) and N no multiple
# of 8
@pytest.mark.parametrize("t_len,n,num_states", [(3, 5, 64), (13, 5, 256), (7, 3, 1024)])
def test_plain_beam_matches_jax_at_ragged_shapes(t_len, n, num_states):
    rng = np.random.RandomState(t_len * n + num_states)
    scores = (rng.randn(t_len, n, 4 * num_states) * 2.0).astype(np.float32)
    beta = np.array(jax_backward_scores(jnp.asarray(scores), STAY))
    st_ref, mv_ref = jax_beam.beam_search_device(
        jnp.asarray(scores), jnp.asarray(beta), 32, 100.0, STAY
    )
    states, moves = beam.beam_search_device(
        torch.from_numpy(scores), torch.from_numpy(beta), 32, 100.0, STAY
    )
    assert states.shape == (n, t_len)
    np.testing.assert_array_equal(states.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(moves.numpy(), np.asarray(mv_ref))


@pytest.mark.parametrize("width,cut", [(8, 100.0), (32, 4.0)])
def test_plain_beam_matches_jax_on_tied_scores(width, cut):
    """Scores on a grid of 1/8 put many candidates on one value, so the
    cutoff's counts and bisection meet ties and the first W candidates at
    or above it are picked among equals: the plain beam against JAX's."""
    rng = np.random.RandomState(width)
    scores = (np.round(rng.randn(24, 3, 4 * 64) * 8.0) / 8.0).astype(np.float32)
    beta = np.array(jax_backward_scores(jnp.asarray(scores), STAY))
    st_ref, mv_ref = jax_beam.beam_search_device(
        jnp.asarray(scores), jnp.asarray(beta), width, cut, STAY
    )
    states, moves = beam.beam_search_device(
        torch.from_numpy(scores), torch.from_numpy(beta), width, cut, STAY
    )
    np.testing.assert_array_equal(states.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(moves.numpy(), np.asarray(mv_ref))


@pytest.mark.parametrize("width,cut", [(8, 100.0), (32, 4.0)])
def test_plain_beam_other_width_and_cut(width, cut):
    """A narrow beam keeps the bisection busy; a tight cut keeps few alive."""
    scores, beta = _case(64, 80, 1.0, n=4)
    st_ref, mv_ref = jax_beam.beam_search_device(
        jnp.asarray(scores), jnp.asarray(beta), width, cut, STAY
    )
    st, mv = beam.beam_search_plain(
        torch.from_numpy(scores), torch.from_numpy(beta), width, cut, STAY
    )
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))


def test_history_and_traceback_are_consistent():
    scores, beta = _case(64, 50, 2.0, n=3)
    hist_state, hist_ps, final = beam.beam_forward(
        torch.from_numpy(scores), torch.from_numpy(beta), 32, 100.0, STAY
    )
    assert hist_state.shape == hist_ps.shape == (50, 3, 32) and final.shape == (3, 32)
    assert hist_ps.dtype == torch.uint8 and int((hist_ps & 0x7F).max()) < 32
    states, moves = beam.beam_traceback(hist_state, hist_ps, final)
    assert bool((moves[:, 0] == 1).all())
    # a stay keeps the state; a step shifts one base in
    prev, cur = states[:, :-1].long(), states[:, 1:].long()
    stepped = moves[:, 1:].bool()
    assert bool((cur[~stepped] == prev[~stepped]).all())
    assert bool(((cur[stepped] >> 2) == (prev[stepped] & 15)).all())


# T below the kernel's chunk of 32 steps and between chunks, N that fills no
# warp
@pytest.mark.parametrize("t_len,n", [(1, 1), (17, 3), (45, 5)])
def test_traceback_matches_jax_on_one_history(t_len, n):
    """``beam_traceback`` on CPU tensors (its plain version) against the JAX
    package's ``_traceback`` on one history made from a seed: the ps byte is
    the parent with the stay in bit 7. ``final_score`` ties two elements
    for the best, and the first index wins."""
    rs = np.random.RandomState(10 * t_len + n)
    hist_state = rs.randint(0, 256, (t_len, n, 32)).astype(np.int32)
    parent = rs.randint(0, 32, (t_len, n, 32)).astype(np.int8)
    stay = rs.rand(t_len, n, 32) < 0.3
    final = rs.randn(n, 32).astype(np.float32)
    final[:, 7] = final.max(axis=1) + 1.0
    final[:, 20] = final[:, 7]
    st_ref, mv_ref = jax_beam._traceback(
        jnp.asarray(hist_state), jnp.asarray(parent), jnp.asarray(stay), jnp.asarray(final)
    )
    ps = parent.astype(np.uint8) | (stay.astype(np.uint8) << 7)
    launches = beam.beam_traceback.launches
    st, mv = beam.beam_traceback(
        torch.from_numpy(hist_state), torch.from_numpy(ps), torch.from_numpy(final)
    )
    assert beam.beam_traceback.launches == launches
    assert st.dtype == torch.int32 and mv.dtype == torch.uint8 and st.shape == (n, t_len)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))
    np.testing.assert_array_equal(st[:, -1].numpy(), hist_state[-1, :, 7])
    assert bool((mv[:, 0] == 1).all())


def test_crc_helpers_match_jax():
    rs = np.random.RandomState(3)
    np.testing.assert_array_equal(beam._CRC2.astype(np.uint32), np.asarray(jax_beam._CRC2))
    np.testing.assert_array_equal(beam._CRC8.astype(np.uint32), np.asarray(jax_beam._CRC8))
    crc = rs.randint(0, 2**32, size=(4, 32), dtype=np.int64)
    word = rs.randint(0, 1024, size=(4, 32), dtype=np.int64)
    bits = rs.randint(0, 4, size=(4, 32), dtype=np.int64)
    ref32 = jax_beam._crc32(jnp.asarray(crc.astype(np.uint32)), jnp.asarray(word.astype(np.int32)))
    ref2 = jax_beam._crc2(jnp.asarray(crc.astype(np.uint32)), jnp.asarray(bits.astype(np.uint32)))
    out32 = beam._crc32(torch.from_numpy(crc), torch.from_numpy(word), torch.from_numpy(beam._CRC8))
    out2 = beam._crc2(torch.from_numpy(crc), torch.from_numpy(bits), torch.from_numpy(beam._CRC2))
    np.testing.assert_array_equal(out32.numpy().astype(np.uint32), np.asarray(ref32))
    np.testing.assert_array_equal(out2.numpy().astype(np.uint32), np.asarray(ref2))


def test_init_takes_the_best_states_in_state_order():
    back0 = torch.tensor([[0.0, 3.0, 1.0, 3.0, 2.0, -1.0, 5.0, 0.5]])
    assert beam.beam_init(back0, 4).tolist() == [[1, 3, 4, 6]]


def test_crc32_is_32_bitwise_steps():
    """The kernel hashes the initial states a bit at a time; the table-driven
    ``_crc32`` must be the same function."""
    word = torch.arange(0, 1024, 7)
    crc = torch.full_like(word, beam._CRC_SEED) ^ word
    for _ in range(32):
        crc = (crc >> 1) ^ torch.where((crc & 1) == 1, beam._POLY, 0)
    table = torch.from_numpy(beam._CRC8)
    assert torch.equal(crc, beam._crc32(torch.full_like(word, beam._CRC_SEED), word, table))


@pytest.mark.parametrize("num_states", [64, 256, 1024])
def test_kernel_takes_its_state_counts(num_states):
    """The kernel's wrapper takes 64, 256 and 1024 states at width 32: a
    tensor off the CPU passes its state check and reaches the device check
    (a meta tensor here, which is no CUDA tensor)."""
    t = 4
    scores = torch.empty(t, 2, 4 * num_states, device="meta")
    guide = torch.empty(t + 1, 2, num_states, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        beam.beam_forward(scores, guide, 32)
    with pytest.raises(ValueError, match="the kernel takes beam width 32"):
        beam.beam_forward(scores, guide, 16)


def test_kernel_refuses_other_state_counts():
    with pytest.raises(ValueError, match="the kernel takes beam width 32"):
        beam.beam_forward(torch.empty(4, 2, 4 * 4096, device="meta"),
                          torch.empty(5, 2, 4096, device="meta"), 32)


def test_bad_arguments_raise():
    scores = torch.zeros(5, 2, 256)
    with pytest.raises(ValueError, match="back_guide"):
        beam.beam_search_device(scores, torch.zeros(5, 2, 64))
    with pytest.raises(ValueError, match="beam_width"):
        beam.beam_search_device(scores, torch.zeros(6, 2, 64), beam_width=65)
