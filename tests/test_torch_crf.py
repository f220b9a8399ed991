"""The port's CRF lattice code against the JAX package: the plain versions
of the CUDA decode kernels (backward LSE scan, fused forward pass,
traceback, the raw-layout full-history LSE scan in both directions, the
standalone Viterbi forward pass and the float32 fused forward pass) against
the Pallas kernels in interpret mode, and the raw-layout plain scans against
``dorado_tpu.ops.crf_scan``.

Scores are multiples of 1/8 in [-5, 5]: every Viterbi sum is then exact in
float32 and in the Pallas kernel's hi/lo bf16 copy (``_dot2``), so choices,
states and moves must agree exactly, ties included. LSE values and posts
agree to 1e-4 relative: ``_dot2`` copies to about 2^-17 relative, and the
sums run in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.ops import crf_scan as jax_scan
from dorado_tpu.ops.crf_pallas import (
    _fused_forward_decode_blk,
    _lse_scan_pallas,
    _lse_scan_pallas_blk,
    _viterbi_fwd_pallas,
    _viterbi_fwd_pallas_blk,
    backward_scores_pallas,
    block_permutation,
    forward_scores_pallas,
    fused_forward_decode_pallas,
    viterbi_path_pallas,
    viterbi_traceback_pallas,
)
from dorado_tpu_torch.ops import crf_cuda, crf_scan

STAY = 2.0
T, N = 24, 8


def _scores(num_states, seed):
    rs = np.random.RandomState(seed)
    x = np.round(rs.randn(T, N, 4 * num_states) * 2.0 * 8) / 8
    return np.clip(x, -5, 5).astype(np.float32)


def _lse_close(out, ref):
    # 1e-4 relative to the magnitude of the values compared
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)


@pytest.fixture(scope="module", params=[64, 256], ids=["S64", "S256"])
def lattice(request):
    s = request.param
    raw = _scores(s, seed=s)
    blk = jnp.asarray(raw[..., block_permutation(s)])
    beta_jax = _lse_scan_pallas_blk(blk, STAY, True, True, prepermuted=True, shifted=True)
    posts_jax, choices_jax, final_jax = _fused_forward_decode_blk(
        blk, beta_jax, STAY, True, prepermuted=True, beta_shifted=True
    )
    return s, raw, np.array(beta_jax), (
        np.array(posts_jax), np.array(choices_jax), np.array(final_jax)
    )


def test_backward_scan_shifted_matches_pallas(lattice):
    s, raw, beta_jax, _ = lattice
    out = crf_cuda.backward_scores_shifted(torch.from_numpy(raw), STAY)
    assert out.dtype == torch.float32 and out.shape == (T, N, s)
    assert crf_cuda.backward_scores_shifted.launches == 0
    _lse_close(out.numpy(), beta_jax)


def test_fused_forward_decode_matches_pallas(lattice):
    s, raw, beta_jax, (posts_jax, choices_jax, final_jax) = lattice
    posts, choices, final = crf_cuda.fused_forward_decode(
        torch.from_numpy(raw), torch.from_numpy(beta_jax), STAY
    )
    np.testing.assert_array_equal(choices.numpy(), choices_jax)
    np.testing.assert_array_equal(final.numpy(), final_jax)
    np.testing.assert_allclose(posts.numpy(), posts_jax, rtol=1e-4, atol=1e-7)


def test_traceback_matches_pallas(lattice):
    _, _, _, (_, choices_jax, final_jax) = lattice
    last = np.argmax(final_jax, axis=-1).astype(np.int32)
    st_ref, mv_ref = viterbi_traceback_pallas(
        jnp.asarray(choices_jax), jnp.asarray(last), interpret=True
    )
    st, mv = crf_cuda.viterbi_traceback(
        torch.from_numpy(choices_jax), torch.from_numpy(last)
    )
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))


# T below the kernel's chunk of 32 steps and between chunks, N that fills no
# warp, and each state count the kernel takes
@pytest.mark.parametrize("num_states", [64, 256, 1024])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("t_len", [1, 17])
def test_traceback_matches_pallas_at_ragged_shapes(t_len, n, num_states):
    """K5's wrapper on CPU tensors (its plain version) against the Pallas
    traceback in interpret mode, on choices in 0..4 made from a seed: states
    and moves exact. Every choice at t = 0 is a stay, whose move is 1 all
    the same."""
    rs = np.random.RandomState(100 * t_len + 10 * n + num_states)
    choices = rs.randint(0, 5, (t_len, n, num_states)).astype(np.int8)
    choices[0] = 4
    last = rs.randint(0, num_states, n).astype(np.int32)
    st_ref, mv_ref = viterbi_traceback_pallas(
        jnp.asarray(choices), jnp.asarray(last), interpret=True
    )
    launches = crf_cuda.viterbi_traceback.launches
    st, mv = crf_cuda.viterbi_traceback(torch.from_numpy(choices), torch.from_numpy(last))
    assert crf_cuda.viterbi_traceback.launches == launches
    assert st.dtype == torch.int32 and mv.dtype == torch.uint8 and st.shape == (t_len, n)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))
    np.testing.assert_array_equal(st[-1].numpy(), last)
    assert bool((mv[0] == 1).all())


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("num_states", [64, 256])
def test_lse_scan_wrappers_match_pallas(num_states, reverse):
    """``forward_scores``/``backward_scores`` (K6's wrappers, on CPU tensors)
    against the raw-layout Pallas scan in interpret mode: the same
    [T+1, N, S] history, init row included."""
    raw = _scores(num_states, seed=21 + num_states)
    ref = np.asarray(_lse_scan_pallas(jnp.asarray(raw), STAY, reverse, True))
    wrapper = crf_cuda.backward_scores if reverse else crf_cuda.forward_scores
    out = wrapper(torch.from_numpy(raw), STAY)
    assert wrapper.launches == 0
    assert out.dtype == torch.float32 and out.shape == (T + 1, N, num_states)
    assert not out[T if reverse else 0].any()
    _lse_close(out.numpy(), ref)


@pytest.mark.parametrize("num_states", [64, 256])
def test_plain_scans_match_xla(num_states):
    raw = _scores(num_states, seed=7 + num_states)
    sc = torch.from_numpy(raw)
    _lse_close(
        crf_scan.forward_scores(sc, STAY).numpy(),
        np.asarray(jax_scan.forward_scores(jnp.asarray(raw), STAY)),
    )
    _lse_close(
        crf_scan.backward_scores(sc, STAY).numpy(),
        np.asarray(jax_scan.backward_scores(jnp.asarray(raw), STAY)),
    )
    st, mv = crf_scan.viterbi_path(sc, STAY)
    st_ref, mv_ref = jax_scan.viterbi_path(jnp.asarray(raw), STAY)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))


def test_fused_decode_agrees_with_separate_scans():
    """The fused path's posts equal softmax(alpha + beta) of the separate
    plain scans, and its choices trace back to the Viterbi path."""
    raw = torch.from_numpy(_scores(256, seed=11))
    posts, choices, final = crf_cuda.fused_viterbi_decode(raw, STAY)
    alpha = crf_scan.forward_scores(raw, STAY)
    beta = crf_scan.backward_scores(raw, STAY)
    ref = torch.softmax(alpha + beta, dim=-1)[1:]
    np.testing.assert_allclose(posts.numpy(), ref.numpy(), rtol=1e-4, atol=1e-7)
    st, mv = crf_cuda.viterbi_traceback(choices, torch.argmax(final, -1).to(torch.int32))
    st_ref, mv_ref = crf_scan.viterbi_path(raw, STAY)
    np.testing.assert_array_equal(st.numpy(), st_ref.numpy())
    np.testing.assert_array_equal(mv.numpy(), mv_ref.numpy())


# ---------------------------------------------------------------------------
# sup's 1024 states (state_len 5), at a tiny T and N
# ---------------------------------------------------------------------------

T5, N5, S5 = 6, 2, 1024


@pytest.fixture(scope="module")
def lattice_1024():
    from dorado_tpu.ops.crf_pallas import fused_viterbi_decode

    rs = np.random.RandomState(1024)
    raw = np.clip(np.round(rs.randn(T5, N5, 4 * S5) * 2.0 * 8) / 8, -5, 5).astype(np.float32)
    blk = jnp.asarray(raw[..., block_permutation(S5)])
    posts, choices, final = fused_viterbi_decode(blk, STAY, interpret=True, prepermuted=True)
    return raw, np.array(posts), np.array(choices), np.array(final)


def test_fused_viterbi_decode_matches_pallas_at_1024_states(lattice_1024):
    """The whole Viterbi decode path on the CPU (K3's, K4's and K5's plain
    versions) against ``fused_viterbi_decode`` and the traceback kernel in
    interpret mode: choices, final carry, states and moves exact on the 1/8
    score grid, posts to 1e-4 relative."""
    raw, posts_jax, choices_jax, final_jax = lattice_1024
    posts, choices, final = crf_cuda.fused_viterbi_decode(torch.from_numpy(raw), STAY)
    assert posts.shape == (T5, N5, S5) and choices.dtype == torch.int8
    np.testing.assert_array_equal(choices.numpy(), choices_jax)
    np.testing.assert_array_equal(final.numpy(), final_jax)
    np.testing.assert_allclose(posts.numpy(), posts_jax, rtol=1e-4, atol=1e-7)
    last = torch.argmax(final, dim=-1).to(torch.int32)
    st_ref, mv_ref = viterbi_traceback_pallas(
        jnp.asarray(choices_jax), jnp.asarray(last.numpy()), interpret=True
    )
    st, mv = crf_cuda.viterbi_traceback(choices, last)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))
    assert mv.numpy().sum() > T5  # the path moves


def test_backward_scan_matches_pallas_at_1024_states(lattice_1024):
    raw = lattice_1024[0]
    blk = jnp.asarray(raw[..., block_permutation(S5)])
    ref = _lse_scan_pallas_blk(blk, STAY, True, True, prepermuted=True, shifted=True)
    out = crf_cuda.backward_scores_shifted(torch.from_numpy(raw), STAY)
    assert out.shape == (T5, N5, S5)
    _lse_close(out.numpy(), np.asarray(ref))


def test_check_scores_takes_the_states_each_kernel_is_built_for():
    """The wrappers' shape check (reached on CUDA tensors) takes 64, 256 and
    1024 states, in either stream type, for every kernel of the module, the
    full-history scan included; the device check comes after the shape
    check."""
    for states in (64, 256, 1024):
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="expected a CUDA tensor"):
                crf_cuda._check_scores(torch.zeros(2, 1, 4 * states, dtype=dtype), dtype)
    for states in (16, 4096):
        with pytest.raises(ValueError, match="unsupported shape"):
            crf_cuda._check_scores(torch.zeros(2, 1, 4 * states), torch.float32)


# ---------------------------------------------------------------------------
# the full-history scans at 1024 states (K3's block kernels in JAX), the
# standalone Viterbi forward pass (K7a, K7b) and the float32 fused forward
# pass (K8)
# ---------------------------------------------------------------------------

T6, N6 = 16, 4


def _small_scores(num_states, seed):
    rs = np.random.RandomState(seed)
    x = np.round(rs.randn(T6, N6, 4 * num_states) * 2.0 * 8) / 8
    return np.clip(x, -5, 5).astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_lse_scan_wrappers_match_block_kernels_at_1024_states(reverse):
    """``forward_scores``/``backward_scores`` at C = 4096 against
    ``forward_scores_pallas``/``backward_scores_pallas``, which take the
    block-layout kernel there (K3's ``_lse_fwd_blk_kernel`` and the
    unshifted ``_lse_bwd_blk_kernel``): the same [T+1, N, S] history, init
    row included, to 1e-4 relative."""
    raw = _small_scores(1024, seed=44 + reverse)
    ref_fn = backward_scores_pallas if reverse else forward_scores_pallas
    ref = np.asarray(ref_fn(jnp.asarray(raw), STAY, interpret=True))
    wrapper = crf_cuda.backward_scores if reverse else crf_cuda.forward_scores
    out = wrapper(torch.from_numpy(raw), STAY)
    assert wrapper.launches == 0
    assert out.dtype == torch.float32 and out.shape == (T6 + 1, N6, 1024)
    assert not out[T6 if reverse else 0].any()
    _lse_close(out.numpy(), ref)


@pytest.mark.parametrize("num_states", [64, 256, 1024])
def test_viterbi_forward_matches_pallas(num_states):
    """``viterbi_forward`` against ``_viterbi_fwd_pallas`` (K7a, dense raw
    layout) at 64 and 256 states and ``_viterbi_fwd_pallas_blk`` (K7b, which
    permutes to the block layout inside) at 1024: choices identical, the
    final carry within 1e-5 (equal on the 1/8 score grid)."""
    raw = _small_scores(num_states, seed=3 * num_states)
    pallas = _viterbi_fwd_pallas_blk if num_states == 1024 else _viterbi_fwd_pallas
    ch_ref, fin_ref = pallas(jnp.asarray(raw), STAY, True)
    choices, final = crf_cuda.viterbi_forward(torch.from_numpy(raw), STAY)
    assert crf_cuda.viterbi_forward.launches == 0
    assert choices.dtype == torch.int8 and choices.shape == (T6, N6, num_states)
    np.testing.assert_array_equal(choices.numpy(), np.asarray(ch_ref))
    np.testing.assert_allclose(final.numpy(), np.asarray(fin_ref), rtol=0, atol=1e-5)
    assert (choices.numpy() == 4).any() and (choices.numpy() < 4).any()


# T of one step and one that fills no register ring of the kernel (eight rows,
# four at 1024 states), N of one row and one that fills no warp, at each state
# count the kernel takes
@pytest.mark.parametrize("num_states", [64, 256, 1024])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("t_len", [1, 17])
def test_viterbi_forward_matches_pallas_at_ragged_shapes(t_len, n, num_states):
    """``viterbi_forward`` on CPU tensors (K7's plain version) against
    ``_viterbi_fwd_pallas`` (K7a) and ``_viterbi_fwd_pallas_blk`` (K7b) in
    interpret mode: choices identical, the final carry within 1e-5."""
    raw = _ragged_scores(t_len, n, num_states)
    pallas = _viterbi_fwd_pallas_blk if num_states == 1024 else _viterbi_fwd_pallas
    ch_ref, fin_ref = pallas(jnp.asarray(raw), STAY, True)
    launches = crf_cuda.viterbi_forward.launches
    choices, final = crf_cuda.viterbi_forward(torch.from_numpy(raw), STAY)
    assert crf_cuda.viterbi_forward.launches == launches
    assert choices.dtype == torch.int8 and choices.shape == (t_len, n, num_states)
    assert final.dtype == torch.float32 and final.shape == (n, num_states)
    np.testing.assert_array_equal(choices.numpy(), np.asarray(ch_ref))
    np.testing.assert_allclose(final.numpy(), np.asarray(fin_ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("num_states", [256, 1024])
def test_viterbi_path_matches_pallas(num_states):
    """``viterbi_path`` (the Viterbi forward pass, then the traceback)
    against ``viterbi_path_pallas``: states and moves identical."""
    raw = _small_scores(num_states, seed=5 + num_states)
    st_ref, mv_ref = viterbi_path_pallas(jnp.asarray(raw), STAY, interpret=True)
    st, mv = crf_cuda.viterbi_path(torch.from_numpy(raw), STAY)
    assert st.dtype == torch.int32 and mv.dtype == torch.uint8 and st.shape == (T6, N6)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))
    assert 0 < int(mv.numpy()[1:].sum()) < (T6 - 1) * N6  # the path both steps and stays


@pytest.mark.parametrize("num_states", [64, 256])
def test_fused_forward_decode_full_matches_pallas(num_states):
    """``fused_forward_decode_full`` (K8's plain version) against
    ``fused_forward_decode_pallas`` on the beta history of the JAX backward
    scan: posts within 1e-5, choices identical and equal to
    ``viterbi_forward``'s, the final carry within 1e-5."""
    raw = _small_scores(num_states, seed=9 + num_states)
    beta = _lse_scan_pallas(jnp.asarray(raw), STAY, True, True)
    posts_ref, ch_ref, fin_ref = fused_forward_decode_pallas(jnp.asarray(raw), beta, STAY, True)
    posts, choices, final = crf_cuda.fused_forward_decode_full(
        torch.from_numpy(raw), torch.from_numpy(np.array(beta)), STAY
    )
    assert crf_cuda.fused_forward_decode_full.launches == 0
    assert posts.dtype == torch.float32 and posts.shape == (T6, N6, num_states)
    np.testing.assert_allclose(posts.numpy(), np.asarray(posts_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(choices.numpy(), np.asarray(ch_ref))
    np.testing.assert_allclose(final.numpy(), np.asarray(fin_ref), rtol=0, atol=1e-5)
    ch_vit, fin_vit = crf_cuda.viterbi_forward(torch.from_numpy(raw), STAY)
    assert torch.equal(choices, ch_vit) and torch.equal(final, fin_vit)


# ---------------------------------------------------------------------------
# ragged shapes: T below the kernels' register rings (eight rows, four at
# 1024 states) and N no multiple of 8, at 64, 256 and 1024 states
# ---------------------------------------------------------------------------

RAGGED = [(3, 5, 64), (7, 3, 256), (3, 3, 1024)]


def _ragged_scores(t_len, n, num_states):
    rs = np.random.RandomState(t_len * n + num_states)
    x = np.round(rs.randn(t_len, n, 4 * num_states) * 2.0 * 8) / 8
    return np.clip(x, -5, 5).astype(np.float32)


@pytest.mark.parametrize("t_len,n,num_states", RAGGED)
def test_backward_scan_shifted_matches_pallas_at_ragged_shapes(t_len, n, num_states):
    """K3's shifted stream (its plain version, on a CPU tensor) against
    ``_lse_scan_pallas_blk`` with ``shifted=True`` in interpret mode."""
    raw = _ragged_scores(t_len, n, num_states)
    blk = jnp.asarray(raw[..., block_permutation(num_states)])
    ref = _lse_scan_pallas_blk(blk, STAY, True, True, prepermuted=True, shifted=True)
    out = crf_cuda.backward_scores_shifted(torch.from_numpy(raw), STAY)
    assert out.shape == (t_len, n, num_states)
    _lse_close(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("t_len,n,num_states", RAGGED)
def test_lse_scans_match_pallas_at_ragged_shapes(t_len, n, num_states):
    """The full histories (K6, and K3's at 1024 states) on CPU tensors: the
    one-launch pair ``forward_backward_scores`` equals ``forward_scores`` and
    ``backward_scores``, and both match ``forward_scores_pallas`` and
    ``backward_scores_pallas`` in interpret mode, init rows included."""
    raw = _ragged_scores(t_len, n, num_states)
    sc = torch.from_numpy(raw)
    alpha, beta = crf_cuda.forward_backward_scores(sc, STAY)
    assert crf_cuda.forward_backward_scores.launches == 0
    assert torch.equal(alpha, crf_cuda.forward_scores(sc, STAY))
    assert torch.equal(beta, crf_cuda.backward_scores(sc, STAY))
    assert alpha.shape == beta.shape == (t_len + 1, n, num_states)
    assert not alpha[0].any() and not beta[t_len].any()
    for out, ref_fn in ((alpha, forward_scores_pallas), (beta, backward_scores_pallas)):
        _lse_close(out.numpy(), np.asarray(ref_fn(jnp.asarray(raw), STAY, interpret=True)))
