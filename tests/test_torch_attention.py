"""The port's banded attention (CPU, plain versions) against the JAX
package: K9 against ``windowed_attention_ext_fused`` (the Pallas kernel, in
interpret mode, on the extended projection built from the same arrays) and
the strip loop ``windowed_attention`` that the JAX model runs off the TPU;
K10 against ``windowed_attention_qkv_rope`` and ``windowed_attention_ext``
(both into ``_banded_attention_call``), K11a against
``windowed_attention_halfperm`` and K11b against
``windowed_attention_fused``, all in interpret mode.

All in float32: the three compute the same sums in other orders, and the strip
loop rounds p to the stream dtype before p @ v, which in float32 is no
rounding. Outputs are O(1); they must agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.models.tx_model import apply_rope, rope_ext_tables, windowed_attention
from dorado_tpu.models.tx_model import rope_tables as jax_rope_tables
from dorado_tpu.ops import attention as jax_attention
from dorado_tpu.ops.attention import _band_bias_at, windowed_attention_ext_fused
from dorado_tpu_torch.ops import attention

N, H, D = 2, 2, 64
THETA = 10000.0
SUP_WINDOW = (127, 128)
# T' = 100 and 700 are no multiples of the TPU kernel's 256-query strips (nor
# of the CUDA kernel's 64-query blocks); the narrow window masks whole blocks
CASES = [(t, win) for t in (100, 256, 700) for win in (SUP_WINDOW, (5, 6))]


def _qkv(t_len, seed):
    return np.random.RandomState(seed).randn(N, t_len, 3 * H * D).astype(np.float32)


def _ours(qkv, t_len, win):
    cos, sin = attention.rope_tables(t_len, D, THETA)
    launches = attention.windowed_attention_rope.launches
    out = attention.windowed_attention_rope(torch.from_numpy(qkv), cos, sin, H, *win)
    assert attention.windowed_attention_rope.launches == launches  # a CPU tensor launches nothing
    assert out.shape == (N, t_len, H * D) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    return out.numpy()


@pytest.mark.parametrize("t_len,win", CASES)
def test_plain_matches_pallas_interpret(t_len, win):
    qkv = _qkv(t_len, t_len)
    ct, st, perm = rope_ext_tables(t_len, D, H, THETA)
    # [q | k | v | q_swap | k_swap]: the swap columns are copies of q and k columns
    ext = np.concatenate([qkv, qkv[..., : 2 * H * D][..., perm]], axis=-1)
    ref = windowed_attention_ext_fused(
        jnp.asarray(ext), jnp.stack([ct, st]), H, *win, interpret=True
    )
    np.testing.assert_allclose(_ours(qkv, t_len, win), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t_len,win", CASES)
def test_plain_matches_strip_loop(t_len, win):
    qkv = _qkv(t_len, 1000 + t_len)
    cos, sin = jax_rope_tables(t_len, D, THETA)
    q4 = jnp.asarray(qkv).reshape(N, t_len, 3, H, D)
    ref = windowed_attention(
        apply_rope(q4[:, :, 0], cos, sin), apply_rope(q4[:, :, 1], cos, sin), q4[:, :, 2], *win
    ).reshape(N, t_len, H * D)
    np.testing.assert_allclose(_ours(qkv, t_len, win), np.asarray(ref), rtol=0, atol=1e-5)


def test_rope_tables_match_jax():
    cos, sin = attention.rope_tables(300, D, THETA)
    cos_ref, sin_ref = jax_rope_tables(300, D, THETA)
    assert cos.dtype == torch.float32 and cos.shape == (300, D // 2)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(cos_ref))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(sin_ref))


@pytest.mark.parametrize("t_len,win", CASES + [(1024, SUP_WINDOW)])
def test_band_mask_matches_jax(t_len, win):
    ref_elems = attention.ref_strip_elems(t_len)
    pos = torch.arange(t_len)
    ours = attention.band_mask(pos[:, None], pos[None, :], t_len, *win, ref_elems).numpy()
    ref = np.asarray(_band_bias_at(0, 0, t_len, t_len, t_len, *win, ref_elems)) == 0.0
    np.testing.assert_array_equal(ours, ref)
    # every query attends itself, so no row is fully masked
    assert ours.diagonal().all()


def test_truncation_clips_one_key_of_each_strips_last_query():
    """At sup's window and T' = 1024 the reference's strips hold 88 queries;
    the last query of every strip but the last loses exactly its farthest
    key, and no other query loses any."""
    t_len, (wu, wl) = 1024, SUP_WINDOW
    ref_elems = attention.ref_strip_elems(t_len)
    assert ref_elems == 88
    pos = torch.arange(t_len)
    diff = pos[None, :] - pos[:, None]
    band = ((diff >= -wu) & (diff <= wl)).numpy()
    ours = attention.band_mask(pos[:, None], pos[None, :], t_len, wu, wl, ref_elems).numpy()
    lost = band & ~ours
    rows = np.flatnonzero(lost.any(axis=1))
    last_of_strips = np.arange(ref_elems - 1, t_len - wl, ref_elems)
    np.testing.assert_array_equal(rows, last_of_strips)
    for q in rows:
        np.testing.assert_array_equal(np.flatnonzero(lost[q]), [q + wl])


def test_stream_dtype_rounds_the_rotation():
    """In bf16 the rotated q and k are rounded to bf16 before the logits, as
    the TPU kernel rounds them: the plain version on bf16 input equals the
    float32 one fed the rounded rotation's inputs only approximately, and
    its output is bf16."""
    t_len = 128
    qkv = torch.from_numpy(_qkv(t_len, 5)).bfloat16()
    cos, sin = attention.rope_tables(t_len, D, THETA)
    out = attention.windowed_attention_rope(qkv, cos, sin, H, *SUP_WINDOW)
    assert out.dtype == torch.bfloat16
    q = qkv[..., : H * D].reshape(N, t_len, H, D)
    rot = attention.rope_rotate(q, cos, sin)
    assert rot.dtype == torch.bfloat16
    full = attention.rope_rotate(q.float(), cos, sin)
    assert torch.equal(rot, full.bfloat16())
    ref = attention.windowed_attention_rope(qkv.float(), cos, sin, H, *SUP_WINDOW)
    assert (out.float() - ref).abs().max() < 0.05


# ---------------------------------------------------------------------------
# K10, K11a, K11b
# ---------------------------------------------------------------------------

ROUTE_T = (100, 300, 700)


def _assert_plain(out, ref, shape):
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("jax_route", ["qkv_rope", "ext"])
@pytest.mark.parametrize("t_len", ROUTE_T)
def test_prerotated_matches_pallas_interpret(t_len, jax_route):
    """One port route for both JAX routes into ``_banded_attention_call``:
    the rotation pass ``rope_qk`` then K10's plain version."""
    qkv = _qkv(t_len, 2000 + t_len)
    if jax_route == "qkv_rope":
        cos, sin = jax_rope_tables(t_len, D, THETA)
        ref = jax_attention.windowed_attention_qkv_rope(
            jnp.asarray(qkv), cos, sin, H, *SUP_WINDOW, interpret=True
        )
    else:
        ct, st, perm = rope_ext_tables(t_len, D, H, THETA)
        ext = np.concatenate([qkv, qkv[..., : 2 * H * D][..., perm]], axis=-1)
        ref = jax_attention.windowed_attention_ext(
            jnp.asarray(ext), ct, st, H, *SUP_WINDOW, interpret=True
        )
    cos, sin = attention.rope_tables(t_len, D, THETA)
    qkv_t = torch.from_numpy(qkv)
    launches = attention.windowed_attention_prerotated.launches
    out = attention.windowed_attention_prerotated(
        attention.rope_qk(qkv_t, cos, sin, H), qkv_t, H, *SUP_WINDOW
    )
    assert attention.windowed_attention_prerotated.launches == launches
    _assert_plain(out, ref, (N, t_len, H * D))


@pytest.mark.parametrize("t_len", ROUTE_T)
def test_halfperm_matches_pallas_interpret(t_len):
    """The same projection with its q and k rows halves-major (the JAX
    package's permutation), JAX's [2, T, H*D] tables against the port's
    [T, D/2] ones."""
    qkv = _qkv(t_len, 3000 + t_len)
    rows = attention.wqkv_halfperm_rows(H, H * D)
    hp = np.ascontiguousarray(qkv[..., rows])
    ref = jax_attention.windowed_attention_halfperm(
        jnp.asarray(hp), jax_attention.rope_half_tables(t_len, D, H, THETA), H, *SUP_WINDOW,
        interpret=True,
    )
    cos, sin = attention.rope_tables(t_len, D, THETA)
    launches = attention.windowed_attention_halfperm.launches
    out = attention.windowed_attention_halfperm(torch.from_numpy(hp), cos, sin, H, *SUP_WINDOW)
    assert attention.windowed_attention_halfperm.launches == launches
    _assert_plain(out, ref, (N, t_len, H * D))


@pytest.mark.parametrize("win", [SUP_WINDOW, (200, 256)])
@pytest.mark.parametrize("t_len", ROUTE_T)
def test_separate_qkv_matches_pallas_interpret(t_len, win):
    """K11b at sup's window and at one above 128 keys a side (its limit is
    256)."""
    rs = np.random.RandomState(4000 + t_len)
    q, k, v = (rs.randn(N, t_len, H, D).astype(np.float32) for _ in range(3))
    ref = jax_attention.windowed_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *win, interpret=True
    )
    launches = attention.windowed_attention_fused.launches
    out = attention.windowed_attention_fused(*(torch.from_numpy(a) for a in (q, k, v)), *win)
    assert attention.windowed_attention_fused.launches == launches
    _assert_plain(out, ref, (N, t_len, H, D))


def test_rope_halfperm_matches_jax():
    for nhead, d in ((2, 64), (8, 64), (4, 16)):
        np.testing.assert_array_equal(
            attention.rope_halfperm(nhead, d), jax_attention.rope_halfperm(nhead, d)
        )
    # JAX's halves-major tables hold the [T, D/2] tables' cos and -sin | sin
    cos, sin = attention.rope_tables(50, D, THETA)
    ct, st = np.asarray(jax_attention.rope_half_tables(50, D, H, THETA))
    i = np.arange(H * D) % (D // 2)
    np.testing.assert_array_equal(ct, cos.numpy()[:, i])
    np.testing.assert_array_equal(st[:, : H * D // 2], -sin.numpy()[:, i[: H * D // 2]])
    np.testing.assert_array_equal(st[:, H * D // 2 :], sin.numpy()[:, i[H * D // 2 :]])


@pytest.mark.parametrize("win", [SUP_WINDOW, (5, 6)])
def test_routes_equal_k9_in_bf16(win):
    """The four layouts carry one function: in bf16 the plain versions of
    K10 (after ``rope_qk``), K11a (on the permuted projection) and K11b (on
    the rotated q, k and v) give K9's output bit for bit, as the kernels'
    staged tiles are bit-equal on the card."""
    t_len = 300
    qkv = torch.from_numpy(_qkv(t_len, 7)).bfloat16()
    cos, sin = attention.rope_tables(t_len, D, THETA)
    want = attention.windowed_attention_rope(qkv, cos, sin, H, *win)
    qk = attention.rope_qk(qkv, cos, sin, H)
    assert qk.dtype == torch.bfloat16
    assert torch.equal(attention.windowed_attention_prerotated(qk, qkv, H, *win), want)
    hp = qkv[..., torch.from_numpy(attention.wqkv_halfperm_rows(H, H * D))]
    assert torch.equal(attention.windowed_attention_halfperm(hp, cos, sin, H, *win), want)
    q, k = qk.reshape(N, t_len, 2, H, D).unbind(2)
    v = qkv[..., 2 * H * D :].reshape(N, t_len, H, D)
    out = attention.windowed_attention_fused(q, k, v, *win)
    assert torch.equal(out.reshape(N, t_len, H * D), want)
