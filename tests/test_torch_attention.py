"""The port's banded attention with RoPE inside (CPU, plain version) against
the JAX package: ``windowed_attention_ext_fused`` (the Pallas kernel, in
interpret mode, on the extended projection built from the same arrays) and
the strip loop ``windowed_attention`` that the JAX model runs off the TPU.

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
