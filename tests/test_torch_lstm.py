"""The port's LSTM recurrences (the plain versions of the CUDA kernels: K1,
K15 with int8 recurrent weights, K16 with the input projection inside)
against the JAX package's Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.ops.lstm import lstm_fused_time_major as jax_lstm_fused
from dorado_tpu.ops.lstm import lstm_scan_time_major as jax_lstm_scan
from dorado_tpu.ops.lstm import lstm_scan_time_major_int8 as jax_lstm_int8
from dorado_tpu.ops.lstm import quantize_lstm_weights as jax_quantize
from dorado_tpu_torch.ops.lstm import (
    _k1_smem,
    k1_cluster_shape,
    k1_plan,
    lstm_fused_time_major,
    lstm_scan_time_major,
    lstm_scan_time_major_f32,
    lstm_scan_time_major_int8,
    quantize_lstm_weights,
    slice_w_hh,
    w_ih_fragments,
)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_pallas(reverse):
    t, n, h = 16, 8, 32
    rs = np.random.RandomState(3)
    xproj = (rs.randn(t, n, 4 * h) * 0.8).astype(np.float32)
    w_hh_t = (rs.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    ref = np.asarray(
        jax_lstm_scan(jnp.asarray(xproj), jnp.asarray(w_hh_t), reverse=reverse, interpret=True)
    )
    out = lstm_scan_time_major(torch.from_numpy(xproj), torch.from_numpy(w_hh_t), reverse=reverse)
    assert out.dtype == torch.float32 and out.shape == (t, n, h)
    # float32 both sides; only the summation order of h @ W differs
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_f32_matches_pallas_at_the_modbase_shape(reverse):
    """K1 float32's plain version (the wrapper on CPU tensors, and
    ``lstm_scan_time_major`` on float32 ones) against the Pallas kernel in
    interpret mode at the modbase models' H = 256 and T = 32 (a chunk of 192
    samples at stride 6): float32 both sides, atol 1e-5 as above."""
    t, n, h = 32, 8, 256
    rs = np.random.RandomState(17)
    xproj = (rs.randn(t, n, 4 * h) * 0.8).astype(np.float32)
    w_hh_t = (rs.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    ref = np.asarray(
        jax_lstm_scan(jnp.asarray(xproj), jnp.asarray(w_hh_t), reverse=reverse, interpret=True)
    )
    x_t, w_t = torch.from_numpy(xproj), torch.from_numpy(w_hh_t)
    out = lstm_scan_time_major_f32(x_t, w_t, reverse=reverse)
    assert out.dtype == torch.float32 and out.shape == (t, n, h)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert torch.equal(lstm_scan_time_major(x_t, w_t, reverse=reverse), out)
    assert lstm_scan_time_major_f32.launches == 0


# K15 and K16 at two widths and both directions, float32 and bf16. The
# tolerances: float32 both sides, only the summation order of the products
# differs (K15's int32 sums are exact on both, so only its float steps), as
# above; in bf16 each output is rounded to bf16 and a rounding near a tie can
# go the other way, which later steps carry on: one bf16 step (2^-8 below 1)
# plus that once carried, at no more than 1% of outputs.
K_CASES = [(24, 8, 32), (16, 4, 64)]


def _k15_inputs(t, n, h, seed):
    rs = np.random.RandomState(seed)
    xproj = (rs.randn(t, n, 4 * h) * 0.8).astype(np.float32)
    w_hh_t = (rs.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    return xproj, w_hh_t


def _close(out: np.ndarray, ref: np.ndarray, dtype) -> None:
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    else:
        diff = np.abs(out - ref)
        assert diff.max() <= 2.0**-7
        assert (diff > 0).mean() <= 0.01


def test_quantize_lstm_weights_bit_equal_to_jax():
    _, w = _k15_inputs(1, 1, 64, 5)
    wq_j, sc_j = jax_quantize(jnp.asarray(w))
    wq_t, sc_t = quantize_lstm_weights(torch.from_numpy(w))
    assert wq_t.dtype == torch.int8 and sc_t.dtype == torch.float32
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
# and a ragged case: T, N and H no multiple of the JAX kernel's tiles or of
# K15's (8 rows, 16 units)
@pytest.mark.parametrize("t,n,h", K_CASES + [(5, 3, 48)])
def test_lstm_scan_int8_matches_pallas(t, n, h, reverse, dtype):
    """K15's plain version against its Pallas kernel in interpret mode."""
    xproj, w = _k15_inputs(t, n, h, 11 + h)
    wq, sc = jax_quantize(jnp.asarray(w))
    ref = jax_lstm_int8(jnp.asarray(xproj, dtype), wq, sc, reverse=reverse, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    x_t = torch.from_numpy(xproj).to(getattr(torch, dtype))
    out = lstm_scan_time_major_int8(
        x_t, torch.from_numpy(np.array(wq)), torch.from_numpy(np.array(sc)), reverse=reverse
    )
    assert out.dtype == x_t.dtype and out.shape == (t, n, h)
    _close(out.float().numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,n,h", K_CASES)
def test_lstm_fused_matches_pallas(t, n, h, reverse, dtype):
    """K16's plain version against its Pallas kernel in interpret mode."""
    rs = np.random.RandomState(3 + h)
    x = rs.randn(t, n, h).astype(np.float32)
    w_ih_t = (rs.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    w_hh_t = (rs.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    bias = (rs.randn(4 * h) * 0.1).astype(np.float32)
    ref = jax_lstm_fused(
        jnp.asarray(x, dtype), jnp.asarray(w_ih_t, dtype), jnp.asarray(w_hh_t, dtype),
        jnp.asarray(bias), reverse=reverse, interpret=True,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    out = lstm_fused_time_major(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w_ih_t).to(tdt),
        torch.from_numpy(w_hh_t).to(tdt), torch.from_numpy(bias), reverse=reverse,
    )
    assert out.dtype == tdt and out.shape == (t, n, h)
    _close(out.float().numpy(), ref, dtype)


# K1's host-side helpers: the cluster shape and rows a cluster it launches
# with, and the per-CTA slices of W_hh it copies into shared memory.


@pytest.mark.parametrize("h", range(4, 513, 4))
def test_k1_cluster_shape_fits_every_width(h):
    """Every width the wrapper takes gets a cluster whose CTAs hold their W
    slice, two h buffers and the staging at 8 rows, whose units cover H, and
    whose m-tiles split over the warps one or two a warp."""
    cluster, units, warps = k1_cluster_shape(h)
    assert cluster in (1, 2, 4, 8, 16) and units % 16 == 0
    assert cluster * units >= h
    assert 1 <= warps <= 12 and (units // 4) % warps == 0 and units // 4 // warps <= 2
    assert _k1_smem(units, cluster, 8) <= 232448
    # the smallest cluster that fits: half of it would not hold W
    if cluster > 1:
        half = -(-h // (cluster // 2))
        half += -half % 16
        assert _k1_smem(half, cluster // 2, 8) > 232448 or (half // 4) > 24


@pytest.mark.parametrize(
    "h,shape", [(384, (8, 48, 12)), (96, (1, 96, 12)), (512, (16, 32, 8)), (32, (1, 32, 8))]
)
def test_k1_cluster_shape_at_the_models_widths(h, shape):
    """hac's H = 384 takes clusters of 8 (147 KB of W a CTA), fast's 96 one
    CTA, 512 a non-portable cluster of 16."""
    assert k1_cluster_shape(h) == shape


@pytest.mark.parametrize(
    "h,n,active,rows,clusters",
    [
        (384, 128, 15, 16, 8),  # 15 clusters of 8 at once: 16 rows, one wave
        (384, 128, 16, 8, 16),
        (384, 512, 15, 40, 13),  # the -b 0 sweep's choice, still one wave
        (384, 256, 15, 24, 11),
        (384, 100, 15, 8, 13),  # a ragged batch: the last cluster part full
        (384, 1, 15, 8, 1),
        (384, 2000, 15, 40, 50),  # beyond what shared memory holds: more waves
        (512, 1024, 7, 32, 32),
        (96, 512, 132, 8, 64),
    ],
)
def test_k1_plan_rows_a_cluster(h, n, active, rows, clusters):
    plan = k1_plan(h, n, active)
    assert (plan.rows, plan.clusters) == (rows, clusters)
    assert plan.rows * plan.clusters >= n > plan.rows * (plan.clusters - 1)
    assert _k1_smem(plan.units, plan.cluster, plan.rows) <= 232448


@pytest.mark.parametrize("h", [384, 96, 512, 36, 324])
def test_slice_w_hh_reassembles_w_hh(h):
    """The slices hold every weight once, at CTA c's row 4 j + gate and k,
    and zeros where the unit or k is past H."""
    rs = np.random.RandomState(h)
    w = torch.from_numpy(rs.randn(h, 4 * h).astype(np.float32)).bfloat16()
    cluster, units, _ = k1_cluster_shape(h)
    sl = slice_w_hh(w, cluster, units)
    kp = -(-cluster * units // 32) * 32
    assert sl.shape == (cluster, 4 * units, kp) and sl.dtype == w.dtype
    # [c, j, gate, k] -> [k, gate, c * units + j]
    back = sl.reshape(cluster, units, 4, kp).permute(3, 2, 0, 1).reshape(kp, 4, cluster * units)
    assert torch.equal(back[:h, :, :h].reshape(h, 4 * h), w)
    assert not back[h:].any() and not back[:, :, h:].any()


# K15's host-side helpers: it launches on K1's kernel and cluster shape with
# int8 elements (``elem_bytes=1``): W_i8's slices are half of W_hh's bytes, a
# pair of k-tiles is 64 k, h is held as int8.


@pytest.mark.parametrize("h", range(16, 513, 16))
def test_k15_plan_fits_every_width(h):
    """Every width K15's wrapper takes launches on K1's cluster shape, and
    its int8 slices, h buffers and stagings take less shared memory than
    K1's bf16 ones at every rows a cluster."""
    cluster, units, warps = k1_cluster_shape(h)
    assert k1_plan(h, 1, 1, elem_bytes=1)[:3] == (cluster, units, warps)
    for rows in range(8, 49, 8):
        assert _k1_smem(units, cluster, rows, elem_bytes=1) < _k1_smem(units, cluster, rows)


@pytest.mark.parametrize(
    "h,smem",
    # hac's H in clusters of 8 (77 KB of W_i8 a CTA), fast's 96 one CTA, 512
    # in clusters of 16, a JAX test width, and the ragged test width 48 (h
    # held as blocks of 48 bytes, no padding)
    [(384, 83_728), (96, 60_688), (512, 80_656), (32, 12_560), (48, 17_680)],
)
def test_k15_shared_memory_at_the_models_widths(h, smem):
    cluster, units, _ = k1_cluster_shape(h)
    assert _k1_smem(units, cluster, 8, elem_bytes=1) == smem


@pytest.mark.parametrize(
    "h,n,active,rows,clusters",
    [
        (384, 128, 15, 16, 8),  # hac's batch: K1's split
        (384, 512, 15, 40, 13),
        (384, 37, 15, 8, 5),
        (384, 100, 15, 8, 13),
        (384, 2000, 15, 48, 42),  # int8 fits 48 rows where bf16 fits 40
        (96, 512, 132, 8, 64),
        (512, 128, 7, 24, 6),
    ],
)
def test_k15_plan_rows_a_cluster(h, n, active, rows, clusters):
    plan = k1_plan(h, n, active, elem_bytes=1)
    assert (plan.rows, plan.clusters) == (rows, clusters)
    assert plan.rows * plan.clusters >= n > plan.rows * (plan.clusters - 1)
    assert _k1_smem(plan.units, plan.cluster, plan.rows, elem_bytes=1) <= 232448


@pytest.mark.parametrize("h", [32, 48, 96, 384, 512])
def test_slice_w_i8_reassembles_w_i8(h):
    """K15's slices of W_i8 in K1's layout, at a depth rounded up to 64 k (a
    pair of int8 k-tiles): every weight once, at CTA c's row 4 j + gate and
    k, and zeros where the unit or k is past H."""
    rs = np.random.RandomState(h)
    w, _ = quantize_lstm_weights(torch.from_numpy(rs.randn(h, 4 * h).astype(np.float32)))
    cluster, units, _ = k1_cluster_shape(h)
    sl = slice_w_hh(w, cluster, units)
    kp = -(-cluster * units // 64) * 64
    assert sl.shape == (cluster, 4 * units, kp) and sl.dtype == torch.int8
    back = sl.reshape(cluster, units, 4, kp).permute(3, 2, 0, 1).reshape(kp, 4, cluster * units)
    assert torch.equal(back[:h, :, :h].reshape(h, 4 * h), w)
    assert not back[h:].any() and not back[:, :, h:].any()


# K16's host-side helpers: it launches on K1's kernel and plan with two x
# buffers beside K1's shared memory (``fused=True``), and reads W_ih from L2
# as the mma fragments of its slices.


@pytest.mark.parametrize(
    "h,shape",
    # hac, fast, the widest the wrapper takes, a padded one, and the JAX
    # kernel test widths (K_CASES)
    [(384, (8, 48, 12)), (96, (1, 96, 12)), (512, (16, 32, 8)), (36, (1, 48, 12)),
     (32, (1, 32, 8)), (64, (1, 64, 8))],
)
def test_k16_cluster_shape_at_the_models_widths(h, shape):
    """K16 keeps K1's cluster at every width the models use: the x buffers
    fit beside the W_hh slice at 8 rows."""
    assert k1_cluster_shape(h, fused=True) == shape == k1_cluster_shape(h)
    cluster, units, _ = shape
    assert _k1_smem(units, cluster, 8, fused=True) <= 232448


@pytest.mark.parametrize("h", range(4, 513, 4))
def test_k16_cluster_shape_fits_every_width(h):
    """Every width K16's wrapper takes gets a cluster whose CTAs hold the
    W_hh slice and the x buffers at 8 rows: K1's, or a larger one where the
    x buffers leave K1's short of room (H = 260 to 320)."""
    cluster, units, warps = k1_cluster_shape(h, fused=True)
    assert cluster in (1, 2, 4, 8, 16) and units % 16 == 0 and cluster * units >= h
    assert 1 <= warps <= 12 and (units // 4) % warps == 0 and units // 4 // warps <= 2
    assert _k1_smem(units, cluster, 8, fused=True) <= 232448
    assert cluster >= k1_cluster_shape(h)[0]


@pytest.mark.parametrize(
    "h,n,active,rows,clusters",
    [
        (384, 128, 15, 16, 8),  # hac's batch: one wave, as K1
        (384, 512, 15, 16, 32),  # x's buffers hold the rows a cluster at 16
        (384, 37, 15, 8, 5),
        (96, 128, 132, 8, 16),
        (512, 128, 7, 16, 8),
        (36, 37, 132, 8, 5),
    ],
)
def test_k16_plan_rows_a_cluster(h, n, active, rows, clusters):
    plan = k1_plan(h, n, active, fused=True)
    assert (plan.rows, plan.clusters) == (rows, clusters)
    assert plan.rows * plan.clusters >= n > plan.rows * (plan.clusters - 1)
    assert _k1_smem(plan.units, plan.cluster, plan.rows, fused=True) <= 232448
    assert _k1_smem(plan.units, plan.cluster, plan.rows, fused=True) > _k1_smem(
        plan.units, plan.cluster, plan.rows)


@pytest.mark.parametrize("h", [384, 96, 512, 36, 32, 64])
def test_w_ih_fragments_reassemble_w_ih(h):
    """Lane l's 8 values of CTA c's m-tile mt and k-tile kt are rows l // 4
    and l // 4 + 8 of the tile at k 2 (l % 4), + 1, + 8, + 9 in the order of
    mma.sync's A fragment; put back, they give ``slice_w_hh``'s layout of
    W_ih, and so W_ih."""
    rs = np.random.RandomState(h)
    w = torch.from_numpy(rs.randn(h, 4 * h).astype(np.float32)).bfloat16()
    cluster, units, _ = k1_cluster_shape(h, fused=True)
    frag = w_ih_fragments(w, cluster, units)
    kp = -(-cluster * units // 32) * 32
    assert frag.shape == (cluster, units // 4, kp // 16, 32, 8) and frag.is_contiguous()
    tiles = torch.zeros(cluster, units // 4, kp // 16, 16, 16, dtype=w.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for e, (dr, dk) in enumerate([(0, 0), (0, 1), (8, 0), (8, 1),
                                      (0, 8), (0, 9), (8, 8), (8, 9)]):
            tiles[..., g + dr, 2 * t + dk] = frag[..., lane, e]
    back = tiles.permute(0, 1, 3, 2, 4).reshape(cluster, 4 * units, kp)
    assert torch.equal(back, slice_w_hh(w, cluster, units))


# K1 float32's host-side helpers: it launches on K1's kernel with float
# elements (``elem_bytes=4``): W's slices and h are twice K1's bytes, a pair of
# k-tiles is 16 k, a CTA's units are whole float32 k-tiles (8).


@pytest.mark.parametrize("h", range(4, 385, 4))
def test_k1_f32_cluster_shape_fits_every_width(h):
    """Every width K1 float32's wrapper takes (up to 384) gets a cluster whose
    CTAs hold their float32 W slice, h buffers and staging at 8 rows, whose
    units cover H in whole k-tiles, and whose m-tiles split over the warps
    one or two a warp; half the cluster would not hold W."""
    cluster, units, warps = k1_cluster_shape(h, elem_bytes=4)
    assert cluster in (1, 2, 4, 8, 16) and units % 8 == 0 and cluster * units >= h
    assert 1 <= warps <= 12 and (units // 4) % warps == 0 and units // 4 // warps <= 2
    assert _k1_smem(units, cluster, 8, elem_bytes=4) <= 232448
    if cluster > 1:
        half = -(-h // (cluster // 2))
        half += -half % 8
        assert _k1_smem(half, cluster // 2, 8, elem_bytes=4) > 232448 or half // 4 > 24
    assert k1_plan(h, 1, 1, elem_bytes=4)[:3] == (cluster, units, warps)


def test_k1_f32_refuses_wider_than_384():
    with pytest.raises(ValueError, match="in float32"):
        k1_cluster_shape(388, elem_bytes=4)


@pytest.mark.parametrize(
    "h,shape,smem",
    # the modbase models' H = 256 in clusters of 8 (133 KB of W a CTA), hac's
    # 384 in clusters of 16 of 24 units, and two test widths in one CTA
    [(256, (8, 32, 8), 153_872), (384, (16, 24, 6), 179_472), (32, (1, 32, 8), 23_056),
     (36, (1, 40, 10), 41_744)],
)
def test_k1_f32_cluster_shape_at_the_models_widths(h, shape, smem):
    assert k1_cluster_shape(h, elem_bytes=4) == shape
    cluster, units, _ = shape
    assert _k1_smem(units, cluster, 8, elem_bytes=4) == smem


@pytest.mark.parametrize(
    "h,n,active,rows,clusters",
    [
        (256, 128, 15, 16, 8),  # the modbase batch: one wave of 8 clusters
        (256, 1024, 15, 32, 32),  # shared memory holds 32 rows: three waves
        (256, 37, 15, 8, 5),
        (384, 128, 7, 16, 8),  # 16 rows at most at hac's H
        (32, 1024, 132, 8, 128),
    ],
)
def test_k1_f32_plan_rows_a_cluster(h, n, active, rows, clusters):
    plan = k1_plan(h, n, active, elem_bytes=4)
    assert (plan.rows, plan.clusters) == (rows, clusters)
    assert plan.rows * plan.clusters >= n > plan.rows * (plan.clusters - 1)
    assert _k1_smem(plan.units, plan.cluster, plan.rows, elem_bytes=4) <= 232448
    assert _k1_smem(plan.units, plan.cluster, plan.rows + 8, elem_bytes=4) > 232448 or (
        plan.rows * active >= n)


@pytest.mark.parametrize("h", [256, 384, 36, 32])
def test_slice_w_f32_reassembles_w_hh(h):
    """K1 float32's slices of W_hh in K1's layout, at a depth rounded up to 16
    k (a pair of float32 k-tiles): every weight once, zeros past H."""
    rs = np.random.RandomState(h)
    w = torch.from_numpy(rs.randn(h, 4 * h).astype(np.float32))
    cluster, units, _ = k1_cluster_shape(h, elem_bytes=4)
    sl = slice_w_hh(w, cluster, units)
    kp = -(-cluster * units // 16) * 16
    assert sl.shape == (cluster, 4 * units, kp) and sl.dtype == torch.float32
    back = sl.reshape(cluster, units, 4, kp).permute(3, 2, 0, 1).reshape(kp, 4, cluster * units)
    assert torch.equal(back[:h, :, :h].reshape(h, 4 * h), w)
    assert not back[h:].any() and not back[:, :, h:].any()
