"""The port's W8A8 matmuls (CPU, plain versions) against the JAX package:
the weight and row quantisation, ``w8a8_matmul_fq``, ``swiglu_w8a8`` and
``w8a8_matmul`` in Pallas interpret mode, the quantised LSTM model's layers,
and the whole model's scores; and the launch plans of K2 and K12 at every
weight shape their wrappers take.

The plain version follows the Pallas body (it multiplies by the row scale's
reciprocal), so it is held against the interpret-mode kernel, not against the
off-TPU fallback (which divides).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.models.crf_model import init_lstm_crf_params as jax_init
from dorado_tpu.models.crf_model import lstm_crf_forward, quantize_lstm_crf_params_w8a8
from dorado_tpu.models.presets import fast_v40_config as jax_fast_config
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.ops import int8_matmul as jax_int8
from dorado_tpu_torch.models.crf_model import params_from_jax, quantize_lstm_crf_w8a8
from dorado_tpu_torch.models.presets import fast_v40_config, hac_v43_config
from dorado_tpu_torch.ops import int8_matmul


def _hac128(cfg, layers=5):
    """hac v4.3's shape at LSTM width 128, the narrowest the W8A8 path takes."""
    cfg.lstm_size = 128
    cfg.convs[2].size = 128
    cfg.lstm_layers = layers
    return cfg


def _np_params(cfg, seed):
    return jax.tree_util.tree_map(np.array, jax_init(cfg, jax.random.PRNGKey(seed)))


def test_quantize_weight_rows_matches_jax():
    w = np.random.RandomState(0).randn(256, 128).astype(np.float32)
    w[7] = 0.0  # an all-zero channel takes the 1e-12 floor
    wq_ref, ws_ref = jax_int8.quantize_weight_rows(jnp.asarray(w))
    wq, ws = int8_matmul.quantize_weight_rows(torch.from_numpy(w))
    assert wq.dtype == torch.int8 and ws.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_ref))
    # the same float32 operations in both: 1e-7 relative
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_ref), rtol=1e-7, atol=0)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(out_dtype):
    """21 rows: no multiple of the interpret run's 8-row blocks."""
    rs = np.random.RandomState(1)
    x = rs.randn(21, 128).astype(np.float32)
    x[3] = 0.0
    wq_t, ws = jax_int8.quantize_weight(rs.randn(256, 128).astype(np.float32))
    bias = rs.randn(256).astype(np.float32)
    ref = np.asarray(
        jax_int8.w8a8_matmul_fq(
            jnp.asarray(x), wq_t, ws, bias=jnp.asarray(bias), block_m=8, block_n=128,
            out_dtype=getattr(jnp, out_dtype), interpret=True,
        ).astype(jnp.float32)
    )
    calls = int8_matmul.w8a8_matmul_fq.launches
    out = int8_matmul.w8a8_matmul_fq(
        torch.from_numpy(x), torch.from_numpy(np.array(wq_t)), torch.from_numpy(np.array(ws)),
        torch.from_numpy(bias), out_dtype=getattr(torch, out_dtype),
    )
    assert int8_matmul.w8a8_matmul_fq.launches == calls  # a CPU tensor launches nothing
    assert out.shape == (21, 256) and out.dtype == getattr(torch, out_dtype)
    out = out.float().numpy()
    if out_dtype == "float32":
        # exact int32 sums, then three float32 roundings in both
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 step (2^-8 relative, rounded up to the value's binade)
        assert np.all(np.abs(out - ref) <= 2.0**-7 * np.abs(ref) + 1e-30)
        assert np.mean(out != ref) < 0.01


def test_leading_dims_and_no_bias():
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(5, 3, 128).astype(np.float32))
    w = torch.from_numpy(rs.randn(128, 128).astype(np.float32))
    wq, ws = int8_matmul.quantize_weight_rows(w)
    out = int8_matmul.w8a8_matmul_fq(x, wq.t(), ws, out_dtype=torch.float32)
    flat = int8_matmul.w8a8_matmul_fq_plain(x.reshape(15, 128), wq.t(), ws, None, torch.float32)
    assert out.shape == (5, 3, 128)
    assert torch.equal(out.reshape(15, 128), flat)
    # close to the unquantised product (int8 on both sides: a few percent)
    want = x.reshape(15, 128) @ (wq.float() * ws[:, None]).t()
    assert torch.linalg.norm(flat - want) / torch.linalg.norm(want) < 0.02


def test_quantised_model_matches_jax_quantised_params():
    jcfg, tcfg = _hac128(jax_hac_config(), 2), _hac128(hac_v43_config(), 2)
    params = _np_params(jcfg, 3)
    ours = quantize_lstm_crf_w8a8(params_from_jax(params, tcfg))
    theirs = params_from_jax(quantize_lstm_crf_params_w8a8(params), tcfg)
    for a, b in zip(ours.lstms, theirs.lstms):
        assert not hasattr(a, "w_ih") and not hasattr(b, "w_ih")
        assert a.w_ih_q.dtype == torch.int8 and tuple(a.w_ih_q.shape) == (512, 128)
        assert torch.equal(a.w_ih_q, b.w_ih_q)
        np.testing.assert_allclose(a.w_ih_s.numpy(), b.w_ih_s.numpy(), rtol=1e-7, atol=0)
        for name in ("w_hh", "b_ih", "b_hh"):
            assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(ours.linear1_w, theirs.linear1_w)
    # the input model is left as it was, and quantising twice changes nothing
    again = quantize_lstm_crf_w8a8(ours)
    assert torch.equal(again.lstms[0].w_ih_q, ours.lstms[0].w_ih_q)


def test_fast_layers_stay_unquantised():
    jcfg, tcfg = jax_fast_config(), fast_v40_config()
    params = _np_params(jcfg, 4)
    assert "w_ih" in quantize_lstm_crf_params_w8a8(params)["lstms"][0]  # H = 96
    model = params_from_jax(params, tcfg)
    quantised = quantize_lstm_crf_w8a8(model)
    for a, b in zip(quantised.lstms, model.lstms):
        assert not hasattr(a, "w_ih_q") and torch.equal(a.w_ih, b.w_ih)


def test_w8a8_model_scores_match_jax():
    """The whole quantised model against ``lstm_crf_forward(qp, ...,
    use_pallas=True)``: the JAX package's time-major stack, its LSTM kernel in
    interpret mode and its W8A8 projection's off-TPU path. That path divides
    by the row scale where the port multiplies by its reciprocal, so a
    quantised activation can differ by one int8 step at a rounding boundary
    (here none does: the scores differ by 1e-7); the scores, in [-5, 5],
    must agree to 1e-4."""
    jcfg, tcfg = _hac128(jax_hac_config(), 3), _hac128(hac_v43_config(), 3)
    params = _np_params(jcfg, 5)
    qp = quantize_lstm_crf_params_w8a8(params)
    sig = np.random.RandomState(5).randn(3, 6 * 40).astype(np.float32)
    ref = np.asarray(lstm_crf_forward(qp, jnp.asarray(sig), jcfg, use_pallas=True))
    full = np.asarray(lstm_crf_forward(params, jnp.asarray(sig), jcfg, use_pallas=True))
    with torch.no_grad():
        out = params_from_jax(qp, tcfg)(torch.from_numpy(sig)).numpy().transpose(1, 0, 2)
        own = quantize_lstm_crf_w8a8(params_from_jax(params, tcfg))(torch.from_numpy(sig))
    np.testing.assert_array_equal(own.numpy().transpose(1, 0, 2), out)
    assert out.shape == ref.shape == (3, 40, 4**5)
    err = np.abs(out - ref)
    assert err.max() <= 1e-4
    # and the quantisation itself stays close to the unquantised model: the
    # JAX test's 0.02 on the relative norm; its argmax limit of 0.98 is for
    # full width, and over these 120 positions at H = 128 one flip is 0.8%
    rel = np.linalg.norm(out - full) / np.linalg.norm(full)
    assert rel < 0.02 and (out.argmax(-1) == full.argmax(-1)).mean() > 0.95


def test_quantize_rows_matches_jax():
    x = np.random.RandomState(6).randn(4, 9, 128).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero row takes the 1e-12 floor
    xq_ref, xs_ref = jax_int8.quantize_rows(jnp.asarray(x))
    xq, xs = int8_matmul.quantize_rows(torch.from_numpy(x))
    assert xq.dtype == torch.int8 and xs.dtype == torch.float32 and xs.shape == (4, 9, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_ref))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_ref))


def _quantised_rows_and_weights(m, k, f, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32)
    x[min(3, m - 1)] = 0.0
    xq, xs = jax_int8.quantize_rows(jnp.asarray(x))
    weights = [
        jax_int8.quantize_weight(rs.randn(f, k).astype(np.float32) / np.sqrt(k))
        for _ in range(2)
    ]
    return xq, xs, weights


def _t(a):
    return torch.from_numpy(np.array(a))


# (rows, K, F): rows that are no multiple of the interpret run's 8-row blocks,
# and sup's own widths
SWIGLU_SHAPES = [(21, 128, 256), (40, 512, 2048)]


@pytest.mark.parametrize("m,k,f", SWIGLU_SHAPES)
def test_swiglu_plain_matches_pallas_interpret(m, k, f):
    """K12's plain version against the Pallas body: the int8 output equal but
    for +-1 at no more than 0.1% of elements (the two ``exp`` may differ in
    the last bit; measured: none differ), the row scales to 1e-6 relative."""
    xq, xs, ((wy, wys), (wg, wgs)) = _quantised_rows_and_weights(m, k, f, 7)
    tq_ref, ts_ref = jax_int8.swiglu_w8a8(xq, xs, wy, wys, wg, wgs, block_m=8, interpret=True)
    calls = int8_matmul.swiglu_w8a8.launches
    tq, ts = int8_matmul.swiglu_w8a8(_t(xq), _t(xs), _t(wy), _t(wys), _t(wg), _t(wgs))
    assert int8_matmul.swiglu_w8a8.launches == calls  # a CPU tensor launches nothing
    assert tq.dtype == torch.int8 and tq.shape == (m, f)
    assert ts.dtype == torch.float32 and ts.shape == (m, 1)
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(tq_ref).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(ts.numpy(), np.asarray(ts_ref), rtol=1e-6, atol=0)
    # the requantised product is the SwiGLU of the dequantised inputs
    y = (np.asarray(xq, np.float32) * np.asarray(xs)) @ (np.asarray(wy, np.float32) * wys)
    g = (np.asarray(xq, np.float32) * np.asarray(xs)) @ (np.asarray(wg, np.float32) * wgs)
    want = y * g / (1.0 + np.exp(-g))
    got = tq.numpy().astype(np.float32) * ts.numpy()
    assert np.abs(got - want).max() <= 0.51 * ts.numpy().max() + 1e-4


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,o", [(21, 256, 128), (40, 2048, 512)])
def test_w8a8_matmul_plain_matches_pallas_interpret(m, k, o, out_dtype):
    """K13's plain version against the Pallas body: exact int32 sums and two
    float32 roundings in both, so equal in float32 and in bf16."""
    xq, xs, ((wq_t, ws), _) = _quantised_rows_and_weights(m, k, o, 8)
    ref = jax_int8.w8a8_matmul(
        xq, xs, wq_t, ws, block_m=8, out_dtype=getattr(jnp, out_dtype), interpret=True
    ).astype(jnp.float32)
    calls = int8_matmul.w8a8_matmul.launches
    out = int8_matmul.w8a8_matmul(
        _t(xq), _t(xs), _t(wq_t), _t(ws), out_dtype=getattr(torch, out_dtype)
    )
    assert int8_matmul.w8a8_matmul.launches == calls
    assert out.shape == (m, o) and out.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref))


def test_w8a8_feed_forward_leading_dims():
    """[N, T, K] rows go through both wrappers as the model passes them."""
    xq, xs, ((wy, wys), (wg, wgs)) = _quantised_rows_and_weights(12, 128, 256, 9)
    args = [_t(wy), _t(wys), _t(wg), _t(wgs)]
    tq, ts = int8_matmul.swiglu_w8a8(_t(xq).reshape(3, 4, 128), _t(xs).reshape(3, 4, 1), *args)
    flat_q, flat_s = int8_matmul.swiglu_w8a8_plain(_t(xq), _t(xs), *args)
    assert tq.shape == (3, 4, 256) and ts.shape == (3, 4, 1)
    assert torch.equal(tq.reshape(12, 256), flat_q) and torch.equal(ts.reshape(12, 1), flat_s)
    w2, w2s = int8_matmul.quantize_weight_rows(torch.randn(128, 256))
    out = int8_matmul.w8a8_matmul(tq, ts, w2.t(), w2s, out_dtype=torch.float32)
    assert out.shape == (3, 4, 128)
    assert torch.equal(
        out.reshape(12, 128),
        int8_matmul.w8a8_matmul_plain(flat_q, flat_s, w2.t(), w2s, torch.float32),
    )


# ---------------------------------------------------------------------------
# K2's, K12's and K13's launch plans: the host side of the kernels, checked at
# every weight shape the wrappers take (the kernels themselves run on the card)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448  # shared memory a block may use on the H100
PLAN_ROWS = [1, 127, 128, 357, 131072, 213248]
ACTIVE_CLUSTERS = [1, 7, 15, 66]  # clusters a card might run at once


def _check_grid(plan, m):
    """The grid is whole clusters, no more than the card runs at once;
    returns the 128-row blocks of m rows."""
    for active in ACTIVE_CLUSTERS:
        grid = plan.grid(m, active)
        assert grid > 0 and grid % plan.cluster == 0
        assert grid // plan.cluster <= active
    return -(-m // 128)


@pytest.mark.parametrize("k", [128, 256, 384, 512, 640, 768])
def test_fq_plan_every_output_width(k):
    """Two A buffers up to K = 512, one above; at least one output tile's
    slabs in the ring; within the card's shared memory; clusters of two over
    pairs of row blocks, every pair covered."""
    for o in range(128, 3072 + 1, 128):
        plan = int8_matmul.w8a8_fq_plan(k, o)
        assert (plan.k, plan.o, plan.cluster) == (k, o, 2)
        assert plan.a_buffers == (2 if k <= 512 else 1)
        assert k // 128 <= plan.stages <= 8
        assert plan.smem <= SMEM_LIMIT
        for m in PLAN_ROWS:
            _check_grid(plan, m)
            pairs = -(-(-(-m // 128)) // 2)
            assert plan.grid(m, 10**6) == 2 * pairs  # enough clusters: one a pair


def test_fq_plan_at_the_main_paths():
    """hac's input projections and sup's qkv: two A buffers, the deepest
    ring that fits (six and four 16 KB stages), 231,584 bytes a CTA."""
    hac, sup = int8_matmul.w8a8_fq_plan(384, 1536), int8_matmul.w8a8_fq_plan(512, 1536)
    assert (hac.a_buffers, hac.stages, hac.smem) == (2, 6, 231_584)
    assert (sup.a_buffers, sup.stages, sup.smem) == (2, 4, 231_584)


@pytest.mark.parametrize("k", [128, 256, 384, 512])
def test_swiglu_plan_every_feature_width(k):
    """One pass exactly where F / 64 has a divisor C <= 8 with F / C <= 256
    (the largest such C), the two-pass form elsewhere; within the card's
    shared memory; the CTAs of a cluster own F's features once each; the
    cluster size divides the grid."""
    for f in range(64, 4096 + 1, 64):
        plan = int8_matmul.swiglu_plan(k, f)
        tiles = f // 64
        fits = [c for c in range(1, 9) if tiles % c == 0 and tiles // c <= 4]
        assert plan.one_pass == bool(fits)
        if plan.one_pass:
            assert plan.cluster == max(fits) and plan.features <= 256
        else:
            assert plan.cluster == 1 and plan.features == f
        assert 1 <= plan.cluster <= 8 and plan.features % 64 == 0
        # CTA r of a cluster owns features [r * features, (r + 1) * features)
        owned = [i for r in range(plan.cluster)
                 for i in range(r * plan.features, (r + 1) * plan.features)]
        assert owned == list(range(f))
        assert 2 <= plan.stages <= 8 and plan.smem <= SMEM_LIMIT
        for m in PLAN_ROWS:
            blocks = _check_grid(plan, m)
            assert plan.grid(m, 10**6) == plan.cluster * blocks  # one cluster a block
        two = int8_matmul.swiglu_plan(k, f, two_pass=True)
        assert not two.one_pass and two.cluster == 1 and two.smem <= SMEM_LIMIT


def test_swiglu_plan_at_sup():
    """sup's fc1 (K = 512, F = 2048): one pass, clusters of 8 CTAs of 256
    features, four 8 KB stages beside x (64 KB) and t (128 KB)."""
    plan = int8_matmul.swiglu_plan(512, 2048)
    assert (plan.one_pass, plan.cluster, plan.features, plan.stages) == (True, 8, 256, 4)
    assert plan.smem == 232_136


@pytest.mark.parametrize("k,o", [(0, 128), (64, 128), (100, 128), (896, 128), (128, 0), (128, 64),
                                 (384, 1000)])
def test_fq_refuses_what_it_refused(k, o):
    """The same shapes are refused with the same error, by the plan and by
    the wrapper before anything reaches a card (a tensor on the meta device
    takes the CUDA path)."""
    msg = re.escape(f"w8a8_matmul_fq: unsupported weight shape {(k, o)}")
    with pytest.raises(ValueError, match=msg):
        int8_matmul.w8a8_fq_plan(k, o)
    x = torch.empty(4, max(k, 1), dtype=torch.bfloat16, device="meta")
    w = torch.empty(max(o, 1), max(k, 1), dtype=torch.int8, device="meta")[:o, :k]
    with pytest.raises(ValueError, match=msg):
        int8_matmul.w8a8_matmul_fq(x[:, :k], w.t(), torch.empty(o, device="meta"))


@pytest.mark.parametrize("k,f", [(0, 64), (64, 64), (640, 64), (128, 0), (128, 32), (256, 100)])
def test_swiglu_refuses_what_it_refused(k, f):
    msg = re.escape(f"swiglu_w8a8: unsupported weight shape {(k, f)}")
    with pytest.raises(ValueError, match=msg):
        int8_matmul.swiglu_plan(k, f)
    xq = torch.empty(4, k, dtype=torch.int8, device="meta")
    xs = torch.empty(4, 1, device="meta")
    w = torch.empty(k, f, dtype=torch.int8, device="meta")
    s = torch.empty(f, device="meta")
    with pytest.raises(ValueError, match=msg):
        int8_matmul.swiglu_w8a8(xq, xs, w, s, w, s)


@pytest.mark.parametrize("k", [128, 256, 384, 512, 1024, 2048])
def test_w8a8_plan_every_output_width(k):
    """Clusters of the most column tiles up to four that divide O / 128 (so
    the clusters' tiles cover O's once each, and a cluster's CTAs split a
    128-row x slab evenly); the deepest ring of 32 KB stages that fits the
    card's shared memory; the grid whole clusters, one a work unit when
    enough run at once."""
    for o in range(128, 3072 + 1, 128):
        plan = int8_matmul.w8a8_plan(k, o)
        tiles = o // 128
        assert (plan.k, plan.o) == (k, o)
        assert plan.cluster == max(c for c in (1, 2, 4) if tiles % c == 0)
        assert 128 % plan.cluster == 0
        assert plan.smem <= SMEM_LIMIT
        assert plan.stages == 8 or plan.smem + 2 * 128 * 128 > SMEM_LIMIT
        # cluster c of a row block owns column tiles [c * cluster, (c + 1) * cluster)
        owned = [c * plan.cluster + r for c in range(tiles // plan.cluster)
                 for r in range(plan.cluster)]
        assert owned == list(range(tiles))
        for m in PLAN_ROWS:
            blocks = _check_grid(plan, m)
            assert plan.grid(m, 10**6) == blocks * tiles  # one CTA a tile


def test_w8a8_plan_at_sup():
    """sup's fc2 (K = 2048, O = 512): clusters of the four column tiles of a
    row block, six 32 KB stages beside the two 16 KB output tiles."""
    plan = int8_matmul.w8a8_plan(2048, 512)
    assert (plan.cluster, plan.stages, plan.smem) == (4, 6, 230_528)


@pytest.mark.parametrize("k,o", [(0, 128), (64, 128), (100, 128), (128, 0), (128, 64),
                                 (2048, 500)])
def test_w8a8_refuses_what_it_refused(k, o):
    """The same shapes are refused with the same error, by the plan and by
    the wrapper before anything reaches a card (a tensor on the meta device
    takes the CUDA path)."""
    msg = re.escape(f"w8a8_matmul: unsupported weight shape {(k, o)}")
    with pytest.raises(ValueError, match=msg):
        int8_matmul.w8a8_plan(k, o)
    xq = torch.empty(4, k, dtype=torch.int8, device="meta")
    xs = torch.empty(4, 1, device="meta")
    w = torch.empty(k, o, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match=msg):
        int8_matmul.w8a8_matmul(xq, xs, w, torch.empty(o, device="meta"))
