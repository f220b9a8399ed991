"""The port's W8A8 input projection (CPU, plain version) against the JAX
package: the weight quantisation, ``w8a8_matmul_fq`` in Pallas interpret
mode, the quantised model's layers, and the whole model's scores.

The plain version follows the Pallas body (it multiplies by the row scale's
reciprocal), so it is held against the interpret-mode kernel, not against the
off-TPU fallback (which divides).
"""

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
