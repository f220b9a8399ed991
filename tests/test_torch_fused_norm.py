"""The port's fused matmul + bias + scaled residual + RMSNorm (K14's plain
version, CPU) against the JAX package's ``matmul_residual_rmsnorm`` (the
Pallas kernel in interpret mode) on the same seeded inputs, at sup's width
(512 outputs) and both of its sites: out_proj (K = 512, with a bias) and
fc2 (K = 2048, none).

Float32: 2e-5 relative and absolute, the JAX package's own test's tolerance
against the unfused sequence. bf16: the port rounds the residual sum
``bf16(acc) + bf16(residual * alpha)`` to bf16 before the norm, as the JAX
kernel is written; XLA on the CPU keeps that sum in float32 (it may skip a
rounding whose result is cast back to float32), so the sums part by up to
half a bf16 step, and the normalised row is rounded once more after the
weight multiplies it. Outputs must be within two bf16 steps (2^-6 relative)
of the larger of the value and 1, the scale of a normalised row (measured:
1.39e-2 of it at most; 81% of outputs equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.ops.fused_norm import matmul_residual_rmsnorm as jax_fused
from dorado_tpu_torch.ops import fused_norm

O = 512
ALPHA = 2.4494897  # sup's deepnorm alpha
CASES = [(bias, k, dtype) for dtype in ("float32", "bfloat16") for k in (512, 2048)
         for bias in (True, False)]


def _inputs(k, bias, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 150, k).astype(np.float32)
    w = (rs.randn(O, k) / np.sqrt(k)).astype(np.float32)
    b = rs.randn(O).astype(np.float32) if bias else None
    res = rs.randn(2, 150, O).astype(np.float32)
    nw = rs.randn(O).astype(np.float32)
    return x, w, b, res, nw


@pytest.mark.parametrize("bias,k,dtype", CASES)
def test_plain_matches_pallas_interpret(bias, k, dtype):
    x, w, b, res, nw = _inputs(k, bias, k + bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_fused(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), None if b is None else jnp.asarray(b),
        jnp.asarray(res, jdt), jnp.asarray(nw, jdt), ALPHA, interpret=True,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    launches = fused_norm.matmul_residual_rmsnorm.launches
    out = fused_norm.matmul_residual_rmsnorm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        None if b is None else torch.from_numpy(b), torch.from_numpy(res).to(tdt),
        torch.from_numpy(nw).to(tdt), ALPHA,
    )
    assert fused_norm.matmul_residual_rmsnorm.launches == launches  # a CPU tensor launches nothing
    assert out.dtype == tdt and out.shape == (2, 150, O)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    else:
        assert np.all(np.abs(out - ref) <= 2.0**-6 * np.maximum(np.abs(ref), 1.0))


def test_plain_is_the_unfused_sequence():
    """In float32 the plain version equals the model's unfused out_proj +
    residual + ``rms_norm`` up to the order of the product's sums."""
    from dorado_tpu_torch.models.tx_model import rms_norm

    x, w, b, res, nw = (torch.from_numpy(a) for a in _inputs(512, True, 0))
    out = fused_norm.matmul_residual_rmsnorm(x, w, b, res, nw, ALPHA)
    ref = rms_norm(torch.nn.functional.linear(x, w, b) + res * ALPHA, nw)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
