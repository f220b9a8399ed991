"""The port's LSTM recurrence (plain version of the CUDA kernel) against the
JAX package's Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.ops.lstm import lstm_scan_time_major as jax_lstm_scan
from dorado_tpu_torch.ops.lstm import lstm_scan_time_major


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
