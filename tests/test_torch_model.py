"""The port's LSTM-CRF forward pass (CPU, float32) against the JAX
package's ``lstm_crf_forward`` on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dorado_tpu.models.crf_model import init_lstm_crf_params as jax_init
from dorado_tpu.models.crf_model import lstm_crf_forward
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu_torch.models.crf_model import init_lstm_crf_params, params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config


def _narrow_hac(cfg):
    """hac v4.3's shape (3 convs, stride 6, 5 LSTM layers, state_len 4) at
    LSTM width 32."""
    cfg.lstm_size = 32
    cfg.convs[2].size = 32
    return cfg


def test_forward_matches_jax():
    jcfg, tcfg = _narrow_hac(jax_hac_config()), _narrow_hac(hac_v43_config())
    params = jax.tree_util.tree_map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(5)))
    sig = np.random.RandomState(5).randn(3, 6 * 40).astype(np.float32)
    ref = np.asarray(lstm_crf_forward(params, jnp.asarray(sig), jcfg))  # [N, T, C]
    model = params_from_jax(params, tcfg)
    with torch.no_grad():
        out = model(torch.from_numpy(sig))  # [T, N, C]
    assert out.shape == (40, 3, 4**5) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy().transpose(1, 0, 2), ref, rtol=0, atol=1e-4)


def test_random_init_shapes_and_determinism():
    cfg = _narrow_hac(hac_v43_config())
    a = init_lstm_crf_params(cfg, torch.Generator().manual_seed(1))
    b = init_lstm_crf_params(cfg, torch.Generator().manual_seed(1))
    jparams = jax_init(_narrow_hac(jax_hac_config()), jax.random.PRNGKey(0))
    assert [tuple(w.shape) for w in a.conv_w] == [
        tuple(np.asarray(p["w"]).shape[::-1]) for p in jparams["convs"]
    ]
    assert tuple(a.lstms[0].w_ih.shape) == tuple(jparams["lstms"][0]["w_ih"].shape)
    assert tuple(a.linear1_w.shape) == tuple(jparams["linear1"]["w"].shape)
    assert a.linear1_b is None and "b" not in jparams["linear1"]
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
