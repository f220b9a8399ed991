"""The port's transformer (sup) model on the CPU against the JAX package's
``tx_forward`` at ``tests/test_tx_model.py::small_sup_config`` width (2
layers, d_model 64, 4 heads, ffn 128, window (5, 6), the full conv stack's
stride 12 and the full 4096-transition CRF head), through the weight carrier
``tx_params_from_jax``.

Off the TPU ``tx_forward`` takes the strip-loop attention and the unfused
norms whatever its environment variables say, and, for W8A8 parameters, the
XLA fallbacks of the int8 kernels; the port takes the plain versions of its
kernels. Every attention and norm route of the port computes that one
function, so each is held against it. Float32 throughout.
"""

import copy
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.models.presets import sup_v50_config as jax_sup_config
from dorado_tpu.models.tx_model import init_tx_params as jax_init
from dorado_tpu.models.tx_model import quantize_tx_params, quantize_tx_params_w8a8, tx_forward
from dorado_tpu.models.tx_model import rms_norm as jax_rms_norm
from dorado_tpu_torch.models.presets import sup_v50_config
from dorado_tpu_torch.models.tx_model import (
    ATTENTION_ROUTES,
    TxModel,
    init_tx_params,
    quantize_tx_int8,
    quantize_tx_w8a8,
    rms_norm,
    set_routes,
    tx_params_from_jax,
    with_routes,
)
from dorado_tpu_torch.ops.attention import wqkv_halfperm_rows

CHUNK = 1152  # 6 x the transformer's chunk granularity of 192: T' = 96, T = 192


def small_sup(cfg):
    """``tests/test_tx_model.py::small_sup_config`` on either package's config."""
    cfg.tx.tx.depth = 2
    cfg.tx.tx.d_model = 64
    cfg.tx.tx.nhead = 4
    cfg.tx.tx.dim_feedforward = 128
    cfg.tx.tx.attn_window = (5, 6)
    cfg.tx.crf.insize = 64
    conv = type(cfg.convs[2])
    cfg.convs[1].size = 64
    cfg.convs[2] = conv(64, 64, 9, 3, cfg.convs[2].activation)
    cfg.convs[3] = conv(64, 64, 9, 2, cfg.convs[3].activation)
    cfg.convs[4] = conv(64, 64, 5, 2, cfg.convs[4].activation)
    return cfg


def jax_tx_params(seed):
    return jax.tree_util.tree_map(
        np.array, jax_init(small_sup(jax_sup_config()), jax.random.PRNGKey(seed))
    )


def with_drawn_biases(params, seed):
    """A copy of JAX parameters whose biases (convolutions, out_proj,
    upsample) and norm weights are drawn from ``seed``: the random init
    leaves them 0 and 1, where a route that dropped or misplaced one would
    go unseen."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.array, params)
    for conv in out["convs"]:
        conv["b"] = (0.1 * rs.randn(*conv["b"].shape)).astype(np.float32)
    for layer in out["layers"]:
        layer["out_proj_b"] = (0.1 * rs.randn(*layer["out_proj_b"].shape)).astype(np.float32)
        for name in ("norm1", "norm2"):
            layer[name] = (1.0 + 0.3 * rs.randn(*layer[name].shape)).astype(np.float32)
    out["upsample"]["b"] = (0.1 * rs.randn(*out["upsample"]["b"].shape)).astype(np.float32)
    return out


def _signal(seed):
    return np.random.RandomState(seed).randn(3, CHUNK).astype(np.float32)


def _scores(model, sig):
    """The port's time-major scores as the JAX model's [N, T, C]."""
    with torch.inference_mode():
        return model(torch.from_numpy(sig)).numpy().transpose(1, 0, 2)


def test_sup_preset_matches_jax():
    ours, theirs = sup_v50_config(), jax_sup_config()
    assert ours.is_tx_model and ours.num_states == theirs.num_states == 1024
    assert ours.chunk_size_granularity == theirs.chunk_size_granularity == 192
    for name in ("d_model", "nhead", "depth", "dim_feedforward", "attn_window",
                 "deepnorm_alpha", "theta"):
        assert getattr(ours.tx.tx, name) == getattr(theirs.tx.tx, name), name
    assert [(c.insize, c.size, c.winlen, c.stride, c.activation.value) for c in ours.convs] == [
        (c.insize, c.size, c.winlen, c.stride, c.activation.value) for c in theirs.convs
    ]
    assert (ours.tx.upsample.scale_factor, ours.tx.crf.scale, ours.tx.crf.outsize) == (
        theirs.tx.upsample.scale_factor, theirs.tx.crf.scale, theirs.tx.crf.outsize)
    assert (ours.basecaller.chunk_size, ours.basecaller.overlap, ours.basecaller.batch_size) == (
        theirs.basecaller.chunk_size, theirs.basecaller.overlap, theirs.basecaller.batch_size)
    assert (ours.qscale, ours.qbias, ours.stride) == (theirs.qscale, theirs.qbias, theirs.stride)


def test_rms_norm_matches_jax():
    rs = np.random.RandomState(0)
    x, w = rs.randn(5, 7, 64).astype(np.float32), rs.randn(64).astype(np.float32)
    ref = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w)))
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_float32_scores_match_jax(seed):
    """Scores reach about 30 in size (the head's weights are scaled by 5);
    float32 sums in another order through convolutions, two encoder layers
    and three matmuls: 2e-4 absolute (measured 3e-5)."""
    jcfg, tcfg = small_sup(jax_sup_config()), small_sup(sup_v50_config())
    params = jax_tx_params(seed)
    sig = _signal(seed)
    ref = np.asarray(tx_forward(params, jnp.asarray(sig), jcfg))
    out = _scores(tx_params_from_jax(params, tcfg), sig)
    assert out.shape == ref.shape == (3, CHUNK // 6, 4096)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)


@pytest.mark.parametrize("seed", [3, 4])
def test_w8a8_scores_match_jax(seed):
    """The W8A8 model against ``tx_forward`` on ``quantize_tx_params_w8a8``'s
    parameters. Each of the four activation quantisations a layer rounds to
    int8, and the float32 sums in front of them run in another order in the
    two packages, so a value at a rounding boundary lands on the other int8
    step now and then and the scores part there: mean under 2e-3 and max
    under 0.5 on scores of size 30 (measured 2.5e-4 to 4.7e-4 and 0.08 to
    0.14; the Pallas bodies in interpret mode in place of the XLA fallbacks
    give the same numbers). The quantisation itself costs far more: the
    W8A8 scores are 0.03 from the float32 model's on average."""
    jcfg, tcfg = small_sup(jax_sup_config()), small_sup(sup_v50_config())
    params = jax_tx_params(seed)
    qp = jax.tree_util.tree_map(np.array, quantize_tx_params_w8a8(params))
    sig = _signal(seed)
    ref = np.asarray(tx_forward(qp, jnp.asarray(sig), jcfg))
    full = np.asarray(tx_forward(params, jnp.asarray(sig), jcfg))
    carried = tx_params_from_jax(qp, tcfg)
    out = _scores(carried, sig)
    err = np.abs(out - ref)
    assert err.mean() < 2e-3 and err.max() < 0.5
    assert err.mean() < 0.1 * np.abs(ref - full).mean()
    # quantising the carried float model here gives the carried quantised model
    own = quantize_tx_w8a8(tx_params_from_jax(params, tcfg))
    for a, b in zip(own.layers, carried.layers):
        assert not hasattr(a, "wqkv") and not hasattr(a, "fc1") and not hasattr(a, "fc2")
        for name in ("wqkv", "fc1_y", "fc1_g", "fc2"):
            assert getattr(a, name + "_q").dtype == torch.int8
            assert torch.equal(getattr(a, name + "_q"), getattr(b, name + "_q"))
            np.testing.assert_allclose(
                getattr(a, name + "_s").numpy(), getattr(b, name + "_s").numpy(), rtol=1e-7, atol=0
            )
    np.testing.assert_allclose(_scores(own, sig), out, rtol=0, atol=1e-3)
    # quantising twice changes nothing
    assert torch.equal(quantize_tx_w8a8(own).layers[0].fc2_q, own.layers[0].fc2_q)


def test_frozen_scales_survive_a_narrower_dtype():
    """``freeze_constants`` keeps the weight scales in float32 when the
    module is cast to bf16 (which rounds the scale buffers)."""
    cfg = small_sup(sup_v50_config())
    model = quantize_tx_w8a8(init_tx_params(cfg, torch.Generator().manual_seed(1)))
    want = model.layers[0].fc2_s.clone()
    model.freeze_constants()
    model.to(torch.bfloat16)
    assert model.layers[0].fc2_s.dtype == torch.bfloat16
    assert model.layers[0].fc2_q.dtype == torch.int8
    frozen = model._frozen_scales[0]["fc2"]
    assert frozen.dtype == torch.float32 and torch.equal(frozen, want)


def test_init_and_score_dtype():
    cfg = small_sup(sup_v50_config())
    a = init_tx_params(cfg, torch.Generator().manual_seed(7))
    b = init_tx_params(cfg, torch.Generator().manual_seed(7))
    assert isinstance(a, TxModel)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert tuple(a.layers[0].wqkv.shape) == (192, 64) and tuple(a.crf_w.shape) == (4096, 64)
    assert tuple(a.upsample_w.shape) == (128, 64)
    sig = torch.from_numpy(_signal(0))
    with torch.inference_mode():
        f32, bf16 = a(sig), a(sig, score_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and f32.shape == (CHUNK // 6, 3, 4096)
    assert torch.equal(bf16, f32.bfloat16())
    with pytest.raises(ValueError, match="transformer"):
        from dorado_tpu_torch.models.presets import hac_v43_config

        TxModel(hac_v43_config())


# ---------------------------------------------------------------------------
# attention and norm routes, int8
# ---------------------------------------------------------------------------

JAX_QUANTISE = {"float": None, "w8a8": quantize_tx_params_w8a8, "int8": quantize_tx_params}


@functools.lru_cache(maxsize=None)
def _jax_reference(precision, seed=3):
    """(JAX parameters of ``precision`` as numpy, the signal, tx_forward's
    scores on them, tx_forward's float32 scores), with biases and norm
    weights drawn from the seed."""
    params = with_drawn_biases(jax_tx_params(seed), seed)
    sig = _signal(seed)
    jcfg = small_sup(jax_sup_config())
    full = np.asarray(tx_forward(params, jnp.asarray(sig), jcfg))
    if JAX_QUANTISE[precision] is None:
        return params, sig, full, full
    qp = jax.tree_util.tree_map(np.array, JAX_QUANTISE[precision](params))
    return qp, sig, np.asarray(tx_forward(qp, jnp.asarray(sig), jcfg)), full


@pytest.mark.parametrize(
    "precision,attention,fused_norm",
    list(itertools.product(("float", "w8a8", "int8"), ATTENTION_ROUTES, (False, True))),
)
def test_routes_match_jax(precision, attention, fused_norm):
    """Each attention route with and without the fused norms, at each
    precision, carried from the JAX parameters, against ``tx_forward``.
    Float32: 2e-4 absolute, as above. Quantised: the tolerance of the W8A8
    test above (the int8 path rounds three activations per token too: the
    inputs of wqkv, fc1 and fc2), and far inside the quantisation's own
    error. On the CPU every route gives the same scores as the default.
    Biases and norm weights are drawn from the seed (``with_drawn_biases``),
    so a route that dropped or misplaced one would fail."""
    params, sig, ref, full = _jax_reference(precision)
    carried = tx_params_from_jax(params, small_sup(sup_v50_config()))
    assert carried.precision == precision
    model = with_routes(carried, attention, fused_norm)
    assert (model.attention, model.fused_norm) == (attention, fused_norm)
    out = _scores(model, sig)
    if precision == "float":
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)
        return
    err = np.abs(out - ref)
    assert err.mean() < 2e-3 and err.max() < 0.5
    assert err.mean() < 0.1 * np.abs(ref - full).mean()


@pytest.mark.parametrize("seed", [3, 4])
def test_int8_scores_match_jax(seed):
    """``quantize_tx_int8`` on the carried float model holds the weights
    that ``tx_params_from_jax`` carries from ``quantize_tx_params``, and its
    scores match ``tx_forward``'s on those (the tolerance of the W8A8 test
    above; measured mean 1.5e-4 and 1.5e-3, max 0.05 and 0.12 on the two
    seeds, against a quantisation error of 0.028 on average)."""
    tcfg = small_sup(sup_v50_config())
    params, sig, ref, full = _jax_reference("int8", seed)
    carried = tx_params_from_jax(params, tcfg)
    float_params = with_drawn_biases(jax_tx_params(seed), seed)
    own = quantize_tx_int8(tx_params_from_jax(float_params, tcfg))
    assert own.precision == carried.precision == "int8"
    for a, b in zip(own.layers, carried.layers):
        assert not hasattr(a, "wqkv") and not hasattr(a, "fc1_y_q")
        for name in ("wqkv", "fc1", "fc2"):
            assert getattr(a, name + "_q").dtype == torch.int8
            assert torch.equal(getattr(a, name + "_q"), getattr(b, name + "_q"))
            np.testing.assert_allclose(
                getattr(a, name + "_s").numpy(), getattr(b, name + "_s").numpy(), rtol=1e-7, atol=0
            )
    out = _scores(own, sig)
    err = np.abs(out - ref)
    assert err.mean() < 2e-3 and err.max() < 0.5
    assert err.mean() < 0.1 * np.abs(ref - full).mean()
    # quantising twice changes nothing; the two schemes do not mix
    assert torch.equal(quantize_tx_int8(own).layers[0].fc2_q, own.layers[0].fc2_q)
    with pytest.raises(ValueError, match="holds int8 weights"):
        quantize_tx_w8a8(own)
    with pytest.raises(ValueError, match="holds w8a8 weights"):
        quantize_tx_int8(quantize_tx_w8a8(tx_params_from_jax(float_params, tcfg)))


@pytest.mark.parametrize("precision", ["float", "w8a8", "int8"])
def test_halfperm_route_permutes_wqkv_rows_once(precision):
    """``with_routes(..., "hp")`` permutes the rows of wqkv (and of its int8
    weights and scales, which commutes with quantising them), and back."""
    cfg = small_sup(sup_v50_config())
    model = init_tx_params(cfg, torch.Generator().manual_seed(2))
    quantise = {"float": lambda m: m, "w8a8": quantize_tx_w8a8, "int8": quantize_tx_int8}[precision]
    natural = quantise(model)
    hp = with_routes(natural, "hp", True)
    rows = torch.from_numpy(wqkv_halfperm_rows(cfg.tx.tx.nhead, cfg.tx.tx.d_model))
    names = ("wqkv",) if precision == "float" else ("wqkv_q", "wqkv_s")
    for a, b in zip(natural.layers, hp.layers):
        for name in names:
            assert torch.equal(getattr(b, name), getattr(a, name)[rows])
    if precision != "float":
        assert torch.equal(quantise(with_routes(model, "hp")).layers[1].wqkv_q, hp.layers[1].wqkv_q)
    back = with_routes(hp, "ext")
    assert back.attention == "ext" and back.fused_norm
    for a, b in zip(natural.layers, back.layers):
        assert all(torch.equal(getattr(a, name), getattr(b, name)) for name in names)
    # in place, as the runner moves its private copy
    inplace = copy.deepcopy(natural)
    assert set_routes(inplace, "hp", True) is inplace and inplace.attention == "hp"
    for a, b in zip(hp.layers, inplace.layers):
        assert all(torch.equal(getattr(a, name), getattr(b, name)) for name in names)
    with pytest.raises(ValueError, match="unknown attention route"):
        with_routes(natural, "flash")
    with pytest.raises(ValueError, match="unknown attention route"):
        set_routes(natural, "qkv_rope")
    assert (natural.attention, natural.fused_norm) == ("extf", False)
    assert (TxModel(cfg).attention, TxModel(cfg).fused_norm) == ("extf", False)
