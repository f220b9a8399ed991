"""The port's variant models against the JAX package's forwards on the CPU,
on the JAX ``init_*`` weights carried across by the state-dict functions:
``SlotAttentionConsensus`` (with and without ``add_lstm``, with the mapq,
haplotag, dwell and snp_qv columns, phased and not) and ``VariantPerceiver``
(with and without ``use_decoder_lstm`` and ``update_read_embeddings``),
within 1e-5 absolute with NaN in the same places (a column no read covers
makes the slot model's 0/0); the factory, the presets and the seeded
inits."""

import jax
import numpy as np
import pytest
import torch

from dorado_tpu.secondary import architectures as jax_arch
from dorado_tpu_torch.models import presets
from dorado_tpu_torch.ops import lstm
from dorado_tpu_torch.secondary import architectures

TOL = 1e-5
NARROW = dict(read_embedding_size=16, cnn_size=12, kernel_sizes=(1, 5))
PERCEIVER = dict(NARROW, dimension=32, num_blocks=3, num_heads=4)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def read_features(seed: int, b: int, p: int, d: int, gap=None) -> np.ndarray:
    """[b, p, d, 7] read-matrix features (base 0-5, qual, strand, mapq,
    dwell, haplotag, snp_qv) with the last two reads empty and, at the
    columns ``gap``, no read at all."""
    rng = np.random.RandomState(seed)
    x = np.zeros((b, p, d, 7), np.float32)
    x[..., 0] = rng.randint(0, 6, (b, p, d))
    x[..., 1] = rng.randint(0, 50, (b, p, d))
    x[..., 2] = rng.choice([-1, 1], (b, p, d))
    x[..., 3] = rng.randint(0, 60, (b, p, d))
    x[..., 4] = rng.rand(b, p, d)
    x[..., 5] = rng.randint(0, 3, (b, p, d))
    x[..., 6] = rng.randint(0, 40, (b, p, d))
    x[:, :, -2:] = 0
    if gap is not None:
        x[:, gap] = 0
    return x


def assert_close_nan(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    assert np.abs(got[finite] - want[finite]).max(initial=0.0) <= TOL


SLOT_CASES = {
    "plain": {},
    "lstm": dict(add_lstm=True),
    "mapq_haplotags_lstm": dict(use_mapqc=True, use_haplotags=True, add_lstm=True),
    "dwells_snp_qv": dict(use_dwells=True, use_snp_qv=True),
}


def slot_models(case: str, seed: int = 1):
    cfg = jax_arch.SlotAttentionConfig(**NARROW, **SLOT_CASES[case])
    params = jax.tree.map(np.asarray, jax_arch.init_slot_attention_consensus(
        jax.random.PRNGKey(seed), cfg))
    m = architectures.SlotAttentionConsensus(
        architectures.SlotAttentionConfig(**NARROW, **SLOT_CASES[case]))
    m.load_state_dict(architectures.slot_attention_consensus_state_dict(params))
    return cfg, params, m.eval()


@pytest.mark.parametrize("phase", [True, False], ids=["phased", "unphased"])
@pytest.mark.parametrize("gap", [None, [20, 21]], ids=["covered", "uncovered_columns"])
@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_slot_attention_consensus_matches_jax(case, gap, phase):
    cfg, params, m = slot_models(case)
    x = read_features(3, 2, 48, 9, gap=gap)
    if phase:
        want = np.asarray(jax_arch.slot_attention_consensus_forward(params, x, cfg))
    else:
        want = np.asarray(jax_arch.slot_attention_consensus_forward_impl(params, x, cfg)[0])
    with torch.inference_mode():
        got = m(torch.from_numpy(x), phase=phase).numpy()
    assert_close_nan(got, want)
    if gap is None:
        assert not np.isnan(want).any()
    else:
        # 0/0 at the uncovered columns, which the LSTMs carry along the window
        assert np.isnan(want[:, gap]).all()
        assert np.isnan(want).all() == cfg.add_lstm


def test_slot_attention_weights_match_jax():
    """The attention map that ``forward_impl`` returns beside the
    probabilities, and the block's slots, against JAX's."""
    cfg, params, m = slot_models("mapq_haplotags_lstm", seed=4)
    x = read_features(5, 1, 30, 6, gap=[7])
    want_p, want_a = jax_arch.slot_attention_consensus_forward_impl(params, x, cfg)
    with torch.inference_mode():
        got_p, got_a = m.forward_impl(torch.from_numpy(x))
    assert_close_nan(got_a.numpy(), np.asarray(want_a))
    assert_close_nan(got_p.numpy(), np.asarray(want_p))


PERCEIVER_CASES = {
    "plain": {},
    "decoder_lstm": dict(use_decoder_lstm=True),
    "update_reads": dict(update_read_embeddings=True),
    "all": dict(use_decoder_lstm=True, update_read_embeddings=True, use_haplotags=True,
                use_mapqc=True, use_dwells=True, use_snp_qv=True),
}


@pytest.mark.parametrize("case", list(PERCEIVER_CASES))
def test_variant_perceiver_matches_jax(case):
    kw = dict(PERCEIVER, **PERCEIVER_CASES[case])
    cfg = jax_arch.VariantPerceiverConfig(**kw)
    params = jax.tree.map(np.asarray, jax_arch.init_variant_perceiver(jax.random.PRNGKey(2), cfg))
    m = architectures.VariantPerceiver(architectures.VariantPerceiverConfig(**kw))
    m.load_state_dict(architectures.variant_perceiver_state_dict(params))
    assert (m.blocks[0].haplotypes_to_reads is not None) == cfg.update_read_embeddings
    assert m.blocks[-1].haplotypes_to_reads is None
    x = read_features(4, 2, 40, 7, gap=[10])
    want = np.asarray(jax_arch.variant_perceiver_forward(params, x, cfg))
    launches = lstm.lstm_scan_time_major_f32.launches
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert lstm.lstm_scan_time_major_f32.launches == launches  # the CPU: the plain version
    assert not np.isnan(want).any()
    assert_close_nan(got, want)


def test_rope_and_building_blocks_match_jax():
    rng = np.random.RandomState(6)
    q, k = (rng.randn(2, 37, 3, 4, 8).astype(np.float32) for _ in range(2))
    wq, wk = jax_arch._rope_pair(q, k)
    gq, gk = architectures._rope_pair(torch.from_numpy(q), torch.from_numpy(k))
    assert_close_nan(gq.numpy(), np.asarray(wq))
    assert_close_nan(gk.numpy(), np.asarray(wk))
    x = rng.randn(5, 16).astype(np.float32) * 3 + 1
    g, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    assert_close_nan(architectures.layer_norm(*map(torch.from_numpy, (x, g, b))).numpy(),
                     np.asarray(jax_arch.layer_norm({"g": g, "b": b}, x)))
    assert_close_nan(architectures.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                     np.asarray(jax_arch.rms_norm({"w": g}, x)))
    gru = jax.tree.map(np.asarray, jax_arch.init_gru_cell(jax.random.PRNGKey(1), 16, 16))
    cell = torch.nn.GRUCell(16, 16)
    cell.load_state_dict({a: torch.tensor(gru[b_]) for a, b_ in (
        ("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"), ("bias_hh", "b_hh"))})
    h = rng.randn(5, 16).astype(np.float32)
    with torch.no_grad():
        got = architectures.gru_cell(cell, torch.from_numpy(x), torch.from_numpy(h)).numpy()
        torch_cell = cell(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    assert_close_nan(got, np.asarray(jax_arch.gru_cell(gru, x, h)))
    assert np.abs(got - torch_cell).max() <= TOL  # torch's GRUCell gate order
    sw = jax.tree.map(np.asarray, jax_arch.init_swiglu(jax.random.PRNGKey(2), 16, 16))
    mod = architectures.SwiGLU(16, 16)
    mod.load_state_dict({"fc1.weight": torch.tensor(sw["fc1"]["w"]),
                         "fc2.weight": torch.tensor(sw["fc2"]["w"])})
    with torch.no_grad():
        assert_close_nan(mod(torch.from_numpy(x)).numpy(), np.asarray(jax_arch.swiglu(sw, x)))


@pytest.mark.parametrize("name", ["slot", "perceiver"])
def test_factory_presets_and_inits(name):
    """``model_factory`` builds each type from its preset's kwargs, weights
    drawn from the generator with the JAX distributions; the state dict of
    the JAX factory's weights has the same keys and shapes; a config
    without its kwargs raises KeyError, as the JAX factory does."""
    if name == "slot":
        cfg = presets.slot_attention_config(16, 12, (1, 5), add_lstm=True)
        carry = architectures.slot_attention_consensus_state_dict
    else:
        cfg = presets.variant_perceiver_config(32, 2, 4, 16, 12, (1, 5), use_decoder_lstm=True,
                                               update_read_embeddings=True)
        carry = architectures.variant_perceiver_state_dict
    model_type, kwargs = cfg["model"]["type"], cfg["model"]["kwargs"]
    assert cfg["feature_encoder"]["kwargs"]["include_haplotype"] == "true"
    m = architectures.model_factory(model_type, kwargs, torch.Generator().manual_seed(3))
    again = architectures.model_factory(model_type, kwargs, torch.Generator().manual_seed(3))
    params = jax.tree.map(np.asarray, jax_arch.model_factory(model_type, kwargs)[0])
    state = carry(params)
    mine = m.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in mine.items()}
    for key, value in mine.items():
        assert torch.equal(value, again.state_dict()[key])
        if key.endswith("fixed_noise"):  # the same constant in both packages
            np.testing.assert_array_equal(value.numpy(), state[key].numpy())
        elif key.endswith(("embedder.weight", "latent_init")):
            assert abs(float(value.std()) - 1.0) < 0.35
        elif key.endswith((".running_var", "norm.weight", "norm1.weight", "norm2.weight")):
            assert torch.all(value == 1.0)
    x = torch.from_numpy(read_features(7, 1, 25, 5))
    with torch.inference_mode():
        out = m(x)
    assert out.shape == (1, 25, 2, 5) and torch.isfinite(out).all()
    with pytest.raises(KeyError):
        jax_arch.model_factory(model_type, {})
    with pytest.raises(KeyError):
        architectures.model_factory(model_type, {})
    with pytest.raises(ValueError, match="Unknown model type"):
        architectures.model_factory("Transformer", kwargs)
