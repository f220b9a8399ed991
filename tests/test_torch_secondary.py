"""The port's polish features and models (``dorado_tpu_torch.secondary``)
against ``dorado_tpu.secondary`` on the same seeded inputs: pileups, read
matrices, dwells, snp_qv and haplotags exactly; GRUModel and
LatentSpaceLSTM logits within 1e-5 of ``gru_forward`` and
``latent_space_lstm_forward`` with the JAX weights carried across; the
primitives, the factory, the config parser and model resolution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.secondary import architectures as jax_arch
from dorado_tpu.secondary import features as jax_features
from dorado_tpu.secondary import model as jax_model
from dorado_tpu.secondary import model_resolver as jax_resolver
from dorado_tpu.secondary import pileup as jax_pileup
from dorado_tpu.secondary import read_matrix as jax_read_matrix
from dorado_tpu_torch.alignment import Mapper, ReferenceIndex
from dorado_tpu_torch.models import presets
from dorado_tpu_torch.ops import lstm
from dorado_tpu_torch.secondary import (
    architectures, features, model, model_resolver, pileup, read_matrix,
)
from dorado_tpu_torch.utils.torchscript import script_and_save
from tests.torch_polish import polish_inputs, revcomp

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the GRU's and the plain LSTM's many small
    operators crawl at their thread-pool barriers when the test workers
    oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _aligned(seed=21, draft_len=2400, n_reads=14, extras=False):
    """(draft, AlignedReads) of seeded reads mapped by the port's mapper,
    with hand-made reads for the CIGAR ops the mapper does not write (=, X,
    N, H, an insertion at the window's edge, a read before the draft)."""
    draft, _, reads = polish_inputs(seed, draft_len, n_reads, (300, 1200), error=0.1)
    mapper = Mapper(ReferenceIndex.build([("ctg", draft)]))
    rng = np.random.RandomState(seed)
    out = []
    for name, seq, qual in reads:
        for a in mapper.map(seq):
            s = revcomp(seq) if a.is_reverse else seq
            q = np.frombuffer(qual.encode(), np.uint8).astype(np.int16) - 33
            out.append(pileup.AlignedRead(
                a.ref_start, a.cigar, s, a.is_reverse, qual=q[::-1].copy() if a.is_reverse
                else q, mapq=a.mapq, qname=name))
    out += [
        pileup.AlignedRead(100, "5=2X3I10=4N6=2H", draft[100:107] + "GGG" + draft[107:117]
                           + draft[121:127], False, mapq=7),
        pileup.AlignedRead(995, "5M3I5M", draft[995:1000] + "TTA" + draft[1000:1005], True),
        pileup.AlignedRead(0, "4S6M2D5M", "NNNN" + draft[:6] + draft[8:13], False),
        pileup.AlignedRead(len(draft) - 10, "10M", draft[-10:], True, qual=np.arange(10)),
    ]
    if extras:
        for i, r in enumerate(out):
            r.haplotag = int(rng.randint(0, 3))
            r.nm = int(rng.randint(0, 40)) if i % 3 else None
            if i % 4:
                n = len(r.seq)
                mv = np.zeros(3 * n + 5, np.int64)
                mv[0] = 5
                mv[1 + np.sort(rng.choice(np.arange(1, 3 * n + 4), n - 1, replace=False))] = 1
                mv[1] = 1
                r.moves = mv
    return draft, out


@pytest.mark.parametrize("start, end, normalise", [(0, 2400, True), (0, 2400, False),
                                                   (990, 1700, True), (2300, 2600, False)])
def test_pileup_equals_jax(start, end, normalise):
    _, reads = _aligned()
    ours = pileup.build_pileup(reads, start, end, normalise)
    theirs = jax_pileup.build_pileup(reads, start, end, normalise)
    for name in ("counts", "positions_major", "positions_minor", "depth"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ours.positions_minor.max() > 0


@pytest.mark.parametrize("kw", [
    {},
    {"include_dwells": True, "include_haplotags": True, "include_snp_qv": True},
    {"include_haplotags": True, "haplotags": {0: 1, 3: 2, 5: 1}, "max_reads": 5},
    {"include_dwells": True, "include_snp_qv": True, "quals": "given", "mapqs": "given"},
])
def test_read_matrix_equals_jax(kw):
    _, reads = _aligned(extras=True)
    kw = dict(kw)
    if kw.get("quals") == "given":
        kw["quals"] = [np.full(len(r.seq), 9 + i % 5) for i, r in enumerate(reads)]
        kw["mapqs"] = [i % 61 for i in range(len(reads))]
    for start, end in ((0, 2400), (980, 1300)):
        ours = read_matrix.build_read_matrix(reads, start, end, **kw)
        theirs = jax_read_matrix.build_read_matrix(reads, start, end, **kw)
        for name in ("matrix", "positions_major", "positions_minor"):
            a, b = getattr(ours, name), getattr(theirs, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ours.matrix.shape[-1] == 4 + sum(bool(kw.get(k)) for k in (
        "include_dwells", "include_haplotags", "include_snp_qv"))


def test_features_equal_jax():
    _, reads = _aligned(extras=True)
    rng = np.random.RandomState(4)
    for r in reads:
        for rev in (False, True):
            a = features.calculate_dwells(r.moves, len(r.seq), rev)
            b = jax_features.calculate_dwells(r.moves, len(r.seq), rev)
            assert (a is None and b is None) or np.array_equal(a, b)
        assert features.compute_snp_qv(r.cigar, r.nm) == jax_features.compute_snp_qv(
            r.cigar, r.nm)
    # a move table too short and one too long for the read (BAD_ALIGNMENT)
    for mv, n in (([5, 1, 1, 1, 1], 2), ([5, 1, 0, 0, 1], 9)):
        for rev in (False, True):
            a, b = features.calculate_dwells(mv, n, rev), jax_features.calculate_dwells(
                mv, n, rev)
            assert (a is None and b is None) or np.array_equal(a, b)
    for cigar, nm in (("10=2X3I", None), ("20M1D", 4), ("5S", None), ("8M", 0)):
        assert features.compute_snp_qv(cigar, nm) == jax_features.compute_snp_qv(cigar, nm)
    # two haplotypes: reads of a draft with heterozygous SNPs every 37 bases
    draft = "".join(rng.choice(list("ACGT"), 600))
    hap2 = list(draft)
    for p in range(20, 600, 37):
        hap2[p] = "A" if draft[p] != "A" else "C"
    hap2 = "".join(hap2)
    phased = []
    for i in range(16):
        s = rng.randint(0, 300)
        src = draft if i % 2 else hap2
        phased.append(pileup.AlignedRead(s, "250M", src[s:s + 250], bool(i % 3)))
    for start, end in ((0, 600), (100, 300)):
        ours = features.local_haplotags(phased + reads, start, end)
        assert ours == jax_features.local_haplotags(phased + reads, start, end)
    assert set(features.local_haplotags(phased, 0, 600).values()) == {1, 2}


@pytest.mark.parametrize("bidirectional, layers", [(True, 2), (False, 1)])
def test_gru_model_equals_jax(bidirectional, layers):
    params = jax_model.init_gru_params(jax.random.PRNGKey(3), gru_size=16, num_layers=layers,
                                       bidirectional=bidirectional)
    m = model.GRUModel(gru_size=16, n_layers=layers, bidirectional=bidirectional)
    m.load_state_dict(model.gru_state_dict(_np(params)))
    x = np.random.RandomState(0).rand(2, 57, 10).astype(np.float32)
    want = np.asarray(jax.jit(jax_model.gru_forward)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert model.decode_consensus(got) == jax_model.decode_consensus(got)


def _rl_params(cfg, seed):
    """JAX LatentSpaceLSTM params with batch-norm running stats and affine
    weights drawn from the seed (the init's are the identity)."""
    params = _np(jax_arch.init_latent_space_lstm(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    for layer in params["read_level_conv"]["layers"]:
        c = layer["bn"]["g"].shape[0]
        layer["bn"] = {"g": (1 + 0.2 * rng.randn(c)).astype(np.float32),
                       "b": (0.1 * rng.randn(c)).astype(np.float32),
                       "mean": (0.1 * rng.randn(c)).astype(np.float32),
                       "var": (0.5 + rng.rand(c)).astype(np.float32)}
    return params


@pytest.mark.parametrize("use_dwells", [False, True])
def test_latent_space_lstm_equals_jax(use_dwells):
    jcfg = jax_arch.LatentSpaceLSTMConfig(lstm_size=16, cnn_size=12, kernel_sizes=(1, 5),
                                          use_dwells=use_dwells)
    params = _rl_params(jcfg, 5)
    cfg = architectures.LatentSpaceLSTMConfig(lstm_size=16, cnn_size=12, kernel_sizes=(1, 5),
                                              use_dwells=use_dwells)
    m = architectures.LatentSpaceLSTM(cfg)
    m.load_state_dict(architectures.latent_space_lstm_state_dict(params))
    rng = np.random.RandomState(1)
    x = np.zeros((2, 41, 7, 5), np.float32)
    x[..., 0] = rng.randint(0, 6, x.shape[:3])
    x[..., 1] = rng.randint(-1, 50, x.shape[:3])
    x[..., 2] = rng.choice([-1.0, 1.0], x.shape[:3])
    x[..., 3] = rng.randint(0, 61, x.shape[:3])
    x[..., 4] = rng.randint(0, 30, x.shape[:3])
    x[:, :, -2:] = 0  # empty reads
    x[:, 7] = 0  # a column no read covers
    forward = jax.jit(lambda p, v: jax_arch.latent_space_lstm_forward(p, v, jcfg))
    want = np.asarray(forward(params, jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_primitives_equal_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 6, 29).astype(np.float32)
    w, b = rng.randn(8, 6, 5).astype(np.float32), rng.randn(8).astype(np.float32)
    got = architectures.conv1d_same(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    want = jax_arch.conv1d_same({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    g, bb, mu, var = (rng.rand(6).astype(np.float32) + 0.5 for _ in range(4))
    got = architectures.batch_norm1d(*(torch.from_numpy(a) for a in (x, g, bb, mu, var)))
    want = jax_arch.batch_norm1d({"g": g, "b": bb, "mean": mu, "var": var}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    lw, lb = rng.randn(4, 29).astype(np.float32), rng.randn(4).astype(np.float32)
    got = architectures.linear(torch.from_numpy(x), torch.from_numpy(lw), torch.from_numpy(lb))
    want = jax_arch.linear({"w": lw, "b": lb}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    table = rng.randn(6, 3).astype(np.float32)
    idx = rng.randint(0, 6, (4, 5)).astype(np.float32)
    assert np.array_equal(architectures.embedding(torch.from_numpy(table), torch.from_numpy(idx)),
                          np.asarray(jax_arch.embedding({"w": table}, jnp.asarray(idx))))
    feats = rng.randn(2, 7, 3, 4).astype(np.float32)
    np.testing.assert_allclose(
        architectures._scaled_feature(torch.from_numpy(feats), 1).numpy(),
        np.asarray(jax_arch._scaled_feature(jnp.asarray(feats), 1)), atol=TOL, rtol=0)
    h = rng.randn(2, 5, 7, 3).astype(np.float32)
    mask = np.array([[1, 0, 1, 1, 0], [1, 1, 1, 1, 1]], bool)
    np.testing.assert_allclose(
        architectures._mean_pool(torch.from_numpy(h), torch.from_numpy(mask)).numpy(),
        np.asarray(jax_arch._mean_pool(jnp.asarray(h), jnp.asarray(mask))), atol=TOL, rtol=0)


def test_factory_and_config(tmp_path):
    for cfg in (presets.polish_gru_config(16), presets.polish_rl_config(16, 12, (1, 5))):
        d = tmp_path / cfg["model"]["type"]
        d.mkdir()
        (d / "config.toml").write_text(presets.polish_config_toml(cfg))
        ours = architectures.parse_model_config(d / "config.toml")
        assert ours == jax_arch.parse_model_config(d / "config.toml")
        m = architectures.model_factory(ours["model_type"], ours["model_kwargs"])
        assert type(m).__name__ == ours["model_type"]
    rl = architectures.model_factory("LatentSpaceLSTM", {
        "num_classes": 5, "lstm_size": 8, "cnn_size": 8, "kernel_sizes": "1,5",
        "use_dwells": "true", "bidirectional": "true"})
    assert rl.config.kernel_sizes == (1, 5) and rl.config.use_dwells
    assert rl.read_level_conv[0].conv.weight.shape == (8, 8, 1)
    # the variant models: built from their presets' configs as the JAX
    # factory reads them; a config without the model's kwargs raises
    # KeyError in both packages
    for cfg in (presets.slot_attention_config(16, 12, (1, 5), add_lstm=True),
                presets.variant_perceiver_config(32, 2, 4, 16, 12, (1, 5))):
        name = cfg["model"]["type"]
        d = tmp_path / name
        d.mkdir()
        (d / "config.toml").write_text(presets.polish_config_toml(cfg))
        ours = architectures.parse_model_config(d / "config.toml")
        assert ours == jax_arch.parse_model_config(d / "config.toml")
        m = architectures.model_factory(ours["model_type"], ours["model_kwargs"])
        assert type(m).__name__ == name
        for factory in (architectures.model_factory, jax_arch.model_factory):
            with pytest.raises(KeyError):
                factory(name, {})
    with pytest.raises(ValueError, match="Unknown model type"):
        architectures.model_factory("Nope", {})


def test_resolver_equals_jax(tmp_path):
    assert model_resolver.LUT_POLISH == jax_resolver.LUT_POLISH
    assert model_resolver.LUT_LEGACY_POLISH == jax_resolver.LUT_LEGACY_POLISH
    assert model_resolver.BACTERIAL_MODEL == jax_resolver.BACTERIAL_MODEL
    hdr = ("@HD\tVN:1.6\n@RG\tID:x\tDS:runid=1 basecall_model="
           "dna_r10.4.1_e8.2_400bps_sup@v5.0.0\n")
    assert model_resolver.basecaller_model_from_header(hdr) == (
        jax_resolver.basecaller_model_from_header(hdr))
    for bc in (*model_resolver.LUT_POLISH, *model_resolver.LUT_LEGACY_POLISH, "nope"):
        for bacteria in (False, True):
            assert model_resolver.resolve_polish_model_name(bc, bacteria) == (
                jax_resolver.resolve_polish_model_name(bc, bacteria))
    name = "dna_r10.4.1_e8.2_400bps_sup@v5.0.0_polish_rl"
    (tmp_path / name).mkdir()
    assert model_resolver.resolve_model_dir("auto", hdr, models_directory=tmp_path) == (
        tmp_path / name)
    assert model_resolver.resolve_model_dir(name, models_directory=tmp_path) == tmp_path / name
    assert model_resolver.resolve_model_dir(str(tmp_path)) == tmp_path
    with pytest.raises(ValueError, match="no model downloader"):
        model_resolver.resolve_model_dir("dna_r10.4.1_e8.2_400bps_hac@v4.3.0_polish",
                                         models_directory=tmp_path)
    with pytest.raises(ValueError, match="requires a basecall_model"):
        model_resolver.resolve_model_dir("auto", "@HD\tVN:1.6\n", models_directory=tmp_path)
    with pytest.raises(ValueError, match="No polish model is known"):
        model_resolver.resolve_model_dir("auto", hdr.replace("sup@v5.0.0", "x"),
                                         models_directory=tmp_path)


def test_model_directories_load(tmp_path):
    """The GRU's weights.pt, model.pt of a scripted GRUModel and a
    ``.tensor`` directory give back the models that wrote them; the JAX
    loaders read the GRU's weights.pt and ``.tensor`` files to the same
    logits; both packages refuse a LatentSpaceLSTM's weights.pt."""
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 33, 10).astype(np.float32))
    gen = torch.Generator().manual_seed(9)
    gru = model.init_gru_model(gen, gru_size=16)
    gcfg = presets.polish_gru_config(16)
    d = presets.save_polish_model(gcfg, gru, tmp_path / "gru")
    loaded, mc, kind = model_resolver.load_resolved_model(d)
    assert kind == "counts" and torch.equal(loaded(x), gru(x))
    params, fwd, _, jkind = jax_resolver.load_resolved_model(d)
    assert jkind == "counts"
    np.testing.assert_allclose(np.asarray(fwd(params, x.numpy())), gru(x).detach().numpy(),
                               atol=TOL, rtol=0)
    t = presets.save_polish_model(gcfg, gru, tmp_path / "tensors", tensor_files=True)
    assert torch.equal(model.load_gru_tensor_dir(t)(x), gru(x))
    from dorado_tpu.io.tensor_file import load_tensor

    assert np.array_equal(load_tensor(t / "gru.weight_hh_l1_reverse.tensor"),
                          gru.gru.weight_hh_l1_reverse.detach().numpy())
    s = tmp_path / "scripted"
    s.mkdir()
    (s / "config.toml").write_text(presets.polish_config_toml(gcfg))
    script_and_save(gru, s / "model.pt")
    ts, _, kind = model_resolver.load_resolved_model(s)
    assert kind == "counts" and torch.equal(ts(x), gru(x))
    rcfg = presets.polish_rl_config(16, 12, (1, 5))
    rl = architectures.model_factory("LatentSpaceLSTM", rcfg["model"]["kwargs"], gen)
    d = presets.save_polish_model(rcfg, rl, tmp_path / "rl")
    assert architectures.parse_model_config(d / "config.toml")[
        "feature_encoder_kwargs"]["max_reads"] == 100
    for loader in (model_resolver.load_resolved_model, jax_resolver.load_resolved_model):
        with pytest.raises(ValueError, match="implemented for GRUModel; LatentSpaceLSTM"):
            loader(d)
    back = architectures.model_factory("LatentSpaceLSTM", rcfg["model"]["kwargs"])
    back.load_state_dict(torch.load(d / "weights.pt"))
    xr = torch.from_numpy(np.random.RandomState(4).randint(0, 5, (1, 21, 6, 4)).astype(
        np.float32))
    xr[..., 2] = xr[..., 2] % 3 - 1  # strands -1, 0, 1
    assert torch.equal(back.eval()(xr), rl(xr))
    with pytest.raises(ValueError, match="neither model.pt nor weights.pt"):
        (d / "weights.pt").unlink()
        model_resolver.load_resolved_model(d)


def test_k1_float32_plan_at_one_row():
    """The polish LSTM's shape on K1 float32 (H = 128, N = 1): one cluster
    of one row, and the resident (not the wide) form."""
    assert not lstm.k1_needs_wide(128, elem_bytes=4)
    for active in (1, 16, 132):
        plan = lstm.k1_plan(128, 1, active, elem_bytes=4)
        assert plan.clusters == 1 and plan.rows >= 1
        assert plan.cluster * plan.units == 128
