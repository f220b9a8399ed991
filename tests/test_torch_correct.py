"""Read correction in the port (``dorado_tpu_torch.correct``) against the
JAX package's (``dorado_tpu.correct``) on the CPU, on seeded reads of a
random genome (8% errors, both strands): the overlap records, windows and
window features exactly, ``decode_window`` exactly, the correction model's
logits within TOL_LOGITS on weights carried across (argmax equal), the
vote and NN consensus of ``ReadCorrector`` equal, and ``TorchScriptScorer``
on a scripted module with HERRO's contract. At a small width: dim 32,
depth 2, 4 heads, windows of 384 bases."""

import jax
import numpy as np
import pytest
import torch

from dorado_tpu.correct import corrector as jax_corrector
from dorado_tpu.correct import features as jax_features
from dorado_tpu.correct import nn_model as jax_nn
from dorado_tpu.correct import windows as jax_windows
from dorado_tpu_torch.correct import corrector, features, nn_model, windows
from dorado_tpu_torch.utils.torchscript import script_and_save
from tests.torch_correct import HerroContract, correct_reads

TOL_LOGITS = 1e-5  # the logits' largest difference, float32 on both sides
WINDOW = 384
CFG = dict(dim=32, depth=2, heads=4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reads():
    return [(n, s) for n, s, _ in correct_reads(11, 5000, 16, (1500, 2500))]


@pytest.fixture(scope="module")
def records(reads):
    """The port's overlap records, held equal to the JAX package's."""
    got = corrector.ReadCorrector(threads=2).compute_overlap_records(reads)
    want = jax_corrector.ReadCorrector().compute_overlap_records(reads)
    assert got == want and len(got) > 50
    return got


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's model on the same weights)."""
    params = jax_nn.init_correction_model(jax.random.PRNGKey(0),
                                          jax_nn.CorrectionModelConfig(**CFG))
    model = nn_model.CorrectionModel(nn_model.CorrectionModelConfig(**CFG))
    model.load_state_dict(nn_model.correction_state_dict(jax.tree.map(np.asarray, params)))
    return params, model.eval()


def _targets(reads, records, n):
    """Each of the first ``n`` reads: (name, sequence, its overlaps)."""
    ovl = corrector.ReadCorrector().overlaps_from_records(reads, records)
    return [(name, seq, ovl[name]) for name, seq in reads[:n]]


def _window_features(reads, records, n):
    """(port, JAX) WindowFeatures of every supported window of the first
    ``n`` reads, the windows and their pieces held equal on the way."""
    out = []
    for _, target, ovl in _targets(reads, records, n):
        tqual = np.full(len(target), corrector.NN_QUAL, np.float32)
        alns = [dict(seq=r.seq, qual=np.full(len(r.seq), corrector.NN_QUAL, np.float32),
                     cigar=r.cigar, tstart=r.ref_start, fwd=not r.is_reverse, qname=f"aln{i}")
                for i, r in enumerate(ovl)]
        got = windows.extract_windows(target, [windows._Aln(**a) for a in alns], WINDOW)
        want = jax_windows.extract_windows(target, [jax_windows._Aln(**a) for a in alns],
                                           WINDOW)
        assert len(got) == len(want)
        for (gs, gl, gp), (ws, wl, wp) in zip(got, want):
            assert (gs, gl, len(gp)) == (ws, wl, len(wp))
            for a, b in zip(gp, wp):
                assert (a.seq, a.cigar, a.tstart, a.fwd) == (b.seq, b.cigar, b.tstart, b.fwd)
                np.testing.assert_array_equal(a.qual, b.qual)
            if len(gp) < 2:
                continue
            out.append((features.get_features_for_window(target, tqual, gp, gs, gl),
                        jax_features.get_features_for_window(target, tqual, wp, ws, wl)))
    return out


def test_windows_and_features_exact(reads, records):
    pairs = _window_features(reads, records, 3)
    assert len(pairs) >= 10
    for got, want in pairs:
        np.testing.assert_array_equal(got.bases, want.bases)
        np.testing.assert_array_equal(got.quals, want.quals)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert got.supported == want.supported
        assert (got.n_alns, got.win_tstart) == (want.n_alns, want.win_tstart)
    assert sum(len(got.supported) for got, _ in pairs) > 20


def test_decode_window_exact(reads, records):
    rng = np.random.RandomState(3)
    for got, want in _window_features(reads, records, 2):
        assert features.decode_window(got) == jax_features.decode_window(want)
        # and with predictions at the supported positions, deletions among them
        bases = "".join(rng.choice(list("ACGT*"), len(got.supported)))
        got.inferred_bases = want.inferred_bases = bases
        assert features.decode_window(got) == jax_features.decode_window(want)


def test_state_dict_covers_the_model(weights):
    params, model = weights
    assert set(nn_model.correction_state_dict(jax.tree.map(np.asarray, params))) == set(
        model.state_dict())


def test_model_logits_and_predictions(reads, records, weights):
    params, model = weights
    pairs = _window_features(reads, records, 2)
    cpu = torch.device("cpu")
    for got, _ in pairs:
        logits = nn_model.window_logits(model, got, cpu).numpy()
        want = np.asarray(jax_nn.correction_forward(params, got.bases[None], got.quals[None],
                                                    CFG["heads"]))[0]
        assert logits.shape == want.shape == (got.bases.shape[1], 5)
        assert np.abs(logits - want).max() <= TOL_LOGITS
        np.testing.assert_array_equal(logits.argmax(-1), want.argmax(-1))
        assert nn_model.predict_supported(model, got, cpu) == jax_nn.predict_supported(
            params, got, CFG["heads"])


def test_rope_rotates_halves_over_the_window():
    """The rotary embedding at position 0 is the identity, and the port's
    equals the JAX package's on a window-long input."""
    x = np.random.RandomState(0).randn(1, 700, 4, 8).astype(np.float32)
    got = nn_model._rope(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_nn._rope(x)), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(got[:, 0], x[:, 0])


@pytest.mark.parametrize("use_nn", [False, True], ids=["vote", "nn"])
def test_read_corrector_equal(reads, records, weights, use_nn):
    params, model = weights
    targets = {name for name, _ in reads[:4]}
    port = corrector.ReadCorrector(use_nn=use_nn, nn_model=model, window_size=WINDOW,
                                   device="cpu")
    ref = jax_corrector.ReadCorrector(use_nn=use_nn, nn_params=params, window_size=WINDOW)
    got = port.correct(reads, targets=targets, overlap_records=records)
    want = ref.correct(reads, targets=targets, overlap_records=records)
    assert got == want and len(got) == 4
    assert [name for name, seq in got if seq != dict(reads)[name]]
    assert (port.stats.reads_corrected, port.stats.overlaps) == (
        ref.stats.reads_corrected, ref.stats.overlaps)
    assert port.stats.windows > 0 if use_nn else port.stats.windows == 0


def test_nn_path_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        corrector.ReadCorrector(use_nn=True)
    # the vote path touches no device
    assert corrector.ReadCorrector().device is None


def test_torchscript_scorer(reads, records, weights, tmp_path):
    """A scripted HERRO-contract module around the carried model: the
    scorer's bases equal the model's and the JAX package's scorer's on the
    same file."""
    params, model = weights
    path = tmp_path / "herro.pt"
    script_and_save(HerroContract(model), path)
    scorer = nn_model.TorchScriptScorer(str(path), "cpu")
    ref = jax_nn.TorchScriptScorer(str(path))
    for got, _ in _window_features(reads, records, 1):
        bases = scorer.predict(got)
        assert bases == nn_model.predict_supported(model, got, torch.device("cpu"))
        assert bases == ref.predict(got) and len(bases) == len(got.supported)
    port = corrector.ReadCorrector(nn_scorer=scorer, window_size=WINDOW)
    want = jax_corrector.ReadCorrector(nn_scorer=ref, window_size=WINDOW)
    targets = {reads[0][0]}
    assert port.correct(reads, targets, records) == want.correct(reads, targets, records)
