"""The port's modified-base calling (``dorado_tpu_torch.modbase``) against the
JAX package's (``dorado_tpu.modbase``) on the same inputs: the written
config files, motif hits, kmer encoding, the kmer-level rescale, chunk
windows, score indices, the alphabet and its offsets, the v1, v2 and v3
forwards at small widths, the weight files, ``call_read``, ``call_reads``,
the cross-read scheduler under threads, and the MM/ML/MN tags.

Inputs are made from seeds with numpy. The models run in float32 on both
sides; their forwards differ only in the order of float32 sums (measured
6e-8), held at 1e-5. The callers' uint8 probabilities are floor(p * 256),
so such a difference could move one across a step: held equal at 99.9% of
positions and never more than 1 apart (measured: equal everywhere)."""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from dorado_tpu.modbase import caller as jax_caller
from dorado_tpu.modbase import encode as jax_encode
from dorado_tpu.modbase import model as jax_model
from dorado_tpu.modbase import scaler as jax_scaler
from dorado_tpu.modbase import tags as jax_tags
from dorado_tpu.modbase.config import load_modbase_config as jax_load_config
from dorado_tpu.modbase.motif import MotifMatcher as JaxMotifMatcher
from dorado_tpu_torch.modbase import caller, encode, scaler, tags
from dorado_tpu_torch.modbase.config import (
    ModBaseModelType,
    load_modbase_config,
    validate_modbase_compat,
)
from dorado_tpu_torch.modbase.model import (
    ModBaseConvLSTM,
    init_modbase_params,
    load_modbase_params,
    modbase_params_from_jax,
    save_modbase_model,
    stride_ratio,
)
from dorado_tpu_torch.modbase.motif import MotifMatcher
from dorado_tpu_torch.models.presets import (
    hac_5mcg_5hmcg_v3_config,
    modbase_config_toml,
    small_conv_lstm_v3_config,
)

NARROW = 32  # the v2 model's width in the tests (published: 256)


def write_config(cfg, root):
    d = root / cfg.model_path.name
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.toml").write_text(modbase_config_toml(cfg))
    return d


def _configs(kind):
    if kind == "v3":
        return small_conv_lstm_v3_config()
    cfg = hac_5mcg_5hmcg_v3_config(NARROW)
    if kind == "v1":
        cfg = dataclasses.replace(cfg, model_type=ModBaseModelType.CONV_LSTM_V1)
    return cfg


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A narrow 5mCG_5hmCG@v3 model directory (random weights from a seed,
    random kmer levels: the rescale runs) that both packages load."""
    cfg = hac_5mcg_5hmcg_v3_config(NARROW)
    levels = np.random.RandomState(5).randn(4**cfg.kmer_len).astype(np.float32)
    model = init_modbase_params(cfg, torch.Generator().manual_seed(3))
    return save_modbase_model(cfg, model, tmp_path_factory.mktemp("mb") / cfg.model_path.name,
                              refine_levels=levels)


def make_reads(n, rs, lengths=(40, 400)):
    """(sequence, moves at stride 6, signal) triples: every base one move
    over twice as many output steps, white-noise signal."""
    reads = []
    for _ in range(n):
        ln = int(rs.randint(*lengths))
        seq = "".join(rs.choice(list("ACGT"), ln))
        t_out = 2 * ln
        moves = np.zeros(t_out, dtype=np.uint8)
        moves[0] = 1
        moves[np.sort(rs.choice(np.arange(1, t_out), ln - 1, replace=False))] = 1
        reads.append((seq, moves, rs.randn(6 * t_out).astype(np.float32)))
    return reads


@pytest.fixture(scope="module")
def callers(model_dir):
    """The JAX caller and the port's (on the CPU) on the same directory."""
    jc = jax_caller.ModBaseCaller([jax_load_config(model_dir)], canonical_stride=6,
                                  batch_size=16)
    tc = caller.ModBaseCaller([load_modbase_config(model_dir)], canonical_stride=6,
                              batch_size=16, device="cpu")
    return jc, tc


def assert_probs_close(a: np.ndarray, b: np.ndarray, counts: list) -> None:
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max(initial=0) <= 1
    counts[0] += int((diff > 0).sum())
    counts[1] += diff.size


@pytest.mark.parametrize("kind", ["v2", "v3"])
def test_written_configs_parse_as_in_jax(tmp_path, kind):
    cfg = _configs(kind)
    d = write_config(cfg, tmp_path)
    ours, theirs = load_modbase_config(d), jax_load_config(d)
    assert dataclasses.replace(ours, model_path=cfg.model_path) == cfg
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    assert a.pop("model_type").value == b.pop("model_type").value == cfg.model_type.value
    assert a == b
    assert ours.context.normalised(5) == dataclasses.replace(
        ours.context, **dataclasses.asdict(theirs.context.normalised(5)))
    assert stride_ratio(ours) == jax_model.stride_ratio(theirs) == (6 if kind == "v3" else 1)
    assert (ours.num_states, ours.is_chunked_input_model) == (theirs.num_states, True)
    validate_modbase_compat(ours, 6)
    with pytest.raises(ValueError, match="incompatible"):
        validate_modbase_compat(ours, 5)


def test_published_config_geometry():
    cfg = hac_5mcg_5hmcg_v3_config()
    assert (cfg.size, cfg.kmer_len, cfg.num_out, cfg.stride) == (256, 9, 3, 6)
    assert (cfg.mods.motif, cfg.mods.base, cfg.mods.codes) == ("CG", "C", ["h", "m"])
    ctx = cfg.context
    assert (ctx.chunk_size, ctx.samples_before, ctx.samples_after, ctx.kmer_len) == (192, 96,
                                                                                    96, 9)
    assert cfg.refine.do_rough_rescale and cfg.refine.center_idx == 6


@pytest.mark.parametrize("motif,offset", [("CG", 0), ("DRACH", 2), ("AA", 0), ("A", 0),
                                          ("GATC", 1)])
def test_motif_hits_match_jax(motif, offset):
    rs = np.random.RandomState(len(motif) + offset)
    for _ in range(5):
        seq = "".join(rs.choice(list("ACGT"), 300))
        hits = MotifMatcher(motif, offset).get_motif_hits(seq)
        assert hits == JaxMotifMatcher(motif, offset).get_motif_hits(seq)
    assert MotifMatcher("AA", 0).get_motif_hits("AAAA") == [0, 1, 2]


def test_encoding_matches_jax():
    rs = np.random.RandomState(1)
    for seq, moves, signal in make_reads(4, rs):
        ints = encode.sequence_to_ints(seq)
        np.testing.assert_array_equal(ints, jax_encode.sequence_to_ints(seq))
        s2s = encode.moves_to_map(moves, 6, len(signal))
        np.testing.assert_array_equal(s2s, jax_encode.moves_to_map(moves, 6, len(signal)))
        np.testing.assert_array_equal(encode.reverse_seq_to_sig_map(s2s, len(signal)),
                                      jax_encode.reverse_seq_to_sig_map(s2s, len(signal)))
        for kmer_len, centered, ssr in ((9, True, 1), (3, False, 1), (9, True, 6)):
            got = encode.encode_kmer_chunk(ints, s2s // ssr, kmer_len, len(signal) // ssr,
                                           centered)
            want = jax_encode.encode_kmer_chunk(ints, s2s // ssr, kmer_len,
                                                len(signal) // ssr, centered)
            assert got.dtype == np.int8 and got.shape == (len(signal) // ssr, 4 * kmer_len)
            np.testing.assert_array_equal(got, want)


def test_scaler_matches_jax():
    rs = np.random.RandomState(2)
    levels = rs.randn(4**5).astype(np.float32)
    ours, theirs = scaler.ModBaseScaler(levels, 5, 2), jax_scaler.ModBaseScaler(levels, 5, 2)
    for seq, moves, signal in make_reads(3, rs, (60, 1200)):
        ints = encode.sequence_to_ints(seq)
        s2s = encode.moves_to_map(moves, 6, len(signal))
        np.testing.assert_array_equal(ours.extract_levels(ints), theirs.extract_levels(ints))
        lv = ours.extract_levels(ints)
        assert ours.calc_offset_scale(signal, s2s, lv) == theirs.calc_offset_scale(
            signal, s2s, lv)
        np.testing.assert_array_equal(ours.scale_signal(signal, ints, s2s),
                                      theirs.scale_signal(signal, ints, s2s))
    kmers = rs.randint(0, 4, (7, 5))
    np.testing.assert_array_equal(scaler.index_from_int_kmer(kmers, 5),
                                  jax_scaler.index_from_int_kmer(kmers, 5))
    with pytest.raises(ValueError):
        scaler.ModBaseScaler(levels[:-1], 5, 2)


def test_chunk_starts_and_score_index_match_jax():
    rs = np.random.RandomState(3)
    for _ in range(20):
        sig_len = int(rs.randint(200, 5000))
        hits = np.sort(rs.choice(sig_len // 6, int(rs.randint(1, 30)), replace=False)) * 6
        for before, after, size in ((96, 96, 192), (150, 150, 300), (48, 24, 96)):
            got = caller.get_chunk_starts(sig_len, hits, size, before, after)
            assert got == jax_caller.get_chunk_starts(sig_len, hits, size, before, after)
            for start, _ in got:
                for h in hits[hits >= start]:
                    args = (int(h), start, 3, size, before, after, 6)
                    assert caller.resolve_score_index(*args) == jax_caller.resolve_score_index(
                        *args)
    with pytest.raises(ValueError, match="before chunk start"):
        caller.resolve_score_index(5, 10, 3, 192, 96, 96, 6)


def test_info_and_offsets_match_jax(tmp_path):
    cfgs = [hac_5mcg_5hmcg_v3_config(NARROW), small_conv_lstm_v3_config()]
    dirs = [write_config(c, tmp_path) for c in cfgs]
    ours = caller.get_modbase_info([load_modbase_config(d) for d in dirs])
    theirs = jax_caller.get_modbase_info([jax_load_config(d) for d in dirs])
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.alphabet == ["A", "a", "C", "h", "m", "G", "T"] and ours.context == "_:XG:_:_"
    assert caller.base_prob_offsets(ours) == jax_caller.base_prob_offsets(theirs) == [0, 2, 5, 6]


@pytest.mark.parametrize("kind", ["v1", "v2", "v3"])
def test_forward_matches_jax(tmp_path, kind):
    """The model on the JAX weights against ``modbase_forward`` (float32
    both, 1e-5: only the order of the sums differs; measured 6e-8)."""
    cfg = jax_load_config(write_config(_configs(kind), tmp_path))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_model.init_modbase_params(cfg, jax.random.PRNGKey(1)))
    rs = np.random.RandomState(4)
    size, ssr = cfg.context.chunk_size, jax_model.stride_ratio(cfg)
    sigs = rs.randn(5, size).astype(np.float32)
    seqs = (rs.rand(5, size // ssr, 4 * cfg.kmer_len) < 0.3).astype(np.int8)
    want = np.asarray(jax_model.modbase_forward(params, sigs, seqs, cfg))
    model = modbase_params_from_jax(params, load_modbase_config(cfg.model_path))
    with torch.inference_mode():
        got = model(torch.from_numpy(sigs), torch.from_numpy(seqs)).numpy()
    assert got.shape == want.shape == ((5, cfg.num_out) if kind == "v1"
                                       else (5, size // cfg.stride * cfg.num_out))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_weight_files_round_trip_with_jax(model_dir, tmp_path):
    """The port's files load in the JAX package to the port's weights, and
    the JAX package's files load in the port to the JAX weights."""
    cfg = load_modbase_config(model_dir)
    model = load_modbase_params(cfg)
    theirs = jax_model.load_modbase_params(jax_load_config(model_dir))
    back = modbase_params_from_jax(theirs, cfg)
    for (name, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), name
    jcfg = jax_load_config(model_dir)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_model.init_modbase_params(jcfg, jax.random.PRNGKey(2)))
    jax_model.save_modbase_params(jcfg, params, tmp_path)
    loaded = load_modbase_params(dataclasses.replace(cfg, model_path=tmp_path))
    for (name, a), (_, b) in zip(loaded.named_parameters(),
                                 modbase_params_from_jax(params, cfg).named_parameters()):
        assert torch.equal(a, b), name
    assert isinstance(loaded, ModBaseConvLSTM)


def test_call_read_matches_jax(callers):
    jc, tc = callers
    assert tc.scalers[0] is not None and jc.scalers[0] is not None
    counts = [0, 0]
    hits = 0
    for read in make_reads(6, np.random.RandomState(6)):
        want, got = jc.call_read(*read), tc.call_read(*read)
        np.testing.assert_array_equal(got.motif_hits, want.motif_hits)
        assert got.base_mod_probs.dtype == np.uint8
        assert_probs_close(got.base_mod_probs, want.base_mod_probs, counts)
        hits += int(got.motif_hits.sum())
    assert hits > 20 and counts[0] <= 1e-3 * counts[1]
    np.testing.assert_array_equal(tc.init_canonical_probs(encode.sequence_to_ints("ACGTTA")),
                                  jc.init_canonical_probs(encode.sequence_to_ints("ACGTTA")))


def test_call_read_rna_matches_jax(model_dir):
    """``is_rna``: the signal reversed (a stride's remainder moved to its
    front) and the move map mirrored, as in the JAX caller."""
    jc = jax_caller.ModBaseCaller([jax_load_config(model_dir)], canonical_stride=6,
                                  is_rna=True, batch_size=16)
    tc = caller.ModBaseCaller([load_modbase_config(model_dir)], canonical_stride=6,
                              is_rna=True, batch_size=16, device="cpu")
    counts = [0, 0]
    for seq, moves, signal in make_reads(3, np.random.RandomState(11)):
        for sig in (signal, signal[:-4]):  # a whole number of strides, and not
            want, got = jc.call_read(seq, moves, sig), tc.call_read(seq, moves, sig)
            np.testing.assert_array_equal(got.motif_hits, want.motif_hits)
            assert_probs_close(got.base_mod_probs, want.base_mod_probs, counts)
    assert counts[0] <= 1e-3 * counts[1]


def test_call_reads_batches_across_reads(callers):
    """Chunks batched across reads give each read's own results, as in the
    JAX caller, whose batches hold other rows (padded to ``batch_size``)."""
    jc, tc = callers
    reads = make_reads(7, np.random.RandomState(7))
    solo = [tc.call_read(*r) for r in reads]
    batched = tc.call_reads([tc.prepare_read(*r) for r in reads])
    assert sum(tc.prepare_read(*r).num_chunks for r in reads) > tc.batch_size
    want = jc.call_reads([jc.prepare_read(*r) for r in reads])
    counts = [0, 0]
    for a, b, c in zip(solo, batched, want):
        np.testing.assert_array_equal(a.base_mod_probs, b.base_mod_probs)
        np.testing.assert_array_equal(a.motif_hits, b.motif_hits)
        assert_probs_close(b.base_mod_probs, c.base_mod_probs, counts)
    assert counts[0] <= 1e-3 * counts[1]


def test_scheduler_under_threads(callers):
    """More finisher threads than cores submit reads, with the interpreter
    switching threads often: every read gets its own result, and the
    scheduler's thread ends on close."""
    _, tc = callers
    reads = make_reads(12, np.random.RandomState(8))
    solo = [tc.call_read(*r) for r in reads]
    sched = caller.ModBaseBatchScheduler(tc, timeout_s=0.05)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=2 * (os.cpu_count() or 4)) as pool:
            futures = [pool.submit(lambda r=r: sched.call(tc.prepare_read(*r))) for r in reads]
            results = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
        sched.close()
    assert not sched._runner.is_alive()
    for a, b in zip(solo, results):
        np.testing.assert_array_equal(a.base_mod_probs, b.base_mod_probs)
    with pytest.raises(RuntimeError, match="closed"):
        sched.call(tc.prepare_read(*reads[0]))


@pytest.mark.parametrize("threshold", [0.0, 0.05, 0.5, 1.0])
def test_tags_match_jax(callers, threshold):
    """MN, MM and ML equal to the JAX package's on the same probabilities:
    a motif context (CG), and with a single-base model beside it, a cardinal
    base without context, whose sites the threshold picks."""
    jc, tc = callers
    t8 = tags.modbase_threshold_uint8(threshold)
    assert t8 == jax_tags.modbase_threshold_uint8(threshold)
    rs = np.random.RandomState(9)
    infos = [tc.info, caller.get_modbase_info([tc.configs[0], small_conv_lstm_v3_config()])]
    for info in infos:
        for seq, _, _ in make_reads(3, rs, (20, 120)):
            probs = rs.randint(0, 256, len(seq) * info.num_states).astype(np.uint8)
            hits = np.zeros(len(seq), dtype=bool)
            hits[MotifMatcher("CG", 0).get_motif_hits(seq)] = True
            for mask in (hits, None):
                got = tags.generate_modbase_tags(seq, probs, info, mask, t8)
                want = jax_tags.generate_modbase_tags(seq, probs, info, mask, t8)
                assert got[0] == want[0] and got[2] == want[2] == len(seq)
                assert got[1].dtype == np.uint8
                np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="size mismatch"):
        tags.generate_modbase_tags("ACG", np.zeros(4, np.uint8), tc.info, None, t8)
