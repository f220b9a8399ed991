"""The port's duplex calling (``dorado_tpu_torch.duplex``) on the CPU against
the JAX package's (``dorado_tpu.duplex``) on the same numpy-seeded inputs:
the stereo features (equal), ``check_pair`` through each of its branches and
the streaming pairer (the same verdicts and ranges), the move realignment and
the duplex modified-base probabilities (equal) and tags (equal), the
basespace consensus (equal), the stereo model's call of a forced pair and
``DuplexPipeline.run`` with pairs forced in both packages, each with the
Viterbi and the beam decoder: sequences and moves equal, qstrings within a
step at under 1% of positions (``tests/test_torch_runner.py``'s rule), every
other tag equal but ``qs`` (within 1%).

Two cases hold where the port does not copy the JAX pipeline: a run that
ends on a partial simplex batch (the JAX run writes none of its reads; the
port writes every read), and a ``min_qscore`` that filters a read (the JAX
run raises; the port writes the reads that pass)."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dorado_tpu.duplex.pipeline as jax_duplex_pipeline
from dorado_tpu.config import load_model_config as jax_load_config
from dorado_tpu.duplex import basespace as jax_basespace
from dorado_tpu.duplex import modbase as jax_dmod
from dorado_tpu.duplex import pairing as jax_pairing
from dorado_tpu.duplex import stereo as jax_stereo
from dorado_tpu.io import pod5 as jax_pod5
from dorado_tpu.modbase import tags as jax_tags
from dorado_tpu.modbase.caller import ModBaseCaller as JaxModBaseCaller
from dorado_tpu.modbase.config import load_modbase_config as jax_load_modbase_config
from dorado_tpu.models.crf_model import init_lstm_crf_params as jax_init
from dorado_tpu.models.crf_model import lstm_crf_forward
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu_torch.config import load_model_config
from dorado_tpu_torch.duplex import basespace, pairing, stereo
from dorado_tpu_torch.duplex import modbase as dmod
from dorado_tpu_torch.duplex.pipeline import DuplexPipeline
from dorado_tpu_torch.io import pod5
from dorado_tpu_torch.modbase import tags
from dorado_tpu_torch.modbase.caller import ModBaseCaller
from dorado_tpu_torch.modbase.config import load_modbase_config
from dorado_tpu_torch.modbase.model import init_modbase_params, save_modbase_model
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import (
    config_toml,
    hac_5mcg_5hmcg_v3_config,
    hac_v43_config,
    stereo_config,
)
from dorado_tpu_torch.signal.chunk import generate_chunks
from dorado_tpu_torch.utils.align import align
from dorado_tpu_torch.utils.sequence import reverse_complement
from tests.test_torch_runner import _narrow_hac, assert_qstrings_close, jax_params_with_moves
from tests.torch_duplex import ForcedPairer, duplex_read_layout

CHUNK = 1200
BATCH = 8
STRIDE = 6  # hac's


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: many small operators, whose thread-pool barriers
    crawl when the test workers oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _seq(rs, n):
    return "".join(rs.choice(list("ACGT"), n))


def _mutate(rs, seq, rate=0.03):
    """``seq`` with substitutions, deletions and insertions at ``rate`` each."""
    out = []
    for b in seq:
        r = rs.rand()
        if r < rate:
            out.append(rs.choice(list("ACGT")))
        elif r < 2 * rate:
            continue
        elif r < 3 * rate:
            out += [b, rs.choice(list("ACGT"))]
        else:
            out.append(b)
    return "".join(out)


def _strand(rs, seq, stride=STRIDE):
    """(qstring, moves, signal) of a call of ``seq``: one move per base over
    three times as many blocks, white-noise signal a few samples past the
    last block."""
    n = len(seq)
    t_out = 3 * n
    moves = np.zeros(t_out, dtype=np.uint8)
    moves[0] = 1
    moves[np.sort(rs.choice(np.arange(1, t_out), n - 1, replace=False))] = 1
    signal = rs.randn(t_out * stride + int(rs.randint(0, stride))).astype(np.float32)
    qstring = "".join(chr(33 + int(q)) for q in rs.randint(1, 41, n))
    return qstring, moves, signal


# ---- stereo features ----------------------------------------------------------


@pytest.mark.parametrize("seed,t_start,c_start", [(0, 0, 0), (1, 7, 0), (2, 0, 11), (3, 5, 9),
                                                  (4, 0, 0)])
def test_stereo_features_match_jax(seed, t_start, c_start):
    """Equal to the JAX features on a template and a mutated complement,
    also with the pair starting past either call's first base."""
    rs = np.random.RandomState(seed)
    tseq = _seq(rs, 150 + 40 * seed)
    cseq = reverse_complement(_mutate(rs, tseq))  # the complement call, its own orientation
    tq, tm, ts = _strand(rs, tseq)
    cq, cm, cs = _strand(rs, cseq)
    rc = reverse_complement(cseq)
    kw = dict(
        alignment=align(tseq[t_start:], rc[c_start:]).ops, template_seq=tseq,
        template_qstring=tq, template_moves=tm, template_signal=ts, complement_seq=rc,
        complement_qstring=cq, complement_moves=cm, complement_signal=np.ascontiguousarray(cs[::-1]),
        signal_stride=STRIDE, template_seq_start=t_start, complement_seq_start=c_start,
    )
    got = stereo.generate_stereo_features(stereo.StereoFeatureInputs(**kw))
    want = jax_stereo.generate_stereo_features(jax_stereo.StereoFeatureInputs(**kw))
    assert got.dtype == np.float32 and got.shape[0] == stereo.NUM_FEATURES == 13
    assert got.shape[1] >= STRIDE * (len(tseq) - t_start)
    np.testing.assert_array_equal(got, want)
    # the signal rows' pad and the qscore scaling
    assert (got[:2] == np.float32(0.8 * min(float(ts.min()), float(cs.min())))).any()
    assert 0.0 < got[stereo.F_TEMPLATE_Q].max() <= 40 / 90 + 1e-6


# ---- pairing ----------------------------------------------------------------


def _candidates(read_id, start_ms, duration_ms, seq, q=20, channel=1, mux=1):
    """The same candidate read in both packages."""
    kw = dict(read_id=read_id, channel=channel, mux=mux, start_time_ms=start_ms,
              duration_ms=duration_ms, seq=seq, qstring=chr(33 + q) * len(seq),
              moves=np.zeros(3 * len(seq), np.uint8), signal=np.zeros(0, np.float32))
    return jax_pairing.CandidateRead(**kw), pairing.CandidateRead(**kw)


def _verdict(result):
    if result is None:
        return None
    return (result.template.read_id, result.complement.read_id, result.template_seq_start,
            result.template_seq_end, result.complement_seq_start, result.complement_seq_end)


def _pair_cases():
    rs = np.random.RandomState(11)
    s1000, s6000 = _seq(rs, 1000), _seq(rs, 6000)
    rc1000 = reverse_complement(_mutate(rs, s1000, 0.02))
    return {
        # (template, complement, use_alignment, accepted)
        "empty call": (("t", 0, 1000, ""), ("c", 1050, 1000, s1000), True, False),
        "complement before template's end": (("t", 0, 1000, s1000), ("c", 900, 1000, rc1000),
                                             True, False),
        "gap of 10 s": (("t", 0, 1000, s1000), ("c", 11000, 1000, rc1000), True, False),
        "499 bases": (("t", 0, 1000, s1000[:499]), ("c", 1050, 1000, rc1000), True, False),
        "qscore 7": (("t", 0, 1000, s1000, 7), ("c", 1050, 1000, rc1000), True, False),
        "early accept": (("t", 0, 1000, s6000), ("c", 1050, 1000, s6000[:5950]), True, True),
        "early accept without alignment": (("t", 0, 1000, s6000), ("c", 1100, 1000, s6000),
                                           False, True),
        "length ratio under 0.2": (("t", 0, 1000, s6000), ("c", 1200, 1000, rc1000), True,
                                   False),
        "no alignment check": (("t", 0, 1000, s1000), ("c", 1200, 1000, rc1000), False, False),
        "alignment accept": (("t", 0, 1000, s1000), ("c", 1200, 1000, rc1000), True, True),
        "alignment reject": (("t", 0, 1000, s1000), ("c", 1200, 1000, _seq(rs, 1000)), True,
                             False),
    }


@pytest.mark.parametrize("case", list(_pair_cases()))
def test_check_pair_matches_jax(case):
    temp, comp, use_alignment, accepted = _pair_cases()[case]
    jt, pt = _candidates(*temp)
    jc, pc = _candidates(*comp)
    want = _verdict(jax_pairing.check_pair(jt, jc, use_alignment))
    got = _verdict(pairing.check_pair(pt, pc, use_alignment))
    assert got == want
    assert (got is not None) == accepted
    if accepted:
        assert got == ("t", "c", 0, len(temp[3]) - 1, 0, len(comp[3]) - 1)


def test_pairer_stream_matches_jax():
    """Both pairers over one stream on two channels and muxes: the same pairs
    at the same pushes; a paired read pairs no further."""
    rs = np.random.RandomState(12)
    seqs = [_seq(rs, 6000) for _ in range(3)]
    stream = [
        ("a", 0, 1000, seqs[0], 20, 1, 1), ("x", 500, 1000, seqs[1], 20, 2, 1),
        ("b", 1050, 1000, seqs[0], 20, 1, 1), ("c", 2100, 1000, seqs[0], 20, 1, 1),
        ("y", 1550, 1000, seqs[1], 20, 2, 1), ("z", 1600, 1000, seqs[1], 20, 2, 2),
        ("d", 3150, 1000, seqs[0], 20, 1, 1), ("e", 99000, 1000, seqs[2], 20, 1, 1),
    ]
    jp, pp = jax_pairing.DuplexPairer(), pairing.DuplexPairer()
    got, want = [], []
    for entry in stream:
        jr, pr = _candidates(*entry)
        want.append(_verdict(jp.push(jr)))
        got.append(_verdict(pp.push(pr)))
    assert got == want
    assert [v[:2] for v in got if v] == [("a", "b"), ("x", "y"), ("c", "d")]
    assert pp.pairs_found == jp.pairs_found == 3


# ---- duplex modified bases ----------------------------------------------------


@pytest.mark.parametrize("case", ["identity", "edits", "shifted", "unrelated", "no moves"])
def test_realign_moves_matches_jax(case):
    rs = np.random.RandomState(["identity", "edits", "shifted", "unrelated",
                                "no moves"].index(case))
    seq = _seq(rs, 300)
    _, moves, _ = _strand(rs, seq)
    target = {"identity": seq, "edits": _mutate(rs, seq), "shifted": _mutate(rs, seq[40:260]),
              "unrelated": _seq(rs, 250), "no moves": seq}[case]
    if case == "no moves":
        moves = np.zeros_like(moves)
    got = dmod.realign_moves(seq, target, moves)
    want = jax_dmod.realign_moves(seq, target, moves)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    if case == "identity":
        assert got[:2] == (0, 0)
        np.testing.assert_array_equal(got[2], moves)
    elif case == "no moves":
        assert got[0] == -1


@pytest.fixture(scope="module")
def mod_dir(tmp_path_factory):
    """A narrow 5mCG_5hmCG@v3 modbase model directory (width 32, random
    weights and kmer levels from seeds) that both packages load."""
    cfg = hac_5mcg_5hmcg_v3_config(32)
    levels = np.random.RandomState(5).randn(4**cfg.kmer_len).astype(np.float32)
    model = init_modbase_params(cfg, torch.Generator().manual_seed(3))
    return save_modbase_model(cfg, model, tmp_path_factory.mktemp("mod") / cfg.model_path.name,
                              refine_levels=levels)


@pytest.fixture(scope="module")
def callers(mod_dir):
    return (JaxModBaseCaller([jax_load_modbase_config(mod_dir)], canonical_stride=STRIDE,
                             batch_size=16),
            ModBaseCaller([load_modbase_config(mod_dir)], canonical_stride=STRIDE,
                          batch_size=16, device="cpu"))


def _duplex_strands(seed):
    """A duplex call and its two strands' calls (the complement in its own
    orientation), each with moves and signal, rich in CG sites."""
    rs = np.random.RandomState(seed)
    tseq = "".join(rs.choice(["CG", "A", "C", "G", "T"], 250))
    duplex = _mutate(rs, tseq, 0.01)
    cseq = reverse_complement(_mutate(rs, tseq, 0.02))
    _, tm, ts = _strand(rs, tseq)
    _, cm, cs = _strand(rs, cseq)
    return duplex, (tseq, tm, ts, cseq, cm, cs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_call_duplex_mods_matches_jax(callers, seed):
    """Both strands realigned onto the duplex call and run through one
    ``call_reads``: the probabilities equal the JAX caller's, and so do the
    duplex MM/ML/MN with both strands' channels."""
    jax_caller, caller = callers
    duplex, strands = _duplex_strands(seed)
    want = jax_dmod.call_duplex_mods(jax_caller, duplex, STRIDE, *strands)
    got = dmod.call_duplex_mods(caller, duplex, STRIDE, *strands)
    assert got.dtype == np.uint8 and got.shape == (len(duplex) * caller.info.num_states,)
    np.testing.assert_array_equal(got, want)
    threshold = tags.modbase_threshold_uint8(0.05)
    mm, ml, mn = tags.generate_modbase_tags(duplex, got, caller.info, None, threshold,
                                            is_duplex=True)
    jmm, jml, jmn = jax_tags.generate_modbase_tags(duplex, want, jax_caller.info, None,
                                                   threshold, is_duplex=True)
    assert (mm, mn) == (jmm, jmn) and mn == len(duplex)
    np.testing.assert_array_equal(ml, jml)
    assert "C+h?" in mm and "G-h?" in mm and "G-m?" in mm
    assert len(ml) == sum(len(part.split(",")) - 1 for part in mm.split(";")) > 0


@pytest.mark.parametrize("threshold", [0, 12, 200])
def test_duplex_tags_match_jax(callers, threshold):
    """The duplex MM/ML/MN on random probabilities equal the JAX package's,
    a simplex read's tags are the '+' channels alone, and ``motif_hits`` do
    not change a duplex read's tags."""
    jax_caller, caller = callers
    rs = np.random.RandomState(threshold)
    seq = "".join(rs.choice(["CG", "A", "C", "G", "T"], 300))
    probs = rs.randint(0, 256, len(seq) * caller.info.num_states).astype(np.uint8)
    hits = rs.rand(len(seq)) < 0.2
    got = tags.generate_modbase_tags(seq, probs, caller.info, hits, threshold, is_duplex=True)
    want = jax_tags.generate_modbase_tags(seq, probs, jax_caller.info, None, threshold,
                                          is_duplex=True)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    simplex = tags.generate_modbase_tags(seq, probs, caller.info, None, threshold)
    assert got[0].startswith(simplex[0]) and "-" not in simplex[0]


# ---- basespace ------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 300), (1, 700), (2, 1200), (3, 40), (4, 600)])
def test_basespace_matches_jax(seed, n):
    """Template and mutated complement calls (seed 3: a pair too short to
    overlap confidently; seed 4: unrelated calls): the consensus and its
    qstring equal the JAX package's, or both decline."""
    rs = np.random.RandomState(seed)
    tseq = _seq(rs, n)
    cseq = _seq(rs, n) if seed == 4 else reverse_complement(_mutate(rs, tseq))
    tq = "".join(chr(33 + int(q)) for q in rs.randint(2, 41, len(tseq)))
    cq = "".join(chr(33 + int(q)) for q in rs.randint(2, 41, len(cseq)))
    got = basespace.basespace_duplex_call(tseq, tq, cseq, cq)
    assert got == jax_basespace.basespace_duplex_call(tseq, tq, cseq, cq)
    if seed < 3:
        assert got is not None and len(got[0]) == len(got[1]) > 0.8 * n
    assert basespace.basespace_duplex_call("", "", cseq, cq) is None


# ---- the stereo model and its preset ----------------------------------------------


def _narrow_stereo(cfg):
    cfg.lstm_size = 32
    cfg.convs[2].size = 32
    return cfg


PRE_V4_TOML = """\
[model]
package = "bonito.crf"

[labels]
labels = ["N", "A", "C", "G", "T"]

[input]
features = 13

[encoder]
scale = 5.0
stride = 5
rnn_type = "lstm"
features = {features}
winlen = 19
activation = "swish"
blank_score = 2.0
first_conv_size = 16

[global_norm]
state_len = 3

[qscore]
bias = 0.0
scale = 1.0

[run_info]
sample_rate = 5000
sample_type = "dna"

[basecaller]
chunksize = 10000
overlap = 500
"""


def _stereo_dir(root, cfg, text=None):
    d = root / cfg.model_name
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.toml").write_text(text or config_toml(cfg))
    return d


@pytest.mark.parametrize("form", ["config_toml", "hand-written pre-v4"])
def test_stereo_config_loads_to_the_preset(tmp_path, form):
    """``config_toml`` writes the stereo preset in the pre-v4 layout, and a
    hand-written pre-v4 ``config.toml`` of the same model loads to it too,
    in both packages (but for the start of the mean qscore, which a
    ``[qscore]`` table sets to 60)."""
    from tests.test_torch_load import _plain

    cfg = stereo_config()
    d = _stereo_dir(tmp_path, cfg, None if form == "config_toml"
                    else PRE_V4_TOML.format(features=cfg.lstm_size))
    ours, theirs = load_model_config(d), jax_load_config(d)
    assert _plain(ours) == _plain(theirs)
    want = _plain(cfg)
    want["mean_qscore_start_pos"] = 60
    assert _plain(ours) == want
    assert "[encoder]\nstride = 5\nfeatures = 384\nfirst_conv_size = 16" in config_toml(cfg)


def test_config_toml_refuses_a_pre_v4_head_on_another_stack():
    cfg = stereo_config()
    cfg.lstm_layers = 4
    with pytest.raises(ValueError, match="pre-v4"):
        config_toml(cfg)


def _jax_stereo_params(jcfg, seed=1, gain=12.0):
    """Random stereo weights whose CRF head is scaled up (so the Viterbi path
    emits bases) and whose head bias is drawn (the init leaves it 0)."""
    params = jax.tree_util.tree_map(np.array, jax_init(jcfg, jax.random.PRNGKey(seed)))
    params["linear1"]["w"] *= gain
    params["linear1"]["b"] = np.random.RandomState(seed).randn(jcfg.outsize).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def stereo_models(tmp_path_factory):
    """The narrow stereo model (LSTM width 32) in both packages, loaded from
    one directory: (JAX config, JAX params, config, model)."""
    d = _stereo_dir(tmp_path_factory.mktemp("stereo"), _narrow_stereo(stereo_config()))
    jcfg, cfg = jax_load_config(d), load_model_config(d)
    params = _jax_stereo_params(jcfg)
    return jcfg, params, cfg, params_from_jax(params, cfg)


def test_stereo_model_forward_matches_jax(stereo_models):
    """``params_from_jax`` carries the stereo model, its head's bias among
    its weights: the port's forward on [N, T, 13] features equals the JAX
    forward within ``tests/test_torch_model.py``'s 1e-4."""
    jcfg, params, cfg, model = stereo_models
    assert model.pre_v4 and model.linear1_b is not None
    np.testing.assert_array_equal(model.linear1_b.detach().numpy(), params["linear1"]["b"])
    feats = np.random.RandomState(5).randn(3, 5 * 40, 13).astype(np.float32)
    ref = np.asarray(lstm_crf_forward(params, jnp.asarray(feats), jcfg))
    with torch.no_grad():
        out = model(torch.from_numpy(feats))
    assert out.shape == (40, 3, 4**4)
    np.testing.assert_allclose(out.numpy().transpose(1, 0, 2), ref, rtol=0, atol=1e-4)
    assert np.abs(ref).max() <= 5.0


# ---- the stereo call and the pipeline -------------------------------------------


class _Collect:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


def _chunks(n_samples):
    """Simplex chunks of a read (hac's constant trim of 10 samples first)."""
    return len(generate_chunks(n_samples - 10, CHUNK, STRIDE, 498))


def _lengths(seed, pairs, fill=True):
    """Read lengths for ``pairs`` pairs and one lone read, each read at
    least one full chunk long (all chunks in the long lane), padded with
    lone one-chunk reads to whole batches (``fill``); without ``fill`` one
    more read of 890 samples goes to the short lane, whose batch never fills."""
    rs = np.random.RandomState(seed)
    lengths = [int(n) for n in rs.randint(1500, 4001, 2 * pairs + 1)]
    while sum(_chunks(n) for n in lengths) % BATCH:
        lengths.append(CHUNK + 10)
    return lengths if fill else lengths + [890]


def _reads(module, lengths, pairs, seed=9):
    """White-noise reads (``tests/test_torch_pipeline.py``'s signal) on the
    layout of ``duplex_read_layout``, in channel order."""
    rs = np.random.RandomState(seed)
    run_info = module.RunInfo(
        acquisition_id="acq0", sample_rate=5000, flow_cell_id="FAB00000",
        flow_cell_product_code="FLO-PRO114M", protocol_run_id="run0",
        acquisition_start_time_ms=1_700_000_000_000, sample_id="sample0",
    )
    reads = []
    for i, (n, (channel, well, start)) in enumerate(
            zip(lengths, duplex_read_layout(rs, lengths, pairs))):
        signal = np.clip(rs.normal(460, 113, n), -32768, 32767).astype(np.int16)
        reads.append(module.Pod5Read(
            read_id=f"read-{i}", signal=signal, read_number=i, start_sample=start,
            median_before=200.0, channel=channel, well=well, pore_type="not_set",
            calibration_offset=0.0, calibration_scale=0.2, end_reason="signal_positive",
            end_reason_forced=False, open_pore_level=float("nan"),
            num_reads_since_mux_change=0, time_since_mux_change=0.0,
            num_minknow_events=10 * i, tracked_scaling_scale=float("nan"),
            tracked_scaling_shift=float("nan"), predicted_scaling_scale=float("nan"),
            predicted_scaling_shift=float("nan"), run_info=run_info,
        ))
    return sorted(reads, key=lambda r: (r.channel, r.start_sample))


def _pipelines(stereo_models, decoder, **kw):
    """(JAX DuplexPipeline, the port's) on the narrow hac and stereo models,
    float32, each with a ``ForcedPairer``."""
    jcfg, sparams, cfg, smodel = stereo_models
    params = jax_params_with_moves(2)
    common = dict(chunk_size=CHUNK, batch_size=BATCH, decoder=decoder)
    jp = jax_duplex_pipeline.DuplexPipeline(
        _narrow_hac(jax_hac_config()), params, dataclasses.replace(jcfg), sparams,
        compute_dtype=jnp.float32, **common, **kw.pop("jax", {}))
    tcfg = _narrow_hac(hac_v43_config())
    tp = DuplexPipeline(tcfg, params_from_jax(params, tcfg), dataclasses.replace(cfg), smodel,
                        device="cpu", **common, **kw)
    jp.pairer = ForcedPairer(jax_pairing.PairingResult)
    tp.pairer = ForcedPairer(pairing.PairingResult)
    return jp, tp


def _jax_run(jp, reads):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_duplex_pipeline, "find_pod5_files", lambda *a, **k: [Path("unused")])
    mp.setattr(jax_duplex_pipeline, "iter_reads", lambda files, by_channel: iter(reads))
    jp.stats = type(jp.stats)()  # the JAX run adds to the pipeline's counts
    try:
        out = _Collect()
        stats = jp.run("unused", out)
    finally:
        mp.undo()
    return out.records, stats


def _assert_records_match(ref, out, min_positions=200):
    """Each record of ``ref`` has its namesake in ``out``: sequences equal,
    qstrings within a step at under 1% of positions, tags equal but ``qs``
    (within 1%) and ``mv`` (equal arrays)."""
    by_name = {r.qname: r for r in out}
    counts = [0, 0]
    for a in ref:
        b = by_name[a.qname]
        assert b.seq == a.seq, a.qname
        assert_qstrings_close(b.qual, a.qual, counts)
        assert [t.tag for t in b.tags] == [t.tag for t in a.tags]
        for ta, tb in zip(a.tags, b.tags):
            if ta.tag == "qs":
                assert float(tb.value) == pytest.approx(float(ta.value), rel=1e-2)
            elif ta.tag in ("mv", "ML"):
                np.testing.assert_array_equal(tb.value, ta.value)
            else:
                assert (tb.type, tb.value) == (ta.type, ta.value), (a.qname, ta.tag)
    assert counts[1] > min_positions
    assert counts[0] <= 0.01 * counts[1]


@pytest.fixture(scope="module")
def viterbi_pipelines(stereo_models):
    return _pipelines(stereo_models, "viterbi")


@pytest.fixture(scope="module", params=["viterbi", "beam"])
def pipelines(request, stereo_models, viterbi_pipelines):
    if request.param == "viterbi":
        return request.param, viterbi_pipelines
    return request.param, _pipelines(stereo_models, request.param)


def _fresh_pairers(jp, tp):
    jp.pairer = ForcedPairer(jax_pairing.PairingResult)
    tp.pairer = ForcedPairer(pairing.PairingResult)


def test_call_stereo_matches_jax(pipelines):
    """A forced pair of planted calls, as the JAX package's own test builds
    it: the duplex record and the stereo runners' calls of its feature
    chunks match the JAX pipeline's (sequences and moves equal)."""
    decoder, (jp, tp) = pipelines
    rs = np.random.RandomState(0)
    n_bases = 300
    seq = _seq(rs, n_bases)
    strands = []
    for read_id, s in (("t", seq), ("c", reverse_complement(_mutate(rs, seq)))):
        q, moves, signal = _strand(rs, s)
        strands.append(dict(read_id=read_id, channel=1, mux=1, start_time_ms=0,
                            duration_ms=100, seq=s, qstring=q, moves=moves, signal=signal))
    ranges = (0, len(strands[0]["seq"]) - 1, 0, len(strands[1]["seq"]) - 1)
    want = jp._call_stereo(jax_pairing.PairingResult(
        *(jax_pairing.CandidateRead(**s) for s in strands), *ranges))
    got = tp._call_stereo(pairing.PairingResult(
        *(pairing.CandidateRead(**s) for s in strands), *ranges))
    assert got.qname == want.qname == "t;c" and len(got.seq) == len(got.qual)
    _assert_records_match([want], [got], min_positions=30)
    assert [(t.tag, t.value) for t in got.tags][1:] == [("dx", 1), ("ch", 1), ("mx", 1)]
    assert tp.stats.duplex_reads == 1 and tp.stats.stereo_features_s > 0
    # the stereo runners on the same features: both chunks of a batch
    rc = reverse_complement(strands[1]["seq"])
    feats = stereo.generate_stereo_features(stereo.StereoFeatureInputs(
        alignment=align(seq, rc).ops, template_seq=seq, template_qstring=strands[0]["qstring"],
        template_moves=strands[0]["moves"], template_signal=strands[0]["signal"],
        complement_seq=rc, complement_qstring=strands[1]["qstring"],
        complement_moves=strands[1]["moves"],
        complement_signal=np.ascontiguousarray(strands[1]["signal"][::-1]),
        signal_stride=STRIDE)).T
    assert len(feats) > CHUNK
    buf = tp.stereo_runner.make_input_buffer(0)
    tp.stereo_runner.accept_chunk(buf, 0, feats[:CHUNK])
    tp.stereo_runner.accept_chunk(buf, 1, feats[CHUNK : CHUNK + 700])  # repeat-padded rows
    np.testing.assert_array_equal(buf[1, 700:], buf[1, : CHUNK - 700])
    jbuf = jp.stereo_runner.make_input_buffer()
    jbuf[:2] = buf[:2]
    counts = [0, 0]
    for a, b in zip(jp.stereo_runner.call_chunks(jbuf, 2), tp.stereo_runner.call_chunks(buf, 2)):
        assert b.sequence == a.sequence
        np.testing.assert_array_equal(b.moves, a.moves)
        assert_qstrings_close(b.qstring, a.qstring, counts)
    assert counts[0] <= 0.01 * counts[1] and counts[1] > 30


PAIRS = 3


def test_run_matches_jax(pipelines):
    """``run`` with pairs forced the same way in both packages, on reads
    whose chunks fill whole batches (so that the JAX run writes all of
    them): the same records, the duplex records first."""
    decoder, (jp, tp) = pipelines
    _fresh_pairers(jp, tp)
    lengths = _lengths(3, PAIRS)
    ref, jstats = _jax_run(jp, _reads(jax_pod5, lengths, PAIRS))
    out = _Collect()
    stats = tp.run_reads(_reads(pod5, lengths, PAIRS), out)
    assert {r.qname for r in out.records} == {r.qname for r in ref}
    _assert_records_match(ref, out.records)
    duplex = [r for r in out.records if ";" in r.qname]
    assert len(duplex) == stats.duplex_reads == jstats.duplex_reads == PAIRS == stats.pairs
    assert [r.qname for r in out.records[:PAIRS]] == [r.qname for r in duplex]
    parents = {name for r in duplex for name in r.qname.split(";")}
    for r in out.records[PAIRS:]:
        assert dict((t.tag, t.value) for t in r.tags)["dx"] == (-1 if r.qname in parents else 0)
    assert stats.simplex_reads == len(lengths) == len(out.records) - PAIRS
    # every read went to the pairer once, in the order it finished
    assert len(tp.pairer.pushed) == len(lengths)
    assert stats.pair_align_s > 0 and stats.stereo_call_s > 0


def test_run_writes_the_reads_of_a_partial_batch(viterbi_pipelines):
    """A run whose last simplex batch never fills: the JAX run writes none
    of that batch's reads; the port writes every read."""
    jp, tp = viterbi_pipelines
    _fresh_pairers(jp, tp)
    lengths = _lengths(3, PAIRS, fill=False)
    ref, _ = _jax_run(jp, _reads(jax_pod5, lengths, PAIRS))
    out = _Collect()
    tp.run_reads(_reads(pod5, lengths, PAIRS), out)
    every = {f"read-{i}" for i in range(len(lengths))}
    got = {r.qname for r in out.records if ";" not in r.qname}
    assert got == every
    assert f"read-{len(lengths) - 1}" not in {r.qname for r in ref}
    _assert_records_match(ref, out.records)


def test_run_with_min_qscore_writes_the_reads_that_pass(viterbi_pipelines):
    """A ``min_qscore`` between the reads' qscores: the JAX run raises at the
    first read it filters; the port writes the records that pass, pairs
    only those, and calls the pairs among them."""
    jp, tp = viterbi_pipelines
    _fresh_pairers(jp, tp)
    lengths = _lengths(3, PAIRS)
    out = _Collect()
    tp.run_reads(_reads(pod5, lengths, PAIRS), out)
    qs = {r.qname: dict((t.tag, t.value) for t in r.tags)["qs"] for r in out.records
          if ";" not in r.qname}
    threshold = float(np.median(list(qs.values())))
    passing = {name for name, q in qs.items() if q >= threshold}
    assert 0 < len(passing) < len(qs)

    _fresh_pairers(jp, tp)
    jp.simplex.min_qscore = tp.simplex.min_qscore = threshold
    try:
        with pytest.raises(IndexError):
            _jax_run(jp, _reads(jax_pod5, lengths, PAIRS))
        filtered = _Collect()
        stats = tp.run_reads(_reads(pod5, lengths, PAIRS), filtered)
    finally:
        jp.simplex.min_qscore = tp.simplex.min_qscore = 0.0
    simplex = [r for r in filtered.records if ";" not in r.qname]
    assert {r.qname for r in simplex} == passing
    assert len(tp.pairer.pushed) == len(passing) == stats.simplex_reads
    unfiltered = {r.qname: r for r in out.records}
    for r in simplex:
        assert r.seq == unfiltered[r.qname].seq


def test_duplex_fixture_decodes_to_its_reads():
    """The committed duplex POD5 (``chip_smoke.py``'s) holds the reads that
    ``duplex_fixture_reads`` makes from its seed, in both readers: pairs on
    shared channels and muxes, each complement starting within 100 ms of its
    template's end, and two lone reads."""
    from tests.torch_duplex import DUPLEX_FIXTURE, DUPLEX_FIXTURE_PAIRS, duplex_fixture_reads

    want, _ = duplex_fixture_reads()
    assert DUPLEX_FIXTURE.stat().st_size < 1 << 20
    for module in (pod5, jax_pod5):
        got = list(module.Pod5File(DUPLEX_FIXTURE).reads())
        assert [g.read_id for g in got] == [str(r["read_id"]) for r in want]
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g.signal, r["signal"])
            assert (g.channel, g.well, g.start_sample) == (r["channel"], r["well"], r["start"])
    by_channel = list(pod5.iter_reads([DUPLEX_FIXTURE], by_channel=True))
    keys = [(r.channel, r.well) for r in by_channel]
    assert len(set(keys)) == DUPLEX_FIXTURE_PAIRS + 2 == len(by_channel) - DUPLEX_FIXTURE_PAIRS
    for t, c in zip(by_channel[: 2 * DUPLEX_FIXTURE_PAIRS : 2],
                    by_channel[1 : 2 * DUPLEX_FIXTURE_PAIRS : 2]):
        assert (t.channel, t.well) == (c.channel, c.well)
        assert 0 <= c.start_sample - (t.start_sample + len(t.signal)) <= 500
        assert 20_000 <= len(t.signal) <= 30_000
