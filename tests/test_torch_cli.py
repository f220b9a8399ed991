"""``python -m dorado_tpu_torch basecaller`` on the CPU against the JAX
command (``dorado_tpu.cli.main``) on the same model directory and POD5 file,
both splitting reads (their default), for SAM, FASTQ and BAM output; with
``--disable-read-splitting``, ``--min-qscore``, ``--read-ids``,
``--max-reads`` and ``--resume-from``; with ``--modified-bases-models``; and
the cases where it exits with 1. ``duplex`` against the JAX command with
pairs forced the same way in both (``tests/torch_duplex.py``), with and
without duplex modified bases, and ``duplex basespace``.

The file holds white-noise reads, as ``tests/test_torch_pipeline.py`` feeds
the pipelines. (On the smooth signal of the committed fixture this narrow
random model calls long repeats, where the Viterbi path has near-ties that
the two frameworks' float32 sums break differently for 2 of 16 reads.)"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.io.bam_reader import read_records
from dorado_tpu.models.load import save_lstm_params as jax_save_lstm_params
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu_torch.cli.main import main
from dorado_tpu_torch.io.pod5 import Pod5File
from dorado_tpu_torch.io.sam import SamRecord, SamTag
from dorado_tpu_torch.modbase.model import init_modbase_params, save_modbase_model
from dorado_tpu_torch.models.presets import config_toml, hac_5mcg_5hmcg_v3_config, hac_v43_config
from dorado_tpu_torch.utils.sequence import reverse_complement
from tests.test_torch_runner import _narrow_hac, assert_qstrings_close, jax_params_with_moves
from tests.torch_cram import rr_cram
from tests.torch_pod5_writer import make_reads, run_info, write_pod5

REPO = Path(__file__).resolve().parent.parent
COMMON = ["-c", "1200", "-b", "8", "--emit-moves"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread in this process and in the subprocess: the runs
    are many small operators, whose thread-pool barriers crawl when the test
    workers oversubscribe the CPU; one thread count on both sides also keeps
    their float sums in one order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    model = d / "dna_r10.4.1_e8.2_400bps_hac@v4.3.0"
    model.mkdir()
    (model / "config.toml").write_text(config_toml(_narrow_hac(hac_v43_config())))
    jax_save_lstm_params(_narrow_hac(jax_hac_config()), jax_params_with_moves(2), model)
    data = d / "pod5"
    data.mkdir()
    infos = [run_info(3)]
    write_pod5(data / "calls.pod5",
               make_reads(7, [3000, 890, 5200, 1700, 2500], infos, noise=True), infos)
    return model, data


@pytest.fixture(scope="module")
def mod_dir(tmp_path_factory):
    """A narrow 5mCG_5hmCG@v3 modbase model directory (width 32, random
    weights and kmer levels from seeds)."""
    cfg = hac_5mcg_5hmcg_v3_config(32)
    levels = np.random.RandomState(5).randn(4**cfg.kmer_len).astype(np.float32)
    model = init_modbase_params(cfg, torch.Generator().manual_seed(3))
    return save_modbase_model(cfg, model, tmp_path_factory.mktemp("mod") / cfg.model_path.name,
                              refine_levels=levels)


def _fastq_records(path: Path) -> list[SamRecord]:
    lines = path.read_text().splitlines()
    out = []
    for i in range(0, len(lines), 4):
        name, *tags = lines[i][1:].split("\t")
        assert lines[i + 2] == "+"
        parsed = []
        for t in tags:
            tag, typ, val = t.split(":", 2)
            parsed.append(SamTag(tag, typ, float(val) if typ == "f" else val))
        out.append(SamRecord(qname=name, seq=lines[i + 1], qual=lines[i + 3], tags=parsed))
    return out


def _records(path: Path, fmt: str) -> tuple[list[str], list]:
    """(@RG lines, records) of an output file."""
    if fmt == "fastq":
        return [], _fastq_records(path)
    header, records = read_records(path)
    return [l for l in header.splitlines() if l.startswith("@RG")], records


def _assert_records_match(ref, out, n_records=5, min_positions=500):
    """``tests/test_torch_pipeline.py``'s rule: records in the same order,
    sequences, flags and every tag equal but ``qs`` (within 1%) and the
    quality string (chars a step apart at most, at under 1% of bases)."""
    assert [r.qname for r in out] == [r.qname for r in ref] and len(out) == n_records
    counts = [0, 0]
    for a, b in zip(ref, out):
        assert b.seq == a.seq and b.flag == a.flag
        assert_qstrings_close(b.qual, a.qual, counts)
        assert [t.tag for t in b.tags] == [t.tag for t in a.tags]
        for ta, tb in zip(a.tags, b.tags):
            if ta.tag == "qs":
                assert float(tb.value) == pytest.approx(float(ta.value), rel=1e-2)
            elif ta.tag == "mv":
                np.testing.assert_array_equal(tb.value, ta.value)
            else:
                assert (tb.type, tb.value, tb.subtype) == (ta.type, ta.value, ta.subtype), ta.tag
    assert counts[1] > min_positions
    assert counts[0] <= 0.01 * counts[1]


@pytest.mark.parametrize("fmt", ["sam", "fastq", "bam"])
def test_cli_matches_jax_cli(inputs, tmp_path, fmt):
    model, data = inputs
    flags = {"sam": ["--emit-sam"], "fastq": ["--emit-fastq"], "bam": []}[fmt]
    ours, theirs = tmp_path / f"ours.{fmt}", tmp_path / f"theirs.{fmt}"
    assert jax_main(["basecaller", str(model), str(data), *COMMON, *flags, "--dtype", "float32",
                     "-x", "cpu", "-o", str(theirs)]) == 0
    assert main(["basecaller", str(model), str(data), *COMMON, *flags, "-x", "cpu",
                 "-o", str(ours)]) == 0
    rg_ref, ref = _records(theirs, fmt)
    rg_out, out = _records(ours, fmt)
    assert rg_out == rg_ref
    if fmt != "fastq":
        assert len(rg_out) == 1 and "basecall_model=dna_r10.4.1_e8.2_400bps_hac@v4.3.0" in rg_out[0]
    _assert_records_match(ref, out)
    if fmt != "fastq":
        assert all(dict((t.tag, t.value) for t in r.tags)["fn"] == "calls.pod5" for r in out)


def test_cli_writes_into_a_directory_and_counts_skipped_reads(inputs, tmp_path, capsys):
    model, _ = inputs
    infos = [run_info(4)]
    data = tmp_path / "in"
    data.mkdir()
    write_pod5(data / "x.pod5", make_reads(8, [2000, 1500, 2500], infos, noise=True), infos,
               corrupt_reads=(1,))
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    assert main(["basecaller", str(model), str(data), *COMMON, "--emit-sam", "-x", "cpu",
                 "-o", str(out_dir), "--no-trim", "--decoder", "beam"]) == 0
    written = list(out_dir.glob("calls_*.sam"))
    assert len(written) == 1
    _, records = read_records(written[0])
    assert len(records) == 2
    err = capsys.readouterr().err
    assert "> Reads basecalled: 2" in err and "> Basecalled @ Samples/s:" in err
    assert "> Reads skipped (POD5 decode faults): 1" in err


def _qs(rec) -> float:
    return float(next(t.value for t in rec.tags if t.tag == "qs"))


@pytest.fixture(scope="module")
def default_sam(inputs, tmp_path_factory):
    """The JAX command's SAM with the default options."""
    model, data = inputs
    out = tmp_path_factory.mktemp("default") / "calls.sam"
    assert jax_main(["basecaller", str(model), str(data), *COMMON, "--emit-sam", "--dtype",
                     "float32", "-x", "cpu", "-o", str(out)]) == 0
    return read_records(out)[1]


@pytest.mark.parametrize("option", ["disable-read-splitting", "min-qscore", "read-ids",
                                    "max-reads", "resume-from"])
def test_cli_read_options_match_jax_cli(inputs, default_sam, tmp_path, capfd, option):
    """Each read option writes the JAX command's SAM. ``--resume-from`` takes
    a partial BAM that the port wrote with ``--max-reads 2``: both commands
    replay its two records first, then call the three other reads."""
    model, data = inputs
    names = [r.qname for r in default_sam]
    first = [r.read_id for r in Pod5File(data / "calls.pod5").reads()]  # in input order
    if option == "min-qscore":
        qs = sorted(_qs(r) for r in default_sam)
        gap, i = max((b - a, i) for i, (a, b) in enumerate(zip(qs, qs[1:])))
        assert gap > 0.05 * qs[i + 1]
        threshold = (qs[i] + qs[i + 1]) / 2
        extra, kept = ["--min-qscore", str(threshold)], [n for n, r in zip(names, default_sam)
                                                        if _qs(r) > threshold]
    elif option == "read-ids":
        (tmp_path / "ids.txt").write_text(f"{names[3]}\n\n{names[1]}\nnot-a-read\n")
        extra, kept = ["--read-ids", str(tmp_path / "ids.txt")], [names[1], names[3]]
    elif option == "max-reads":
        extra, kept = ["--max-reads", "3"], first[:3]
    elif option == "resume-from":
        partial = tmp_path / "partial.bam"
        assert main(["basecaller", str(model), str(data), *COMMON, "-x", "cpu", "--max-reads",
                     "2", "-o", str(partial)]) == 0
        extra, kept = ["--resume-from", str(partial)], names
    else:
        extra, kept = ["--disable-read-splitting"], names
    ours, theirs = tmp_path / "ours.sam", tmp_path / "theirs.sam"
    assert jax_main(["basecaller", str(model), str(data), *COMMON, *extra, "--emit-sam",
                     "--dtype", "float32", "-x", "cpu", "-o", str(theirs)]) == 0
    capfd.readouterr()
    assert main(["basecaller", str(model), str(data), *COMMON, *extra, "--emit-sam", "-x", "cpu",
                 "-o", str(ours)]) == 0
    err = capfd.readouterr().err
    _, ref = _records(theirs, "sam")
    _, out = _records(ours, "sam")
    assert sorted(r.qname for r in out) == sorted(kept)
    _assert_records_match(ref, out, n_records=len(kept), min_positions=100)
    if option == "resume-from":
        assert sorted(r.qname for r in out[:2]) == sorted(first[:2])
        assert "> Resuming: 2 reads already basecalled" in err
        assert "> Reads basecalled: 3" in err


def test_cli_modified_bases_matches_jax_cli(inputs, mod_dir, tmp_path):
    """``--modified-bases-models`` (with a threshold and a batch size) writes
    the JAX command's SAM: every tag as the other tests hold them, MN/MM/ML
    after ``me``, MM equal, ML values within 1 and equal at 99.9% of them
    (``tests/test_torch_pipeline.py``'s rule), and ML non-empty."""
    model, data = inputs
    extra = ["--modified-bases-models", str(mod_dir), "--modified-bases-threshold", "0.2",
             "--modified-bases-batchsize", "16", "--emit-sam"]
    ours, theirs = tmp_path / "ours.sam", tmp_path / "theirs.sam"
    assert jax_main(["basecaller", str(model), str(data), *COMMON, *extra, "--dtype", "float32",
                     "-x", "cpu", "-o", str(theirs)]) == 0
    assert main(["basecaller", str(model), str(data), *COMMON, *extra, "-x", "cpu",
                 "-o", str(ours)]) == 0
    _, ref = _records(theirs, "sam")
    _, out = _records(ours, "sam")
    ml = []
    for recs in (ref, out):
        ml.append(np.concatenate([np.asarray(next(t for t in r.tags if t.tag == "ML").value,
                                             dtype=np.int32) for r in recs]))
        for r in recs:
            assert [t.tag for t in r.tags][-4:] == ["me", "MN", "MM", "ML"]
            r.tags = [t for t in r.tags if t.tag != "ML"]
    _assert_records_match(ref, out)
    assert len(ml[0]) == len(ml[1]) > 20
    diff = np.abs(ml[0] - ml[1])
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("case", ["missing-dir", "no-pod5", "model-name", "variant",
                                  "resume-other-model", "resume-other-modbase", "resume-cram",
                                  "beam-host", "fast5"])
def test_cli_exits_1(inputs, mod_dir, tmp_path, capsys, case):
    model, data = inputs
    empty = tmp_path / "empty"
    empty.mkdir()
    args = {
        "missing-dir": [str(tmp_path / "nope"), str(data), *COMMON],
        "no-pod5": [str(model), str(empty), *COMMON],
        "model-name": ["dna_r10.4.1_e8.2_400bps_hac@v4.3.0", str(data), *COMMON],
        "variant": ["hac@v4.3", str(data), *COMMON],
        "resume-other-model": [str(model), str(data), *COMMON, "--resume-from",
                               str(tmp_path / "other.sam")],
        "resume-other-modbase": [str(model), str(data), *COMMON, "--resume-from",
                                 str(tmp_path / "other.sam"), "--modified-bases-models",
                                 str(mod_dir)],
        "resume-cram": [str(model), str(data), *COMMON, "--resume-from", str(tmp_path / "x.cram")],
        "beam-host": [str(model), str(data), *COMMON, "--decoder", "beam-host"],
        "fast5": [str(model), str(empty), *COMMON],
    }[case]
    if case == "fast5":
        (empty / "old.fast5").write_bytes(b"")
    if case == "resume-cram":
        # a reference-based CRAM: no reader is given its contig, as in JAX
        rr_cram(tmp_path / "x.cram")
    if case == "resume-other-model":
        # a file another model wrote, which the JAX command refuses too
        (tmp_path / "other.sam").write_text(
            "@HD\tVN:1.6\tSO:unknown\n@PG\tID:basecaller\tPN:dorado_tpu_torch\tVN:0.1.0\t"
            f"CL:dorado_tpu_torch basecaller {tmp_path / 'dna_r10.4.1_e8.2_400bps_sup@v5.0.0'} "
            f"{data} --emit-sam\nread-x\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t++++\tqs:f:5.0\n")
    if case == "resume-other-modbase":
        # the same basecall model with another modified-base model
        (tmp_path / "other.sam").write_text(
            "@HD\tVN:1.6\tSO:unknown\n@PG\tID:basecaller\tPN:dorado_tpu_torch\tVN:0.1.0\t"
            f"CL:dorado_tpu_torch basecaller {model} {data} --modified-bases-models "
            f"{tmp_path / 'dna_r10.4.1_e8.2_400bps_hac@v5.0.0_6mA@v2'}\n"
            "read-x\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t++++\tqs:f:5.0\n")
    if case.startswith("resume-other"):
        with capsys.disabled():  # the JAX command enables faulthandler on the real stderr
            assert jax_main(["basecaller", *args, "-x", "cpu", "-o", str(tmp_path / "j.bam")]) == 1
    assert main(["basecaller", *args, "-x", "cpu", "-o", str(tmp_path / "o.bam")]) == 1
    err = capsys.readouterr().err
    want = {
        "missing-dir": f"> Model directory not found: {tmp_path / 'nope'}",
        "no-pod5": f"> No POD5 files found under {empty}",
        "model-name": "the port has no model downloader yet",
        "variant": "the port has no model downloader yet",
        "resume-other-model": "Inconsistent models used in this pipeline and those used in the "
                              "--resume-from file",
        "resume-other-modbase": "Resumed: ('dna_r10.4.1_e8.2_400bps_hac@v4.3.0', "
                                "('dna_r10.4.1_e8.2_400bps_hac@v5.0.0_6mA@v2',))",
        "resume-cram": "RR=true slice needs ref_seqs['ctg'] to decode",
        "beam-host": "beam-host is not supported",
        "fast5": "FAST5 files are not supported",
    }[case]
    assert want in err


def test_cli_rejects_options_it_does_not_have(inputs):
    model, data = inputs
    for extra in (["--dtype", "float16"], ["--trim", "barcodes"]):
        with pytest.raises(SystemExit) as exc:
            main(["basecaller", str(model), str(data), *COMMON, "-x", "cpu", *extra])
        assert exc.value.code == 2


def test_python_m_entry_point(inputs, tmp_path):
    """``python -m dorado_tpu_torch`` in a fresh process writes the SAM that
    ``main`` writes in this one, but for the @PG command line."""
    model, data = inputs
    args = ["basecaller", str(model), str(data), *COMMON, "--emit-sam", "-x", "cpu"]
    assert main([*args, "-o", str(tmp_path / "in.sam")]) == 0
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "dorado_tpu_torch", *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "> Reads basecalled: 5" in res.stderr

    def body(text):
        return [l for l in text.splitlines() if not l.startswith("@PG")]

    assert body(res.stdout) == body((tmp_path / "in.sam").read_text())


# ---- duplex ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def duplex_inputs(inputs, tmp_path_factory):
    """A narrow stereo model directory (the JAX package writes its weights,
    the head's bias drawn) and a POD5 file of white-noise reads in pairs on
    shared channels and muxes, whose chunks fill whole batches at ``-c 1200
    -b 8`` (the JAX command writes no read of a batch that never fills).
    The reads have no calibration offset, so their signal lies about the
    standardisation mean as ``tests/test_torch_pipeline.py``'s does: with
    the writer's random offsets, one of these 11 reads drives the narrow
    random model into a long repeat whose Viterbi near-ties the two
    frameworks break differently (in the simplex commands too)."""
    from dorado_tpu.config import load_model_config as jax_load_config
    from dorado_tpu_torch.models.presets import stereo_config
    from tests.test_torch_duplex import PAIRS, _jax_stereo_params, _lengths, _narrow_stereo
    from tests.torch_duplex import duplex_read_layout

    d = tmp_path_factory.mktemp("duplex")
    cfg = _narrow_stereo(stereo_config())
    stereo = d / cfg.model_name
    stereo.mkdir()
    (stereo / "config.toml").write_text(config_toml(cfg))
    jcfg = jax_load_config(stereo)
    jax_save_lstm_params(jcfg, _jax_stereo_params(jcfg), stereo)
    lengths = _lengths(3, PAIRS)
    infos = [run_info(3)]
    reads = make_reads(8, lengths, infos, noise=True)
    layout = duplex_read_layout(np.random.RandomState(8), lengths, PAIRS)
    for r, (channel, well, start) in zip(reads, layout):
        r.update(channel=channel, well=well, start=start, end_reason="signal_positive",
                 calibration_offset=0.0)
    data = d / "pod5"
    data.mkdir()
    write_pod5(data / "duplex.pod5", reads, infos)
    return inputs[0], stereo, data, [str(r["read_id"]) for r in reads]


@pytest.fixture
def forced_pairs(monkeypatch):
    """Both duplex pipelines pair reads with ``ForcedPairer``."""
    import dorado_tpu.duplex.pipeline as jax_duplex_pipeline
    from dorado_tpu.duplex.pairing import PairingResult as JaxPairingResult
    import dorado_tpu_torch.duplex.pipeline as port_duplex_pipeline
    from dorado_tpu_torch.duplex.pairing import PairingResult
    from tests.torch_duplex import ForcedPairer

    monkeypatch.setattr(jax_duplex_pipeline, "DuplexPairer",
                        lambda: ForcedPairer(JaxPairingResult))
    monkeypatch.setattr(port_duplex_pipeline, "DuplexPairer", lambda: ForcedPairer(PairingResult))


@pytest.mark.parametrize("case", ["viterbi", "modbase"])
def test_cli_duplex_matches_jax_cli(duplex_inputs, mod_dir, forced_pairs, tmp_path, capfd, case):
    """``duplex <model> <pod5> --stereo-model <dir>`` on the CPU against the
    JAX command with the same pairs forced: the same @RG lines and records
    (the duplex records first: sequences equal, qstrings within a step, tags
    equal but ``qs``), with ``--modified-bases-models`` the duplex MM/ML/MN
    too; then ``duplex basespace --pairs`` on that SAM, equal to the JAX
    command's."""
    from tests.test_torch_duplex import PAIRS, _assert_records_match

    model, stereo, data, read_ids = duplex_inputs
    # BAM with mods: the JAX command's SAM writes an empty ML as "ML:B:C,",
    # which no reader parses (the port writes "ML:B:C")
    fmt = "bam" if case == "modbase" else "sam"
    extra = ["--modified-bases-models", str(mod_dir)] if case == "modbase" else ["--emit-sam"]
    args = ["duplex", str(model), str(data), "--stereo-model", str(stereo), "-c", "1200", "-b",
            "8", *extra, "-x", "cpu"]
    ours, theirs = tmp_path / f"ours.{fmt}", tmp_path / f"theirs.{fmt}"
    assert jax_main([*args, "-o", str(theirs)]) == 0
    assert main([*args, "-o", str(ours)]) == 0
    err = capfd.readouterr().err
    assert f"> Simplex reads basecalled: {len(read_ids)}" in err
    assert f"> Duplex reads basecalled: {PAIRS}" in err and "> Duplex rate: " in err
    rg_ref, ref = _records(theirs, fmt)
    rg_out, out = _records(ours, fmt)
    assert rg_out == rg_ref and len(rg_out) == 1
    # the JAX run harvests each batch's reads in reverse: the same records,
    # compared by name
    assert sorted(r.qname for r in out) == sorted(r.qname for r in ref)
    assert len(out) == len(read_ids) + PAIRS and all(";" in r.qname for r in out[:PAIRS])
    _assert_records_match(ref, out)
    if case == "modbase":
        for r in out[:PAIRS]:
            tags = {t.tag: t.value for t in r.tags}
            assert [t.tag for t in r.tags][-3:] == ["MM", "ML", "MN"]
            assert "C+h?" in tags["MM"] and "G-m?" in tags["MM"] and tags["MN"] == len(r.seq)

    pairs = tmp_path / "pairs.txt"
    pairs.write_text("".join(r.qname.replace(";", " ") + "\n" for r in out[:PAIRS]))
    base = ["duplex", "basespace", str(ours), "--pairs", str(pairs), "--emit-sam", "-x", "cpu"]
    assert jax_main([*base, "-o", str(tmp_path / "jb.sam")]) == 0
    assert main([*base, "-o", str(tmp_path / "ob.sam")]) == 0
    got, want = _records(tmp_path / "ob.sam", "sam")[1], _records(tmp_path / "jb.sam", "sam")[1]
    assert [(r.qname, r.seq, r.qual, [(t.tag, t.value) for t in r.tags]) for r in got] == [
        (r.qname, r.seq, r.qual, [(t.tag, t.value) for t in r.tags]) for r in want]


def test_cli_duplex_basespace_matches_jax_cli(tmp_path, capfd):
    """``duplex basespace`` on a SAM of planted template and complement calls
    (the complement the reverse complement of the template with errors) and
    a pairs file naming them, one unknown id among them: the consensus
    records equal the JAX command's."""
    from tests.test_torch_duplex import _mutate, _seq

    rs = np.random.RandomState(21)
    lines, pairs = ["@HD\tVN:1.6\tSO:unknown"], []
    for i, n in enumerate((300, 800, 1500)):
        t = _seq(rs, n)
        c = reverse_complement(_mutate(rs, t))
        for name, s in ((f"t{i}", t), (f"c{i}", c)):
            q = "".join(chr(33 + int(v)) for v in rs.randint(2, 41, len(s)))
            lines.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{s}\t{q}\tqs:f:10.0")
        pairs.append(f"t{i} c{i}")
    pairs.append("t0 nope")
    (tmp_path / "in.sam").write_text("\n".join(lines) + "\n")
    (tmp_path / "pairs.txt").write_text("\n".join(pairs) + "\n")
    base = ["duplex", "basespace", str(tmp_path / "in.sam"), "--pairs",
            str(tmp_path / "pairs.txt"), "--emit-sam", "-x", "cpu"]
    assert jax_main([*base, "-o", str(tmp_path / "j.sam")]) == 0
    assert main([*base, "-o", str(tmp_path / "o.sam")]) == 0
    assert "> Duplex reads basecalled: 3" in capfd.readouterr().err
    got, want = _records(tmp_path / "o.sam", "sam")[1], _records(tmp_path / "j.sam", "sam")[1]
    assert [r.qname for r in got] == ["t0;c0", "t1;c1", "t2;c2"]
    assert [(r.qname, r.seq, r.qual, [(t.tag, t.value) for t in r.tags]) for r in got] == [
        (r.qname, r.seq, r.qual, [(t.tag, t.value) for t in r.tags]) for r in want]


@pytest.mark.parametrize("case", ["no stereo model", "beam-host", "basespace without pairs"])
def test_cli_duplex_exits_1(duplex_inputs, capsys, case):
    model, stereo, data, _ = duplex_inputs
    args = {
        "no stereo model": [str(model), str(data)],
        "beam-host": [str(model), str(data), "--stereo-model", str(stereo), "--decoder",
                      "beam-host"],
        "basespace without pairs": ["basespace", str(data)],
    }[case]
    assert main(["duplex", *args, "-x", "cpu", "--emit-sam"]) == 1
    want = {"no stereo model": "> stereo duplex requires --stereo-model",
            "beam-host": "beam-host is not supported",
            "basespace without pairs": "> basespace mode requires --pairs"}[case]
    assert want in capsys.readouterr().err


def test_cli_duplex_rejects_modified_bases_by_name(duplex_inputs):
    """``--modified-bases`` names models for the downloader, which the port
    has not: argparse rejects it (exit 2), as for ``basecaller``."""
    model, stereo, data, _ = duplex_inputs
    with pytest.raises(SystemExit) as exc:
        main(["duplex", str(model), str(data), "--stereo-model", str(stereo),
              "--modified-bases", "5mCG_5hmCG", "-x", "cpu"])
    assert exc.value.code == 2
