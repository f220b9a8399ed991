"""CRAM through the port's commands on the CPU against the JAX commands:
``basecaller -o x.cram`` and ``--emit-cram`` into an output directory
(``calls_<timestamp>.cram``) write CRAM, as the JAX command does, with rANS
or, under ``--no-cram-rans``, gzip blocks; ``--resume-from`` a cut CRAM;
``summary``, ``trim``, ``demux``, ``aligner``, basespace ``duplex`` and the
polish and variant commands' alignments read a CRAM to what they read from
the BAM of the same records.

Before this slice the port's ``basecaller -o x.cram`` wrote BAM bytes into
``x.cram``: the first test holds the magic and the records against the JAX
command's file."""

from argparse import Namespace

import numpy as np
import pytest
import torch

from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.io.cram import CramReader as JaxCramReader
from dorado_tpu.models.load import save_lstm_params as jax_save_lstm_params
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu_torch.cli import main as cli_module
from dorado_tpu_torch.cli.main import main
from dorado_tpu_torch.io import cram
from dorado_tpu_torch.io.bam_reader import read_records
from dorado_tpu_torch.io.sam import BamWriter, SamHeader
from dorado_tpu_torch.models.presets import config_toml, hac_v43_config
from tests.test_torch_cli import _assert_records_match
from tests.test_torch_runner import _narrow_hac, jax_params_with_moves
from tests.torch_demux import planted_records
from tests.torch_polish import polish_inputs, write_fasta, write_fastq
from tests.torch_pod5_writer import make_reads, run_info, write_pod5

COMMON = ["-c", "1200", "-b", "8", "--emit-moves", "-x", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, from before the module's fixtures run: several test
    workers share the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """A narrow hac model directory, a POD5 of white-noise reads, and both
    commands' ``basecaller -o calls.cram``: (dir, model, pod5, the port's
    CRAM, the JAX command's CRAM)."""
    d = tmp_path_factory.mktemp("cram_cli")
    model = d / "dna_r10.4.1_e8.2_400bps_hac@v4.3.0"
    model.mkdir()
    (model / "config.toml").write_text(config_toml(_narrow_hac(hac_v43_config())))
    jax_save_lstm_params(_narrow_hac(jax_hac_config()), jax_params_with_moves(2), model)
    infos = [run_info(3)]
    pod5 = d / "calls.pod5"
    write_pod5(pod5, make_reads(7, [3000, 890, 5200, 1700, 2500], infos, noise=True), infos)
    ours, theirs = d / "calls.cram", d / "jax.cram"
    assert jax_main(["basecaller", str(model), str(pod5), *COMMON, "--dtype", "float32",
                     "-o", str(theirs)]) == 0
    assert main(["basecaller", str(model), str(pod5), *COMMON, "-o", str(ours)]) == 0
    return d, model, pod5, ours, theirs


def _canonical(records):
    """Each record's fields and its tags by name (a CRAM reader gives RG
    last), arrays as lists."""
    return [(r.qname, r.flag, r.rname, r.pos, r.cigar, r.seq, r.qual,
             sorted((t.tag, t.type, np.atleast_1d(t.value).tolist() if t.type == "B"
                     else t.value) for t in r.tags))
            for r in records]


def test_basecaller_cram_output_is_cram(calls):
    """``-o calls.cram`` writes a CRAM (the magic, the EOF container), whose
    records both readers give back as the JAX command's, within the runner
    test's qstring tolerance."""
    _, _, _, ours, theirs = calls
    data = ours.read_bytes()
    assert data[:6] == b"CRAM\x03\x00" and data.endswith(cram.CRAM_EOF)
    assert theirs.read_bytes()[:6] == b"CRAM\x03\x00"
    mine = list(cram.CramReader(ours).records())
    assert _canonical(mine) == _canonical(JaxCramReader(ours).records())
    jax_records = list(cram.CramReader(theirs).records())
    for recs in (mine, jax_records):  # B arrays compare by value
        for r in recs:
            for t in r.tags:
                if t.type == "B" and t.tag != "mv":
                    t.value = tuple(np.atleast_1d(t.value).tolist())
    _assert_records_match(jax_records, mine)
    text = cram.CramReader(ours).header_text
    assert "@PG\tID:basecaller\tPN:dorado_tpu_torch" in text and "@RG\tID:run-3_" in text


@pytest.mark.parametrize("case", ["emit-cram-dir", "no-cram-rans"])
def test_emit_cram_and_gzip_blocks(calls, tmp_path, monkeypatch, case):
    """``--emit-cram`` into a directory names ``calls_<timestamp>.cram``, as the
    JAX command does, its writer on rANS; ``--no-cram-rans`` writes gzip
    blocks (the calls' streams are too short for rANS to win, so the option
    is seen at the writer); both hold the records of ``-o calls.cram``."""
    _, model, pod5, ours, _ = calls
    made = []

    class Writer(cram.CramWriter):
        def __init__(self, *args, **kwargs):
            made.append(kwargs)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(cram, "CramWriter", Writer)
    if case == "emit-cram-dir":
        out_dir = tmp_path / "out"
        assert main(["basecaller", str(model), str(pod5), *COMMON, "--emit-cram",
                     "-o", str(out_dir) + "/"]) == 0
        jax_dir = tmp_path / "jax_out"
        assert jax_main(["basecaller", str(model), str(pod5), *COMMON, "--dtype", "float32",
                         "--emit-cram", "-o", str(jax_dir) + "/"]) == 0
        (path,), (jax_path,) = list(out_dir.iterdir()), list(jax_dir.iterdir())
        assert path.name.startswith("calls_") and path.suffix == jax_path.suffix == ".cram"
        assert made == [{"rans": True}]
    else:
        path = tmp_path / "gz.cram"
        assert main(["basecaller", str(model), str(pod5), *COMMON, "--no-cram-rans",
                     "-o", str(path)]) == 0
        assert made == [{"rans": False}]
        assert cram.RANS4x8 not in cram.scan_structure(path)["methods"]
    assert path.read_bytes()[:4] == b"CRAM"
    assert _canonical(cram.CramReader(path).records()) == _canonical(
        cram.CramReader(ours).records())


def test_resume_from_cram_matches_jax(calls, tmp_path):
    """``--resume-from`` a CRAM of the first two records: each command
    replays them and calls the rest; the port's file equals the JAX
    command's, record for record."""
    d, model, pod5, ours, _ = calls
    header_text, records = read_records(ours)
    cut = tmp_path / "cut.cram"
    header = SamHeader()
    header.read_groups = [dict(f.split(":", 1) for f in line.split("\t")[1:])
                          for line in header_text.splitlines() if line.startswith("@RG")]
    header.programs = [dict(f.split(":", 1) for f in line.split("\t")[1:])
                       for line in header_text.splitlines() if line.startswith("@PG")]
    with open(cut, "wb") as fh:
        w = cram.CramWriter(fh, header)
        for r in records[:2]:
            w.write(r)
        w.close()
    outs = {}
    for who, fn, extra in (("jax", jax_main, ["--dtype", "float32"]), ("torch", main, [])):
        outs[who] = tmp_path / f"{who}.sam"
        assert fn(["basecaller", str(model), str(pod5), *COMMON, *extra, "--emit-sam",
                   "--resume-from", str(cut), "-o", str(outs[who])]) == 0
    got, want = (read_records(outs[w])[1] for w in ("torch", "jax"))
    assert [r.qname for r in got[:2]] == [r.qname for r in records[:2]]
    for recs in (got, want):
        for r in recs:
            for t in r.tags:
                if t.type == "B" and t.tag != "mv":
                    t.value = tuple(np.atleast_1d(t.value).tolist())
    _assert_records_match(want, got, n_records=len(records))


@pytest.fixture(scope="module")
def record_files(calls):
    """The port's calls as a CRAM and as a BAM (the same command with ``-o
    calls.bam``: the same header and records)."""
    d, model, pod5, ours, _ = calls
    bam = d / "calls.bam"
    assert main(["basecaller", str(model), str(pod5), *COMMON, "-o", str(bam)]) == 0
    assert _canonical(read_records(bam)[1]) == _canonical(read_records(ours)[1])
    return ours, bam


def _stdout(fn, argv, capfd):
    capfd.readouterr()
    assert fn(argv) == 0
    return capfd.readouterr().out


def test_summary_reads_cram(record_files, capfd):
    """``summary`` of the CRAM: the rows of its BAM and the JAX command's."""
    cram_path, bam = record_files
    got = _stdout(main, ["summary", str(cram_path)], capfd)
    assert got == _stdout(main, ["summary", str(bam)], capfd)
    assert got == _stdout(jax_main, ["summary", str(cram_path)], capfd)
    assert len(got.splitlines()) == 1 + len(read_records(bam)[1])


@pytest.mark.parametrize("rna", [False, True])
def test_trim_reads_cram(record_files, tmp_path, rna):
    """``trim`` (and ``trim --rna``, which changes nothing) on the CRAM writes
    the records it writes from the BAM, and the JAX command's."""
    cram_path, bam = record_files
    extra = ["--rna"] if rna else []
    outs = {}
    for who, fn, src in (("cram", main, cram_path), ("bam", main, bam),
                         ("jax", jax_main, cram_path)):
        outs[who] = tmp_path / f"{who}.sam"
        assert fn(["trim", str(src), *extra, "--emit-sam", "-o", str(outs[who])]) == 0
    # each line's fields and its tags in order of name (RG comes last from a CRAM)
    lines = {w: [(f[:11], sorted(f[11:])) for f in (line.split("\t") for line in
                                                      p.read_text().splitlines()
                                                      if not line.startswith("@"))]
             for w, p in outs.items()}
    assert lines["cram"] == lines["bam"] == lines["jax"] and lines["cram"]


def test_demux_reads_cram(tmp_path):
    """``demux`` over a CRAM of planted barcoded reads writes the BAMs it
    writes from their BAM."""
    records, _ = planted_records(5, "SQK-NBD114-24", 24, (600, 1201), 0.03, 0.1, adapters=True)
    header = SamHeader()
    # a CRAM carries RG as an index into the header's read groups (as in JAX)
    header.read_groups = [{"ID": "run_model"}]
    paths = {}
    for fmt, cls in (("cram", cram.CramWriter), ("bam", BamWriter)):
        paths[fmt] = tmp_path / f"planted.{fmt}"
        with open(paths[fmt], "wb") as fh:
            w = cls(fh, header)
            for r in records:
                w.write(r)
            w.close()
    outs = {}
    for fmt in paths:
        out = tmp_path / f"out_{fmt}"
        assert main(["demux", str(paths[fmt]), "--kit-name", "SQK-NBD114-24", "--output-dir",
                     str(out)]) == 0
        outs[fmt] = {p.name: _canonical(read_records(p)[1]) for p in sorted(out.iterdir())}
    assert outs["cram"] == outs["bam"] and len(outs["cram"]) > 2


def test_aligner_reads_cram_and_writes_rr_true(tmp_path, capfd):
    """``aligner ref.fa reads.cram -o out.cram``: the records of the same
    command on the reads' BAM and of the JAX command on the CRAM, through
    ``CramReader(ref_seqs)``; the output is reference-based, so ``summary``
    on it exits 1 naming the contig, as the JAX readers refuse it."""
    draft, _, reads = polish_inputs(11, 6000, 12, (800, 1500), error=0.03, draft_error=0.0)
    ref = write_fasta(tmp_path / "ref.fa", [("ctg", draft)])
    fastq = write_fastq(tmp_path / "reads.fastq", reads)
    from dorado_tpu_torch.io.sam import SamRecord

    recs = [SamRecord(qname=n, seq=s, qual=q) for n, s, q in reads]
    paths = {}
    for fmt, cls in (("cram", cram.CramWriter), ("bam", BamWriter)):
        paths[fmt] = tmp_path / f"reads.{fmt}"
        with open(paths[fmt], "wb") as fh:
            w = cls(fh, SamHeader())
            for r in recs:
                w.write(r)
            w.close()
    got = {}
    for who, fn, src in (("cram", main, paths["cram"]), ("bam", main, paths["bam"]),
                         ("jax", jax_main, paths["cram"]), ("fastq", main, fastq)):
        out = tmp_path / f"aligned_{who}.cram"
        assert fn(["aligner", str(ref), str(src), "-o", str(out)]) == 0
        got[who] = _canonical(cram.CramReader(out, ref_seqs={"ctg": draft}).records())
    assert got["cram"] == got["bam"] == got["jax"] == got["fastq"]
    assert sum(not r[1] & 4 for r in got["cram"]) >= 10
    capfd.readouterr()
    assert main(["summary", str(tmp_path / "aligned_cram.cram")]) == 1
    assert "RR=true slice needs ref_seqs['ctg'] to decode" in capfd.readouterr().err


def test_basespace_duplex_reads_cram(tmp_path):
    """``duplex basespace`` over a CRAM of template-complement pairs writes
    what it writes from their BAM."""
    from dorado_tpu_torch.io.sam import SamRecord
    from dorado_tpu_torch.utils.sequence import reverse_complement

    _, _, reads = polish_inputs(13, 4000, 6, (500, 900), error=0.0, draft_error=0.0)
    records = []
    for name, seq, qual in reads:
        records += [SamRecord(qname=f"{name}_t", seq=seq, qual=qual),
                    SamRecord(qname=f"{name}_c", seq=reverse_complement(seq), qual=qual[::-1])]
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("".join(f"{n}_t {n}_c\n" for n, _, _ in reads))
    outs = {}
    for fmt, cls in (("cram", cram.CramWriter), ("bam", BamWriter)):
        path = tmp_path / f"pairs.{fmt}"
        with open(path, "wb") as fh:
            w = cls(fh, SamHeader())
            for r in records:
                w.write(r)
            w.close()
        outs[fmt] = tmp_path / f"duplex_{fmt}.sam"
        assert main(["duplex", "basespace", str(path), "--pairs", str(pairs), "--emit-sam",
                     "-o", str(outs[fmt])]) == 0
    assert outs["cram"].read_text() == outs["bam"].read_text()
    assert outs["cram"].read_text().count("dx:i:1") == len(reads)


def test_polish_and_variant_alignments_read_cram(tmp_path):
    """The polish and variant commands' ``_collect_alignments`` over a CRAM
    of aligned reads (non-reference, as ``CramWriter`` without ``ref_seqs``
    writes it) gives the alignments of its BAM and of its SAM."""
    draft, _, reads = polish_inputs(12, 5000, 10, (800, 1500), error=0.03, draft_error=0.0)
    ref = write_fasta(tmp_path / "draft.fa", [("ctg", draft)])
    fastq = write_fastq(tmp_path / "reads.fastq", reads)
    sam = tmp_path / "aligned.sam"
    assert main(["aligner", str(ref), str(fastq), "--emit-sam", "-o", str(sam)]) == 0
    text, records = read_records(sam)
    header = SamHeader()
    header.references = [("ctg", len(draft))]
    paths = {"sam": sam}
    for fmt, cls in (("cram", cram.CramWriter), ("bam", BamWriter)):
        paths[fmt] = tmp_path / f"aligned.{fmt}"
        with open(paths[fmt], "wb") as fh:
            w = cls(fh, header)
            for r in records:
                w.write(r)
            w.close()
    got = {}
    for fmt, path in paths.items():
        args = Namespace(reads=str(path), draft=str(ref), min_mapq=0, rg=None,
                         ignore_read_groups=False, threads=1)
        by_contig = cli_module._collect_alignments(args)
        got[fmt] = {c: [(a.ref_start, a.cigar, a.seq, a.is_reverse, a.qname, a.mapq)
                        for a in alns] for c, alns in by_contig.items()}
    assert got["cram"] == got["bam"] == got["sam"] and len(got["cram"]["ctg"]) >= 8
