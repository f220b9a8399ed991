"""The port's commands against the JAX package's: ``basecaller`` with
``--kit-name --trim all --estimate-poly-a --sample-sheet --emit-summary``
(and with a custom arrangement, ``--barcode-both-ends``, custom primers and a
poly(A) TOML) on the narrow random model and white-noise reads, as
``tests/test_torch_cli.py`` runs it, holding the header's barcode read
groups, BC, the RG suffix, pt/pa, the trimmed records and the summary's
barcode columns; ``demux`` (classified and trimmed, ``--no-classify``,
``--no-trim``, ``--sort-bam`` with its ``.bai``, ``--emit-summary``, a
sample sheet, ``--max-reads``, ``--read-ids``, a folder with ``-r``) and
``trim`` (BAM, SAM and FASTQ out, ``--no-trim-primers``, custom primers) on
a BAM of planted barcoded reads, comparing the decoded records of each
output file; and the cases where they exit with 1.

A random model calls no barcode, so both pipelines' stitched calls are
replaced, the same way in both, by planted ones (the adapter, an
SQK-NBD114-24 or custom barcode at each end, the PCS110 primers) chosen
from the call's own bases."""

import dataclasses
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import dorado_tpu.demux.adapters as jax_adapters
import dorado_tpu.demux.barcoder as jax_barcoder
import dorado_tpu.pipeline.basecaller as jax_pipeline_module
from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.io.bam_reader import read_records as jax_read_records
from dorado_tpu.models.load import save_lstm_params as jax_save_lstm_params
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
import dorado_tpu_torch.pipeline.basecaller as port_pipeline_module
from dorado_tpu_torch.cli.main import main
from dorado_tpu_torch.demux.adapters import ADAPTERS, PRIMERS
from dorado_tpu_torch.demux.custom_kit import parse_custom_arrangement, parse_custom_sequences
from dorado_tpu_torch.io.bam_reader import read_records
from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamTag, SamWriter
from dorado_tpu_torch.models.presets import config_toml, hac_v43_config
from dorado_tpu_torch.utils.sequence import reverse_complement
from tests.test_torch_demux import write_custom_kit
from tests.test_torch_runner import _narrow_hac, assert_qstrings_close, jax_params_with_moves
from tests.torch_cram import rr_cram
from tests.torch_demux import barcoded_read, planted_records, random_seq
from tests.torch_pod5_writer import make_reads, run_info, write_pod5

COMMON = ["-c", "1200", "-b", "8", "--emit-moves"]
KIT = "SQK-NBD114-24"
SSP, VNP = PRIMERS["PCS110"]
SHEET = ("experiment_id,kit,flow_cell_id,position_id,barcode,alias,type\n"
         + "".join(f"exp3,SQK-NBD114-24,FAB00003,X4,barcode{i:02d},donor_{i},test_sample\n"
                   for i in range(1, 13)))


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def jax_registries(monkeypatch):
    """The JAX package's process-wide custom barcode and primer registries,
    emptied for one test and restored after it."""
    monkeypatch.setattr(jax_barcoder, "_custom_barcodes", {})
    monkeypatch.setattr(jax_adapters, "_custom_primers", {})


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("demux_cli")
    model = d / "dna_r10.4.1_e8.2_400bps_hac@v4.3.0"
    model.mkdir()
    (model / "config.toml").write_text(config_toml(_narrow_hac(hac_v43_config())))
    jax_save_lstm_params(_narrow_hac(jax_hac_config()), jax_params_with_moves(2), model)
    data = d / "pod5"
    data.mkdir()
    info = {**run_info(3), "experiment_name": "exp3"}  # a name a sample sheet can hold
    write_pod5(data / "calls.pod5",
               make_reads(7, [3000, 890, 5200, 4100, 2500], [info], noise=True), [info])
    sheet = d / "sheet.csv"
    sheet.write_text(SHEET)
    return model, data, sheet


def planter(kit_info=None, custom=None, kit=KIT):
    """A ``stitch_chunks`` wrapper for both pipelines: a call with room for
    it becomes a planted read of as many bases as it had moves less 20,
    its barcode, bases, qualities and moves drawn from a seed of its own
    sequence, so that equal calls stay equal."""
    from dorado_tpu.signal.stitch import stitch_chunks as jax_stitch
    from dorado_tpu_torch.signal.stitch import stitch_chunks as port_stitch

    def plant(res):
        n = len(res.moves) - 20
        rng = np.random.RandomState(zlib.crc32(res.seq.encode()))
        info = kit_info or jax_barcoder.get_kit_info(kit)
        core = barcoded_read(rng, kit, info["barcodes"][rng.randint(4)], 0, custom=custom,
                             kit_info=kit_info)
        half = len(core) // 2
        head = ADAPTERS["LSK110"][0] + core[:half] + SSP
        tail = reverse_complement(VNP) + core[half:] + ADAPTERS["LSK110"][1]
        if n < len(head) + len(tail) + 50:
            return res
        seq = head + random_seq(rng, n - len(head) - len(tail)) + tail
        moves = np.zeros(len(res.moves), np.uint8)
        moves[np.sort(rng.choice(np.arange(1, len(moves)), n - 1, replace=False))] = 1
        moves[0] = 1
        qstring = "".join(chr(33 + q) for q in rng.randint(8, 35, n))
        return dataclasses.replace(res, seq=seq, qstring=qstring, moves=moves)

    return (lambda *a, **k: plant(jax_stitch(*a, **k)),
            lambda *a, **k: plant(port_stitch(*a, **k)))


@pytest.fixture
def planted_calls(monkeypatch):
    def use(**kw):
        jax_fn, port_fn = planter(**kw)
        monkeypatch.setattr(jax_pipeline_module, "stitch_chunks", jax_fn)
        monkeypatch.setattr(port_pipeline_module, "stitch_chunks", port_fn)
    return use


def assert_same_records(ref, out, qual_close=False):
    """Names, sequences, flags and every tag equal; ``qs`` within 1% and
    the qualities a step apart at most where ``qual_close``."""
    assert [r.qname for r in out] == [r.qname for r in ref]
    counts = [0, 0]
    for a, b in zip(ref, out):
        assert (b.seq, b.flag) == (a.seq, a.flag)
        if qual_close:
            assert_qstrings_close(b.qual, a.qual, counts)
        else:
            assert b.qual == a.qual
        assert [t.tag for t in b.tags] == [t.tag for t in a.tags]
        for ta, tb in zip(a.tags, b.tags):
            if ta.tag == "qs" and qual_close:
                assert float(tb.value) == pytest.approx(float(ta.value), rel=1e-2)
            elif isinstance(ta.value, np.ndarray):
                np.testing.assert_array_equal(tb.value, ta.value)
            else:
                assert (tb.type, tb.value, tb.subtype) == (ta.type, ta.value, ta.subtype), ta.tag
    assert counts[0] <= 0.01 * max(counts[1], 1)


def summary_rows(path: Path, columns=("read_id", "sequence_length_template", "alias", "type",
                                      "barcode_arrangement", "barcode_kit", "barcode_variant")):
    lines = path.read_text().splitlines()
    head = lines[0].split("\t")
    idx = [head.index(c) for c in columns]
    return [[row.split("\t")[i] for i in idx] for row in lines[1:]]


def test_basecaller_barcoding_matches_jax_cli(inputs, tmp_path, planted_calls):
    model, data, sheet = inputs
    planted_calls()
    extra = ["--kit-name", KIT, "--trim", "all", "--estimate-poly-a", "--sample-sheet",
             str(sheet), "--emit-summary", "--emit-sam"]
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    assert jax_main(["basecaller", str(model), str(data), *COMMON, *extra, "--dtype",
                     "float32", "-x", "cpu", "-o", str(tmp_path / "j" / "calls.sam")]) == 0
    assert main(["basecaller", str(model), str(data), *COMMON, *extra, "-x", "cpu",
                 "-o", str(tmp_path / "p" / "calls.sam")]) == 0
    jhead, ref = jax_read_records(tmp_path / "j" / "calls.sam")
    phead, out = read_records(tmp_path / "p" / "calls.sam")
    rgs = [line for line in phead.splitlines() if line.startswith("@RG")]
    assert rgs == [line for line in jhead.splitlines() if line.startswith("@RG")]
    assert len(rgs) == 1 + 12 and "ID:run-3_dna_r10.4.1_e8.2_400bps_hac@v4.3.0_donor_4" in phead
    assert_same_records(ref, out, qual_close=True)
    tags = [{t.tag: t.value for t in r.tags} for r in out]
    bcs = [t["BC"] for t in tags]
    assert sum(bc.startswith("donor_") for bc in bcs) >= 3 and "unclassified" in bcs
    for t in tags:
        assert t["RG"].endswith("_" + t["BC"]) == (t["BC"] != "unclassified")
        assert isinstance(t["pt"], int) and len(t["pa"]) == 5
    # the planted adapters are cut from every record (SQK-NBD114-24 lists no
    # primers, so the primers stay)
    assert not any(ADAPTERS["LSK110"][0] in r.seq for r in out)
    assert sum(SSP in r.seq for r in out) >= 3
    assert summary_rows(tmp_path / "p" / "sequencing_summary.txt") == summary_rows(
        tmp_path / "j" / "sequencing_summary.txt")
    assert summary_rows(tmp_path / "p" / "sequencing_summary.txt")[0][2].startswith(
        ("donor_", "unclassified"))


def test_basecaller_custom_arrangement_matches_jax_cli(inputs, tmp_path, planted_calls,
                                                       jax_registries):
    model, data, _ = inputs
    toml, fasta = write_custom_kit(tmp_path)
    name, info = parse_custom_arrangement(toml)
    planted_calls(kit_info=info, custom=parse_custom_sequences(fasta), kit=name)
    primers = tmp_path / "primers.fasta"
    primers.write_text(f">SSP_FWD\n{SSP}\n")
    polya = tmp_path / "polya.toml"
    polya.write_text('[threshold]\nflank_threshold = 0.5\n[[overrides]]\nbarcode_id = "CK12_barcode02"'
                     '\n[overrides.status]\nenabled = false\n')
    extra = ["--barcode-arrangement", str(toml), "--barcode-sequences", str(fasta),
             "--barcode-both-ends", "--trim", "primers", "--primer-sequences", str(primers),
             "--estimate-poly-a", "--poly-a-config", str(polya), "--emit-sam"]
    ours, theirs = tmp_path / "ours.sam", tmp_path / "theirs.sam"
    assert jax_main(["basecaller", str(model), str(data), *COMMON, *extra, "--dtype",
                     "float32", "-x", "cpu", "-o", str(theirs)]) == 0
    assert main(["basecaller", str(model), str(data), *COMMON, *extra, "-x", "cpu",
                 "-o", str(ours)]) == 0
    jhead, ref = jax_read_records(theirs)
    phead, out = read_records(ours)
    assert [l for l in phead.splitlines() if l.startswith("@RG")] == [
        l for l in jhead.splitlines() if l.startswith("@RG")]
    assert "BC:" in phead and "bk:custom_kit" in phead
    assert_same_records(ref, out, qual_close=True)
    bcs = [next(t.value for t in r.tags if t.tag == "BC") for r in out]
    assert sum(bc.startswith("CK12_barcode") for bc in bcs) >= 2
    # the disabled override leaves its barcode's reads without pt and pa, and
    # with overrides an unclassified read gets no estimate either
    for r, bc in zip(out, bcs):
        assert any(t.tag == "pt" for t in r.tags) == (bc not in ("CK12_barcode02",
                                                                 "unclassified"))


def test_basecaller_options_parse_and_trim_values(inputs):
    model, data, _ = inputs
    for value in ("all", "adapters", "primers", "none"):
        assert main(["basecaller", str(model), str(data), "--trim", value, "-x", "cpu",
                     "--max-reads", "0", "-o", "/dev/null"]) == 0
    assert main(["basecaller", str(model), str(data), "--rna-adapters", "-x", "cpu",
                 "--max-reads", "0", "-o", "/dev/null"]) == 0
    with pytest.raises(SystemExit) as exc:
        main(["basecaller", str(model), str(data), "--trim", "barcodes", "-x", "cpu"])
    assert exc.value.code == 2


# ---- demux and trim ----------------------------------------------------------------


@pytest.fixture(scope="module")
def reads_bam(tmp_path_factory):
    """A BAM of 40 planted SQK-NBD114-24 reads of 300-1500 bases at 5% errors
    (a tenth unbarcoded, some with a BC tag already), the same as SAM and
    FASTQ, and a folder holding part of them as BAM and the rest as FASTQ in
    a subfolder."""
    d = tmp_path_factory.mktemp("demux_reads")
    records, truth = planted_records(3, KIT, 40, lengths=(300, 1501))
    for i, rec in enumerate(records[:10]):
        rec.tags.append(SamTag("BC", "Z", "NB24_barcode0" + str(i % 3 + 1)))
    header = SamHeader(comments=["planted reads"])
    with open(d / "reads.bam", "wb") as fh:
        w = BamWriter(fh, header)
        for rec in records:
            w.write(rec)
        w.close()
    with open(d / "reads.sam", "w") as fh:
        w = SamWriter(fh, header)
        for rec in records:
            w.write(rec)
    (d / "reads.fastq").write_text("".join(f"@{r.qname} x\n{r.seq}\n+\n{r.qual}\n"
                                           for r in records))
    folder = d / "folder"
    (folder / "sub").mkdir(parents=True)
    with open(folder / "part.bam", "wb") as fh:
        w = BamWriter(fh, header)
        for rec in records[:25]:
            w.write(rec)
        w.close()
    (folder / "sub" / "rest.fq").write_text("".join(f"@{r.qname}\n{r.seq}\n+\n{r.qual}\n"
                                                   for r in records[25:]))
    return d, truth


def outputs(path: Path, reader):
    """{file name: decoded records} of each BAM in ``path``, the .bai files'
    names and the barcoding summary's text."""
    got = {p.name: reader(p)[1] for p in sorted(path.glob("*.bam"))}
    bai = sorted(p.name for p in path.glob("*.bai"))
    summary = path / "barcoding_summary.txt"
    return got, bai, summary.read_text() if summary.exists() else None


@pytest.mark.parametrize("case", ["classify", "no-trim", "no-classify", "sort-summary-sheet",
                                  "fastq-limits", "folder", "folder-recursive", "custom"])
def test_demux_matches_jax(reads_bam, tmp_path, case, jax_registries):
    d, truth = reads_bam
    sheet = tmp_path / "sheet.csv"
    sheet.write_text(SHEET)
    ids = tmp_path / "ids.txt"
    ids.write_text("read-00003\nread-00011\nread-00017\nread-00030\nread-00031\n")
    reads, kit = str(d / "reads.bam"), ["--kit-name", KIT]
    extra = {
        "classify": [],
        "no-trim": ["--no-trim", "--barcode-both-ends"],
        "no-classify": ["--no-classify"],
        "sort-summary-sheet": ["--sort-bam", "--emit-summary", "--sample-sheet", str(sheet)],
        "fastq-limits": ["--max-reads", "4", "--read-ids", str(ids), "--emit-summary"],
        "folder": [],
        "folder-recursive": ["-r", "--emit-summary"],
        "custom": [],
    }[case]
    if case == "no-classify":
        kit = []
    if case == "fastq-limits":
        reads = str(d / "reads.fastq")
    if case.startswith("folder"):
        reads = str(d / "folder")
    if case == "custom":
        toml, fasta = write_custom_kit(tmp_path)
        kit = ["--barcode-arrangement", str(toml), "--barcode-sequences", str(fasta)]
    args = ["demux", reads, *kit, *extra]
    assert jax_main([*args, "--output-dir", str(tmp_path / "j")]) == 0
    assert main([*args, "--output-dir", str(tmp_path / "p")]) == 0
    got, got_bai, got_summary = outputs(tmp_path / "p", read_records)
    want, want_bai, want_summary = outputs(tmp_path / "j", jax_read_records)
    assert sorted(got) == sorted(want) and got_bai == want_bai
    for name in want:
        assert_same_records(want[name], got[name])
    assert got_summary == want_summary
    n = sum(len(v) for v in got.values())
    if case == "classify":
        # the planted truth: most barcoded reads called right, trimmed
        called = {r.qname: name[:-4] for name, recs in got.items() for r in recs}
        right = sum(called[f"read-{i:05d}"] == f"NB24_barcode{t[2:]}"
                    for i, t in enumerate(truth) if t)
        assert right >= 0.85 * sum(t is not None for t in truth) and n == 40
        assert "unclassified.bam" in got
        trimmed = got["NB24_barcode" + truth[0][2:] + ".bam"][0]
        assert next(t for t in trimmed.tags if t.tag == "BC").value == called[trimmed.qname]
    if case == "no-classify":
        assert sorted(got) == ["NB24_barcode01.bam", "NB24_barcode02.bam",
                               "NB24_barcode03.bam", "unclassified.bam"]
    if case == "sort-summary-sheet":
        assert got_bai and any(name.startswith("donor_") for name in got)
        assert "donor_" in got_summary
    if case == "fastq-limits":
        assert n == 4
    if case == "folder":
        assert n == 25
    if case == "folder-recursive":
        assert n == 40
    if case == "custom":
        assert sorted(got) == ["unclassified.bam"]


@pytest.mark.parametrize("case", ["no-kit", "cram", "empty-folder"])
def test_demux_exits_1(tmp_path, capsys, case, reads_bam):
    d, _ = reads_bam
    reads = {"no-kit": str(d / "reads.bam"), "cram": str(tmp_path / "x.cram"),
             "empty-folder": str(tmp_path / "empty")}[case]
    rr_cram(tmp_path / "x.cram")  # reference-based: no reader is given its contig
    (tmp_path / "empty").mkdir()
    extra = ["--kit-name", KIT] if case != "no-kit" else []
    assert main(["demux", reads, *extra, "--output-dir", str(tmp_path / "o")]) == 1
    err = capsys.readouterr().err
    assert {"no-kit": "demux requires --kit-name",
            "cram": "RR=true slice needs ref_seqs['ctg'] to decode",
            "empty-folder": "No read files found"}[case] in err
    if case == "no-kit":
        with capsys.disabled():  # the JAX command enables faulthandler on the real stderr
            assert jax_main(["demux", reads, "--output-dir", str(tmp_path / "j")]) == 1


@pytest.fixture(scope="module")
def trim_bam(tmp_path_factory):
    """A BAM of 24 reads with the LSK110 adapters and the PCS110 or cDNA
    primers at their ends (some with neither), a move table and qualities."""
    d = tmp_path_factory.mktemp("trim_reads")
    records, _ = planted_records(5, KIT, 24, lengths=(200, 801), unbarcoded=1.0)
    rng = np.random.RandomState(6)
    for i, rec in enumerate(records):
        front, rear = PRIMERS["PCS110" if i % 2 else "cDNA"]
        if i % 5 == 4:
            continue
        rec.seq = (ADAPTERS["LSK110"][0] + front + rec.seq + reverse_complement(rear)
                   + ADAPTERS["LSK110"][1])
        rec.qual = "".join(chr(33 + q) for q in rng.randint(5, 40, len(rec.seq)))
        rec.tags = [t for t in rec.tags if t.tag != "mv"]
    with open(d / "reads.bam", "wb") as fh:
        w = BamWriter(fh, SamHeader())
        for rec in records:
            w.write(rec)
        w.close()
    return d / "reads.bam"


@pytest.mark.parametrize("case", ["bam", "sam", "fastq", "no-primers", "custom-primers",
                                  "limits"])
def test_trim_matches_jax(trim_bam, tmp_path, case, jax_registries):
    (tmp_path / "primers.fasta").write_text(f">MY_SSP\n{PRIMERS['cDNA'][0]}\n")
    (tmp_path / "ids.txt").write_text("read-00002\nread-00005\nread-00009\n")
    extra, fmt = {
        "bam": (["--kit-name", "SQK-PCS114"], "bam"),
        "sam": (["--emit-sam"], "sam"),
        "fastq": (["--emit-fastq", "--sequencing-kit", "SQK-LSK114"], "fastq"),
        "no-primers": (["--no-trim-primers", "--emit-sam"], "sam"),
        "custom-primers": (["--primer-sequences", str(tmp_path / "primers.fasta"),
                            "--emit-sam"], "sam"),
        "limits": (["--read-ids", str(tmp_path / "ids.txt"), "--max-reads", "2",
                    "--emit-sam"], "sam"),
    }[case]
    ours, theirs = tmp_path / f"ours.{fmt}", tmp_path / f"theirs.{fmt}"
    assert jax_main(["trim", str(trim_bam), *extra, "-o", str(theirs)]) == 0
    assert main(["trim", str(trim_bam), *extra, "-o", str(ours)]) == 0
    if fmt == "fastq":
        assert ours.read_text() == theirs.read_text()
        return
    _, want = jax_read_records(theirs)
    _, got = read_records(ours)
    assert_same_records(want, got)
    _, before = read_records(trim_bam)
    cut = sum(len(a.seq) < len(b.seq) for a, b in zip(got, before))
    assert cut >= {"limits": 1}.get(case, 10)
    if case == "limits":
        assert [r.qname for r in got] == ["read-00002", "read-00005"]


def test_trim_rejects_rna_and_cram(trim_bam, tmp_path, capsys):
    """``--rna`` is accepted and, as in the JAX command, which never reads
    it, changes nothing; a reference-based CRAM exits 1 naming its contig."""
    assert main(["trim", str(trim_bam), "--rna", "-o", str(tmp_path / "rna.bam")]) == 0
    assert main(["trim", str(trim_bam), "-o", str(tmp_path / "dna.bam")]) == 0
    rna, dna = (read_records(tmp_path / f"{x}.bam")[1] for x in ("rna", "dna"))
    assert [r.to_sam_line() for r in rna] == [r.to_sam_line() for r in dna] and len(rna) == 24
    rr_cram(tmp_path / "x.cram")
    assert main(["trim", str(tmp_path / "x.cram"), "-o", str(tmp_path / "o.bam")]) == 1
    assert "RR=true slice needs ref_seqs['ctg'] to decode" in capsys.readouterr().err
