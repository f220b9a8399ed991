"""Sequencing summaries and inline alignment in the port against the JAX
package on the CPU: ``python -m dorado_tpu_torch summary`` against
``dorado_tpu.cli.main``'s on BAMs the port wrote (basecalled with
``--reference``, and the ``aligner``'s), on a folder of them, and its
refusal of a reference-based CRAM; ``summary_row`` and ``write_summary`` against the JAX
package's on the same records; and ``basecaller --reference --bed-file
--emit-summary`` (a narrow hac model, ``-x cpu``, the white-noise reads of
``tests/test_torch_cli.py``) against the JAX command: the same records
(alignment fields, NM, AS and bh equal; quality strings and ``qs`` within
``test_torch_cli``'s bounds) and the same summary rows (``qs`` within 1%).
The reference is cut from the reads the port calls without one, a contig
reverse-complemented, so that records map to both strands."""

import random

import numpy as np
import pytest
import torch

from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.io import sam as jax_sam
from dorado_tpu.io import summary as jax_summary
from dorado_tpu.io.bam_reader import read_records as jax_read_records
from dorado_tpu_torch.cli.main import main as torch_main
from dorado_tpu_torch.io import sam, summary
from dorado_tpu_torch.io.bam_reader import read_records
from tests.test_torch_cli import COMMON, _assert_records_match, inputs  # noqa: F401
from tests.torch_cram import rr_cram
from tests.torch_polish import revcomp, write_fasta

QS_COLUMN = "mean_qscore_template"


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):  # noqa: F811
    """A FASTA of three of the reads the port calls (the second reverse
    complemented, the third trimmed) and a BED over it."""
    model, data = inputs
    d = tmp_path_factory.mktemp("summary")
    plain = d / "plain.sam"
    assert torch_main(["basecaller", str(model), str(data), *COMMON, "--emit-sam", "-x", "cpu",
                       "-o", str(plain)]) == 0
    seqs = [r.seq for r in read_records(plain)[1] if len(r.seq) > 200]
    assert len(seqs) >= 3
    ref = write_fasta(d / "ref.fa", [("c0", seqs[0]), ("c1", revcomp(seqs[1])),
                                     ("c2", seqs[2][20:])])
    bed = d / "ref.bed"
    bed.write_text("c0\t0\t100\ta\t0\t+\nc1\t10\t400\tb\t0\t.\nc2\t5\t50\tc\t0\t-\n")
    return {"dir": d, "plain": plain, "ref": ref, "bed": bed}


def _rows(text: str) -> list[dict]:
    lines = text.splitlines()
    columns = lines[0].split("\t")
    return [dict(zip(columns, line.split("\t"))) for line in lines[1:]]


def assert_rows_match(got: str, want: str, n_rows: int, qs_rel: float = 1e-2) -> None:
    """Equal columns and rows, but ``qs`` within ``qs_rel`` (1%: the two
    frameworks' float32 sums)."""
    assert got.splitlines()[0] == want.splitlines()[0]
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w) == n_rows
    for a, b in zip(g, w):
        assert float(a.pop(QS_COLUMN)) == pytest.approx(float(b.pop(QS_COLUMN)), rel=qs_rel)
        assert a == b


@pytest.fixture(scope="module")
def aligned(inputs, reference):  # noqa: F811
    """Both basecallers with --reference, --bed-file and --emit-summary, each
    into a directory of its own: {who: (SAM, sequencing_summary.txt)}."""
    model, data = inputs
    outs = {}
    for who, main, extra in (("jax", jax_main, ["--dtype", "float32"]), ("torch", torch_main, [])):
        out_dir = reference["dir"] / who
        out_dir.mkdir()
        assert main(["basecaller", str(model), str(data), *COMMON, "--emit-sam", *extra,
                     "--reference", str(reference["ref"]), "--bed-file", str(reference["bed"]),
                     "--emit-summary", "-x", "cpu", "-o", str(out_dir / "calls.sam")]) == 0
        outs[who] = (out_dir / "calls.sam", out_dir / "sequencing_summary.txt")
    return outs


def test_basecaller_reference_matches_jax(aligned, reference):
    (want_sam, _), (got_sam, _) = aligned["jax"], aligned["torch"]
    want_header, want = jax_read_records(want_sam)
    got_header, got = read_records(got_sam)
    sq = [line for line in got_header.splitlines() if line.startswith("@SQ")]
    assert sq == [line for line in want_header.splitlines() if line.startswith("@SQ")]
    assert len(sq) == 3
    _assert_records_match(want, got)
    for a, b in zip(want, got):
        assert (b.rname, b.pos, b.mapq, b.cigar) == (a.rname, a.pos, a.mapq, a.cigar)
    # the narrow random model calls short-period repeats on white noise, which
    # the mapper places for one read (on the reverse-complemented contig)
    mapped = [r for r in got if not r.flag & 4]
    assert mapped and len(mapped) < len(got) and any(r.flag & 16 for r in mapped)
    assert all({"NM", "AS", "bh"} <= {t.tag for t in r.tags} for r in mapped)
    assert any(next(t.value for t in r.tags if t.tag == "bh") for r in mapped)
    # the records but for the alignment are the run's without a reference
    plain = read_records(reference["plain"])[1]
    assert [r.qname for r in got] == [r.qname for r in plain]
    for a, b in zip(plain, got):
        seq, qual = (revcomp(b.seq), b.qual[::-1]) if b.flag & 16 else (b.seq, b.qual)
        assert (seq, qual) == (a.seq, a.qual)
        assert _tags(b, ("NM", "AS", "bh")) == _tags(a)


def _tags(rec, drop=()) -> list[tuple]:
    return [(t.tag, t.type, np.asarray(t.value).tolist() if t.type == "B" else t.value,
             t.subtype) for t in rec.tags if t.tag not in drop]


def test_emit_summary_matches_jax(aligned):
    got = aligned["torch"][1].read_text()
    assert_rows_match(got, aligned["jax"][1].read_text(), 5)
    assert "alignment_genome" in got.splitlines()[0]
    assert {row["alignment_genome"] for row in _rows(got)} > {"*"}


def _summary(capfd, main, path, *extra):
    capfd.readouterr()
    rc = main(["summary", str(path), *extra])
    out = capfd.readouterr()
    return rc, out.out, out.err


def test_summary_of_a_port_bam_matches_jax(capfd, aligned, inputs, reference,  # noqa: F811
                                           tmp_path):
    """The summary of the port's BAM (basecalled with --reference) equals the
    JAX command's, and the basecaller's own --emit-summary rows (``qs`` to
    float32 rounding)."""
    model, data = inputs
    bam = tmp_path / "calls.bam"
    assert torch_main(["basecaller", str(model), str(data), *COMMON, "--reference",
                       str(reference["ref"]), "--bed-file", str(reference["bed"]), "-x", "cpu",
                       "-o", str(bam)]) == 0
    rc, text, err = _summary(capfd, torch_main, bam)
    assert (rc, text) == _summary(capfd, jax_main, bam)[:2] and rc == 0
    assert "> Summarised 5 reads" in err
    # the BAM holds qs as a float32, the emitted rows the record's float
    assert_rows_match(text, aligned["torch"][1].read_text(), 5, qs_rel=1e-6)


def test_summary_of_aligner_output_and_folders(capfd, reference, tmp_path):
    """The aligner's sorted BAM (secondary records skipped), then a folder of
    a BAM and a SAM, searched with -r; a reference-based CRAM (no reader is
    given its contig, as in JAX) and an empty folder exit 1."""
    folder = tmp_path / "runs"
    (folder / "sub").mkdir(parents=True)
    bam = folder / "aligned.bam"
    assert torch_main(["aligner", str(reference["ref"]), str(reference["plain"]),
                       "-o", str(bam)]) == 0
    (folder / "sub" / "plain.sam").write_text(reference["plain"].read_text())
    for path, extra in ((bam, []), (folder, []), (folder, ["-r"])):
        rc, text, _ = _summary(capfd, torch_main, path, *extra)
        assert rc == 0 and (rc, text) == _summary(capfd, jax_main, path, *extra)[:2]
    assert len(text.splitlines()) == 11  # the header and 5 reads from each file
    cram = tmp_path / "x.cram"
    rr_cram(cram)
    rc, _, err = _summary(capfd, torch_main, cram)
    assert rc == 1 and "RR=true slice needs ref_seqs['ctg'] to decode" in err
    (tmp_path / "empty").mkdir()
    assert _summary(capfd, torch_main, tmp_path / "empty")[0] == 1
    assert _summary(capfd, jax_main, tmp_path / "empty")[0] == 1


def _record(pkg, rng, i):
    """A record with the tags the summary reads, mapped or not, split or
    not, barcoded or not, secondary now and then."""
    mapped = rng.random() < 0.7
    tags = [pkg.SamTag("du", "f", rng.uniform(0.1, 5.0)), pkg.SamTag("ns", "i", 5000 + i),
            pkg.SamTag("ts", "i", rng.randrange(0, 100)), pkg.SamTag("qs", "f", 11.5),
            pkg.SamTag("ch", "i", i), pkg.SamTag("RG", "Z", "run1_model"),
            pkg.SamTag("fn", "Z", "a.pod5"), pkg.SamTag("NM", "i", rng.randrange(0, 9)),
            pkg.SamTag("AS", "i", 100), pkg.SamTag("bh", "i", i % 3)]
    if i % 4 == 0:
        tags.append(pkg.SamTag("pi", "Z", "parent"))
    if i % 5 == 0:
        tags.append(pkg.SamTag("BC", "Z", "barcode01"))
    if i % 6 == 0:
        tags.append(pkg.SamTag("mv", "B", [5, 1, 0, 1], subtype="c"))
    return pkg.SamRecord(
        qname=f"r{i}", flag=(0x100 if i % 7 == 0 else 0) | (16 if i % 2 else 0)
        if mapped else 4, rname="c0" if mapped else "*", pos=rng.randrange(1, 500) if mapped
        else 0, mapq=rng.randrange(0, 61), cigar="5S20M2I30M3D10M4S" if mapped else "*",
        seq="A" * 71, qual="I" * 71, tags=tags)


@pytest.mark.parametrize("stride", [0, 6])
def test_summary_rows_equal(stride):
    header = "@RG\tID:run1_model\tDS:runid=run1 basecall_model=model\n"
    rng_a, rng_b = random.Random(5), random.Random(5)
    got_recs = [_record(sam, rng_a, i) for i in range(40)]
    want_recs = [_record(jax_sam, rng_b, i) for i in range(40)]
    assert summary._parse_rg_run_ids(header) == jax_summary._parse_rg_run_ids(header)
    for a, b in zip(got_recs, want_recs):
        for flags in ((False, False), (True, True)):
            assert summary.summary_row(a, *flags, {"run1_model": "run1"}, stride) == (
                jax_summary.summary_row(b, *flags, {"run1_model": "run1"}, stride))
    import io

    got, want = io.StringIO(), io.StringIO()
    n = summary.write_summary(got_recs, got, header, stride)
    assert n == jax_summary.write_summary(want_recs, want, header, stride) and n < 40
    assert got.getvalue() == want.getvalue()
    assert summary.summary_columns(True, False) == jax_summary.summary_columns(True, False)
