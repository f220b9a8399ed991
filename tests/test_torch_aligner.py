"""The alignment surface of the port against the JAX package's on the CPU:
the BED reader (``alignment/bed_file.py``), the BAI index (``io/bai.py``:
bins, linear index and region queries), the sorted BAM writer
(``io/sorted_bam.py``, in memory and spilling to disk), ``fetch_region``
through the .bai, and ``python -m dorado_tpu_torch aligner`` against
``dorado_tpu.cli.main``'s in process: SAM text and BAM records, header and
index equal (but for ``@PG``), for FASTQ, BAM and folder input, secondary
records, ``--allow-sec-supp``, ``--bed-file``, ``--mm2-opts``,
``--max-reads`` and ``--no-sort``; ``-o x.cram`` writes a reference-based
CRAM, as the JAX command does, which no command reads back without its
reference (exit code 1)."""

import bisect
import random
import struct

import numpy as np
import pytest

from dorado_tpu.alignment import bed_file as jax_bed
from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.io import bai as jax_bai
from dorado_tpu.io import bam_reader as jax_reader
from dorado_tpu.io import sam as jax_sam
from dorado_tpu.io import sorted_bam as jax_sorted
from dorado_tpu_torch.alignment import bed_file
from dorado_tpu_torch.cli.main import main as torch_main
from dorado_tpu_torch.io import bai, bam_reader, sam, sorted_bam
from dorado_tpu_torch.io.bgzf import BgzfRandomReader
from tests.torch_polish import polish_inputs, revcomp, write_fasta, write_fastq

BED_FILES = {
    "basic": "browser position chr1\ntrack name=test\n# comment\n\nctg1\t100\t200\n"
             "ctg1\t300\t400\nctg2\t0\t50\n",
    "stranded": "ctg1\t10\t90\tfeat\t0\t+\nctg1\t10\t90\tfeat\t0\t-\nctg1\t50\t900\tf\t0\t.\n",
    "too_few": "ctg\t10\n",
    "inconsistent": "ctg\t10\t20\nctg\t10\t20\tname\n",
    "bad_start": "ctg\tx\t20\n",
    "bad_strand": "ctg\t1\t20\tn\t0\t*\n",
    "too_many": "ctg\t1\t2" + "\tx" * 10 + "\n",
    "late_track": "ctg1\t1\t5\ntrack x\n",
}


def _fields(rec) -> tuple:
    tags = tuple((t.tag, t.type, np.asarray(t.value).tolist() if t.type == "B" else t.value,
                  t.subtype) for t in rec.tags)
    return (rec.qname, rec.flag, rec.rname, rec.pos, rec.mapq, rec.cigar, rec.rnext,
            rec.pnext, rec.tlen, rec.seq, rec.qual, tags)


@pytest.mark.parametrize("name", sorted(BED_FILES))
def test_bed_file(tmp_path, name):
    path = tmp_path / f"{name}.bed"
    path.write_text(BED_FILES[name])
    try:
        want = jax_bed.BedFile.load(path)
    except jax_bed.BedFileError as exc:
        with pytest.raises(bed_file.BedFileError, match="Invalid BED line") as got:
            bed_file.BedFile.load(path)
        assert str(got.value) == str(exc)
        return
    got = bed_file.BedFile.load(path)
    assert {k: [vars(e) for e in v] for k, v in got.entries.items()} == {
        k: [vars(e) for e in v] for k, v in want.entries.items()}
    rng = random.Random(1)
    for _ in range(200):
        beg = rng.randrange(0, 1000)
        q = (rng.choice(["ctg1", "ctg2", "ctg3"]), beg, beg + rng.randrange(1, 400),
             rng.random() < 0.5)
        assert got.hits(*q) == want.hits(*q)


def test_reg2bin_and_queries_equal():
    rng = random.Random(3)
    for _ in range(2000):
        beg = rng.randrange(0, 1 << 29)
        end = beg + rng.randrange(1, 1 << rng.randrange(1, 28))
        assert bai.reg2bin(beg, min(end, 1 << 29)) == jax_bai.reg2bin(beg, min(end, 1 << 29))
        assert bai.reg2bins(beg, end) == jax_bai.reg2bins(beg, end)
    for cigar in ("*", "", "10S50M3I7D20M5S", "4N6=2X1P3H"):
        assert bai.cigar_ref_span(cigar) == jax_bai.cigar_ref_span(cigar)


def _records(rng, n, refs, pkg):
    """Seeded mapped records over ``refs`` (spans of 50-5000), a few
    unmapped ones last, as ``pkg``'s SamRecord."""
    out = []
    for i in range(n):
        rname, rlen = refs[rng.randrange(len(refs))]
        span = rng.randrange(50, 5000)
        seq = "".join(rng.choice("ACGT") for _ in range(20))
        out.append(pkg.SamRecord(
            qname=f"r{i}", flag=16 * (i % 2), rname=rname,
            pos=rng.randrange(1, max(2, rlen - span)), mapq=30,
            cigar=f"10S{span}M10S" if rng.random() < 0.5 else f"{span}M", seq=seq,
            qual="I" * len(seq), tags=[pkg.SamTag("NM", "i", i % 7)]))
    out += [pkg.SamRecord(qname=f"u{i}", flag=4) for i in range(5)]
    return out


def _write_sorted(pkg_sorted, pkg_sam, path, recs, max_buffered, tmp_dir):
    header = pkg_sam.SamHeader()
    header.references = [("chr1", 1_000_000), ("chr2", 250_000)]
    with open(path, "wb") as fh:
        w = pkg_sorted.SortedBamWriter(fh, header, max_buffered=max_buffered,
                                       tmp_dir=str(tmp_dir), index_path=f"{path}.bai")
        for r in recs:
            w.write(r)
        w.close()


@pytest.mark.parametrize("max_buffered", [10_000, 37], ids=["in_memory", "spilled"])
def test_sorted_bam_and_index_equal(tmp_path, max_buffered):
    """The same records through both sorted writers (one header): the same
    decoded records and header, and the same .bai (bins with their chunks,
    the linear index, the unplaced count)."""
    refs = [("chr1", 1_000_000), ("chr2", 250_000)]
    got, want = tmp_path / "port.bam", tmp_path / "jax.bam"
    _write_sorted(sorted_bam, sam, got, _records(random.Random(7), 300, refs, sam),
                  max_buffered, tmp_path)
    _write_sorted(jax_sorted, jax_sam, want, _records(random.Random(7), 300, refs, jax_sam),
                  max_buffered, tmp_path)
    g_text, g_recs = bam_reader.read_bam(got)
    w_bam = jax_reader.read_bam(want)
    assert g_text == w_bam.header_text and "SO:coordinate" in g_text
    assert [_fields(r) for r in g_recs] == [_fields(r) for r in w_bam.records]
    assert [r.qname for r in bam_reader.iter_bam(got)] == [r.qname for r in g_recs]
    with open(f"{got}.bai", "rb") as a, open(f"{want}.bai", "rb") as b:
        g_index, w_index = bai.read_bai(a), jax_bai.read_bai(b)
    assert g_index == w_index and g_index[2] == 5


def test_fetch_region(tmp_path):
    """Region queries through the port's .bai: the records a linear scan
    finds, and the JAX package's ``fetch_region``'s on the same file."""
    refs = [("chr1", 1_000_000), ("chr2", 250_000)]
    path = tmp_path / "x.bam"
    recs = _records(random.Random(9), 400, refs, sam)
    _write_sorted(sorted_bam, sam, path, recs, 50, tmp_path)
    mapped = [r for r in recs if not r.flag & 4]
    rng = random.Random(2)
    for _ in range(30):
        rname, rlen = refs[rng.randrange(2)]
        beg = rng.randrange(0, rlen)
        end = beg + rng.randrange(1, 60_000)
        got = bam_reader.fetch_region(path, rname, beg, end)
        scan = {r.qname for r in mapped if r.rname == rname
                and r.pos - 1 < end and r.pos - 1 + bai.cigar_ref_span(r.cigar) > beg}
        assert {r.qname for r in got} == scan
        assert [_fields(r) for r in got] == [
            _fields(r) for r in jax_reader.fetch_region(path, rname, beg, end)]


# ---- the aligner command ---------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A reference of two contigs (the second repeats a reversed piece and
    the start of the first, so reads have secondary hits), 24 reads of it at
    5% errors as FASTQ, the same reads as an unaligned BAM (one of them
    flagged secondary) and as a folder of a SAM and a FASTQ, and a BED."""
    d = tmp_path_factory.mktemp("aligner")
    draft, _, reads = polish_inputs(3, 6000, 24, (800, 2000), error=0.05)
    ref = write_fasta(d / "ref.fa", [("ctg1", draft),
                                     ("ctg2", revcomp(draft[1000:3500]) + draft[:500])])
    fastq = write_fastq(d / "reads.fastq", reads)
    bed = d / "r.bed"
    bed.write_text("ctg1\t100\t2000\ta\t0\t+\nctg1\t1500\t5000\tb\t0\t-\n"
                   "ctg2\t0\t800\tc\t0\t.\n")
    records = [sam.SamRecord(qname=n, seq=s, qual=q, flag=0x100 if i == 3 else 4,
                             tags=[sam.SamTag("RG", "Z", "run_model")])
               for i, (n, s, q) in enumerate(reads)]
    header = sam.SamHeader()
    ubam = d / "reads.bam"
    with open(ubam, "wb") as fh:
        w = sam.BamWriter(fh, header)
        for r in records:
            w.write(r)
        w.close()
    folder = d / "folder"
    (folder / "sub").mkdir(parents=True)
    with open(folder / "a.sam", "w") as fh:
        w = sam.SamWriter(fh, header)
        for r in records[:10]:
            w.write(r)
    write_fastq(folder / "sub" / "b.fq", reads[10:])
    return {"dir": d, "ref": ref, "fastq": fastq, "bam": ubam, "folder": folder, "bed": bed}


def _run(main, argv, out, capfd):
    capfd.readouterr()
    rc = main([*argv, "-o", str(out)])
    return rc, capfd.readouterr().err


def _record_offsets(path) -> tuple[list[int], int]:
    """The virtual offset of each record of a BAM, and of its end."""
    with open(path, "rb") as fh:
        r = BgzfRandomReader(fh)
        assert r.seek_voffset(0) and r.read(4) == b"BAM\x01"
        r.read(struct.unpack("<i", r.read(4))[0])
        for _ in range(struct.unpack("<i", r.read(4))[0]):
            r.read(struct.unpack("<i", r.read(4))[0] + 4)
        offsets = []
        while True:
            v = r.voffset()
            raw = r.read(4)
            if len(raw) < 4:
                return offsets, v
            r.read(struct.unpack("<i", raw)[0])
            offsets.append(v)


def _index_by_record(path):
    """A .bai with each virtual offset given as the ordinal of the record it
    points at (the two commands' @PG lines differ in length, so their
    offsets do): (bins, linear index, unplaced count)."""
    offsets, _ = _record_offsets(path)

    def ordinal(v):
        # a record's start, or the end of the last record (which the writer
        # gives as an offset into the last block, the reader as the next)
        assert v in offsets or v > offsets[-1]
        return bisect.bisect_left(offsets, v)

    with open(f"{path}.bai", "rb") as fh:
        bins, linear, n_no_coor = bai.read_bai(fh)
    out_bins = {}
    for tid, by_bin in bins.items():
        out_bins[tid] = {
            b: [(ordinal(c0), ordinal(c1)) if b != 37450 or i == 0 else (c0, c1)
                for i, (c0, c1) in enumerate(chunks)]
            for b, chunks in by_bin.items()}
    return out_bins, {t: [ordinal(v) for v in ioff] for t, ioff in linear.items()}, n_no_coor


def aligner_parity(capfd, inputs, tag, argv, fmt="sam", rc=0):
    """Both commands on the CPU: equal exit codes; SAM text but @PG, or BAM
    header but @PG, decoded records and .bai by record. The port's output
    path and stderr."""
    outs = {}
    for who, main in (("jax", jax_main), ("torch", torch_main)):
        out = inputs["dir"] / f"{tag}_{who}.{fmt}"
        got, err = _run(main, [*argv, *(["--emit-sam"] if fmt == "sam" else [])], out, capfd)
        assert got == rc, err
        outs[who] = out
    if rc:
        return outs["torch"], err
    if fmt == "sam":
        texts = [[line for line in outs[w].read_text().splitlines() if not line.startswith(
            "@PG")] for w in ("jax", "torch")]
        assert texts[0] == texts[1] and len(texts[0]) > 10
    else:
        (t_text, t_recs), (j_text, j_recs) = (
            bam_reader.read_bam(outs["torch"]), bam_reader.read_bam(outs["jax"]))
        assert [l for l in t_text.splitlines() if not l.startswith("@PG")] == [
            l for l in j_text.splitlines() if not l.startswith("@PG")]
        assert [_fields(r) for r in t_recs] == [_fields(r) for r in j_recs] and len(t_recs) > 8
        if "--no-sort" not in argv:
            assert _index_by_record(outs["torch"]) == _index_by_record(outs["jax"])
    return outs["torch"], err


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_aligner_fastq(capfd, inputs, fmt):
    """FASTQ reads with a BED file: bh tags, secondary records (0x100, -N
    5 by default) and reverse-strand hits."""
    out, err = aligner_parity(capfd, inputs, f"fastq_{fmt}",
                              ["aligner", str(inputs["ref"]), str(inputs["fastq"]),
                               "--bed-file", str(inputs["bed"])], fmt)
    records = bam_reader.read_records(out)[1]
    assert any(r.flag & 0x100 for r in records) and any(r.flag & 16 for r in records)
    primary = [r for r in records if not r.flag & 0x900]
    assert len(primary) == 24 and "> Mapped 24/24 reads" in err
    tags = [{t.tag: t.value for t in r.tags} for r in primary if not r.flag & 4]
    assert all({"NM", "AS", "bh"} <= set(t) for t in tags) and any(t["bh"] for t in tags)
    if fmt == "bam":
        hits = bam_reader.fetch_region(out, "ctg1", 2000, 2500)
        assert hits and all(r.rname == "ctg1" for r in hits)


@pytest.mark.parametrize("extra", [[], ["--allow-sec-supp"], ["--max-reads", "9"],
                                   ["--mm2-opts=-k 13 -w 8 -N 2"],
                                   ["--mm2-opts=--secondary=no -x"], ["--no-sort"]],
                         ids=["default", "allow_sec_supp", "max_reads", "mm2_opts",
                              "no_secondary", "no_sort"])
def test_aligner_bam_input(capfd, inputs, extra):
    """An unaligned BAM with one record flagged secondary: dropped unless
    --allow-sec-supp re-aligns it."""
    out, err = aligner_parity(capfd, inputs, "bam_" + str(len("".join(extra))),
                              ["aligner", str(inputs["ref"]), str(inputs["bam"]), *extra],
                              "bam")
    n_in = 9 if "--max-reads" in extra else 24 if "--allow-sec-supp" in extra else 23
    assert f"> Mapped {n_in}/{n_in} reads" in err
    secondaries = sum(r.flag & 0x100 > 0 for r in bam_reader.read_bam(out)[1])
    assert (secondaries == 0) == ("--secondary=no" in "".join(extra))


@pytest.mark.parametrize("recursive", [False, True])
def test_aligner_folder(capfd, inputs, recursive):
    out, err = aligner_parity(capfd, inputs, f"folder_{recursive}",
                              ["aligner", str(inputs["ref"]), str(inputs["folder"]),
                               *(["-r"] if recursive else [])])
    assert f"> Mapped {23 if recursive else 9}/" in err


def test_aligner_refuses_cram_and_empty_folders(capfd, inputs):
    """``-o out.cram`` writes the JAX command's records as a reference-based
    CRAM (read back through the contigs); a reference-based CRAM as input is
    refused with exit code 1, naming the contig it needs, as is an empty
    folder."""
    from dorado_tpu.io.cram import CramReader as JaxCramReader
    from dorado_tpu_torch.alignment.index import ReferenceIndex
    from dorado_tpu_torch.io.cram import CramReader
    from tests.torch_cram import rr_cram

    argv = ["aligner", str(inputs["ref"]), str(inputs["fastq"])]
    index = ReferenceIndex.build(str(inputs["ref"]))
    refs = dict(zip(index.names, index.seqs))
    got = {}
    for who, main, reader in (("jax", jax_main, JaxCramReader), ("torch", torch_main, CramReader)):
        out = inputs["dir"] / f"out_{who}.cram"
        rc, err = _run(main, argv, out, capfd)
        assert rc == 0, err
        assert out.read_bytes()[:4] == b"CRAM" and not out.with_suffix(".cram.bai").exists()
        got[who] = [_fields(r) for r in reader(out, ref_seqs=refs).records()]
    assert got["torch"] == got["jax"] and len(got["torch"]) > 24
    cram = inputs["dir"] / "in.cram"
    rr_cram(cram)
    rc, err = _run(torch_main, ["aligner", str(inputs["ref"]), str(cram)],
                   inputs["dir"] / "x.bam", capfd)
    assert rc == 1 and "RR=true slice needs ref_seqs['ctg'] to decode" in err
    empty = inputs["dir"] / "empty"
    empty.mkdir()
    aligner_parity(capfd, inputs, "empty", ["aligner", str(inputs["ref"]), str(empty)], rc=1)
