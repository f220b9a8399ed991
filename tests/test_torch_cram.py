"""The port's CRAM 3.0 writer and reader (``dorado_tpu_torch/io/cram.py``)
against the JAX package's (``dorado_tpu/io/cram.py``) on seeded records:
ITF8 and LTF8, blocks and headers; ``CramWriter``'s bytes after the 26-byte
file definition equal JAX's for unmapped, mapped (CIGARs of M, I, D, N, S,
H and P, secondary records without bases), multi-slice and empty files, with rANS on
and off, and reference-based (RR=true); each package's reader decodes the
other's files to the same records; ``compute_md_nm`` and
``scan_structure`` agree; ``read_records`` dispatches on the magic.

And each decision on the JAX writer's defects (ROADMAP queue 3):
- a base of an RR=true record past its contig's end: JAX takes it for an
  implied match against 'N' and its own reader cannot give the read back;
  the port writes a 'b' feature there, which both readers decode;
- an RR=true file needs its reference: ``read_records`` passes none and
  raises ValueError naming the contig, as in JAX; ``CramReader(path,
  ref_seqs=...)`` reads it;
- the file id names the port (the JAX writer's names the JAX package).

gzip blocks carry the clock's time in their header: the byte comparisons
freeze it for both packages."""

import gzip
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dorado_tpu.io import cram as jax_cram
from dorado_tpu.io import sam as jax_sam
from dorado_tpu_torch.io import bam_reader, cram
from dorado_tpu_torch.io import sam as port_sam

CONTIGS = {"chr1": 5000, "chr2": 3000}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def frozen_gzip_clock(monkeypatch):
    monkeypatch.setattr(gzip, "time", SimpleNamespace(time=lambda: 1_700_000_000.0))


def _refs(seed=3):
    rng = np.random.RandomState(seed)
    return {name: "".join(rng.choice(list("ACGT"), n)) for name, n in CONTIGS.items()}


def _qual(rng, n):
    return "".join(chr(33 + q) for q in rng.randint(2, 45, n))


def _tags(mod, rng, i):
    T = mod.SamTag
    tags = [T("qs", "f", float(np.float32(rng.uniform(5, 30)))), T("ts", "i", int(i * 7)),
            T("st", "Z", "2024-03-01T12:00:00.123+00:00"), T("RG", "Z", f"rg{i % 2}"),
            T("mv", "B", rng.randint(0, 2, 30).astype(np.int8), subtype="c"),
            T("pa", "B", rng.randint(-5, 9000, 5).astype(np.int32), subtype="i")]
    if i % 3 == 0:
        tags += [T("MM", "Z", "C+m?,1,0;"), T("ML", "B", rng.randint(0, 256, 2).astype(np.uint8),
                                                    subtype="C")]
    if i % 4 == 1:
        tags += [T("dx", "c", -1), T("de", "f", 0.25), T("XA", "A", "Q"), T("sz", "S", 600)]
    return tags


def unmapped(mod, n, seed=1, length=(50, 400)):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = int(rng.randint(*length))
        seq = "".join(rng.choice(list("ACGT"), k))
        out.append(mod.SamRecord(qname=f"read-{i}", flag=4, seq=seq,
                                 qual=_qual(rng, k) if i % 5 else "*", tags=_tags(mod, rng, i)))
    return out


def mapped(mod, refs, n, seed=2, overhang=False):
    """Records of ``refs`` with CIGARs of M, I, D, N, S, H and P,
    substitutions, both strands, mates on the other contig, and every fifth a
    secondary alignment without bases; with ``overhang`` the last one runs
    6 bases past its contig's end (4 of them N)."""
    rng = np.random.RandomState(seed)
    out = []
    names = list(refs)
    for i in range(n):
        rname = names[i % len(names)]
        ref = refs[rname]
        pos = int(rng.randint(1, len(ref) - 600))
        ops, seq, p = [], [], pos - 1
        if i % 3 == 0:
            ops.append((3, "H"))
        if i % 2 == 0:
            clip = "".join(rng.choice(list("ACGT"), 5))
            ops.append((5, "S"))
            seq.append(clip)
        for _ in range(int(rng.randint(2, 6))):
            n_m = int(rng.randint(20, 80))
            bases = list(ref[p:p + n_m])
            for j in rng.choice(n_m, 2, replace=False):
                bases[j] = "ACGTN"[(("ACGT".find(bases[j]) + 1 + int(rng.randint(3))) % 4)
                                   if i % 7 else 4]
            ops.append((n_m, "M"))
            seq.append("".join(bases))
            p += n_m
            kind = ["I", "D", "N", "P"][int(rng.randint(4))]
            k = int(rng.randint(1, 6))
            ops.append((k, kind))
            if kind == "I":
                seq.append("".join(rng.choice(list("ACGT"), k)))
            elif kind in "DN":
                p += k
        n_m = int(rng.randint(10, 40))
        ops.append((n_m, "M"))
        seq.append(ref[p:p + n_m])
        seq = "".join(seq)
        secondary = i % 5 == 4
        out.append(mod.SamRecord(
            qname=f"aln-{i}", flag=(0x100 if secondary else 0) | (16 if i % 2 else 0) | 0x1
            | 0x20 * (i % 2), rname=rname, pos=pos, mapq=int(rng.randint(0, 61)),
            cigar="".join(f"{k}{op}" for k, op in ops), rnext="=" if i % 2 else names[0],
            pnext=int(rng.randint(0, 1000)), tlen=int(rng.randint(-500, 500)),
            seq="*" if secondary else seq, qual="*" if secondary else _qual(rng, len(seq)),
            tags=[mod.SamTag("NM", "i", 3), mod.SamTag("RG", "Z", "rg0")]))
    if overhang:
        ref = refs[names[0]]
        seq = ref[-44:] + "NNAANN"
        out.append(mod.SamRecord(qname="past-the-end", flag=0, rname=names[0],
                                 pos=len(ref) - 43, mapq=60, cigar="50M", seq=seq,
                                 qual=_qual(rng, 50), tags=[mod.SamTag("RG", "Z", "rg0")]))
    return out


def _header(mod, with_refs=True):
    h = mod.SamHeader()
    if with_refs:
        h.references = list(CONTIGS.items())
    h.read_groups = [{"ID": "rg0", "PL": "ONT"}, {"ID": "rg1", "SM": "s1"}]
    h.programs = [{"ID": "basecaller", "PN": "x", "CL": "x basecaller m d"}]
    return h


def _write(module, mod, records, **kw):
    buf = io.BytesIO()
    w = module.CramWriter(buf, _header(mod, with_refs=kw.pop("refs", True)), **kw)
    for r in records:
        w.write(r)
    w.close()
    return buf.getvalue()


def _canonical(records):
    """SAM lines with array tags as lists: the two packages print an empty
    array differently."""
    out = []
    for r in records:
        tags = []
        for t in r.tags:
            v = np.atleast_1d(t.value).tolist() if t.type == "B" else t.value
            tags.append((t.tag, t.type, t.subtype if t.type == "B" else "", repr(v)))
        out.append((r.qname, r.flag, r.rname, r.pos, r.mapq, r.cigar, r.rnext, r.pnext,
                    r.tlen, r.seq, r.qual, tuple(tags)))
    return out


CASES = {
    "unmapped": lambda mod, refs: unmapped(mod, 40),
    "mapped": lambda mod, refs: mapped(mod, refs, 30),
    "mixed": lambda mod, refs: unmapped(mod, 10) + mapped(mod, refs, 10),
    "multi-slice": lambda mod, refs: unmapped(mod, 4200, seed=5, length=(8, 20)),
    "empty": lambda mod, refs: [],
}


@pytest.mark.parametrize("rans", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_writer_bytes_equal_jax_and_readers_cross(case, rans):
    refs = _refs()
    ours = _write(cram, port_sam, CASES[case](port_sam, refs), rans=rans)
    theirs = _write(jax_cram, jax_sam, CASES[case](jax_sam, refs), rans=rans)
    assert ours[:6] == theirs[:6] == b"CRAM\x03\x00"
    assert ours[6:26] == b"dorado_tpu_torch".ljust(20, b"\x00")
    assert ours[26:] == theirs[26:]
    got_theirs = list(cram.CramReader(theirs).records())
    got_ours = list(jax_cram.CramReader(ours).records())
    assert _canonical(got_theirs) == _canonical(got_ours)
    assert _canonical(got_theirs) == _canonical(cram.CramReader(ours).records())
    assert len(got_theirs) == len(CASES[case](port_sam, refs))


@pytest.mark.parametrize("rans", [True, False])
def test_reference_based_bytes_equal_jax(rans):
    """RR=true: single-contig slices against the contig's bases (the slice
    MD5 of the spanned region); mixed slices stay verbatim."""
    refs = _refs()
    for records, rr in ((lambda mod: mapped(mod, {"chr1": refs["chr1"]}, 25), True),
                        (lambda mod: mapped(mod, refs, 12), False)):
        ours = _write(cram, port_sam, records(port_sam), rans=rans, ref_seqs=refs)
        theirs = _write(jax_cram, jax_sam, records(jax_sam), rans=rans, ref_seqs=refs)
        assert ours[26:] == theirs[26:]
        a = list(cram.CramReader(theirs, ref_seqs=refs).records())
        b = list(jax_cram.CramReader(ours, ref_seqs=refs).records())
        assert _canonical(a) == _canonical(b) and len(a) == len(records(port_sam))
        # the reader fills in MD and NM from the reference where missing
        plain = {r.qname: r for r in records(port_sam)}
        for rec in a:
            want = plain[rec.qname]
            assert (rec.seq, rec.cigar, rec.pos, rec.flag) == (want.seq, want.cigar, want.pos,
                                                               want.flag)
            if want.seq != "*" and rr:
                md = next(t.value for t in rec.tags if t.tag == "MD")
                assert md == cram.compute_md_nm(want.seq, want.cigar, refs[want.rname],
                                                want.pos)[0]


def test_rr_true_smaller_than_verbatim():
    refs = _refs()
    recs = mapped(port_sam, {"chr1": refs["chr1"]}, 40)
    assert len(_write(cram, port_sam, recs, ref_seqs=refs)) < len(_write(cram, port_sam, recs))


def test_past_the_contig_end_round_trips():
    """The decision on the JAX writer's implied matches past a contig's end:
    its own round trip fails on such a read; the port's file gives it back,
    through either reader, and equals JAX's bytes but for that record's
    features."""
    refs = _refs()
    one = {"chr1": refs["chr1"]}  # single-contig slices: RR=true
    theirs = _write(jax_cram, jax_sam, mapped(jax_sam, one, 6, overhang=True), ref_seqs=refs)
    with pytest.raises(ValueError, match="shorter than RL"):
        list(jax_cram.CramReader(theirs, ref_seqs=refs).records())
    recs = mapped(port_sam, one, 6, overhang=True)
    ours = _write(cram, port_sam, recs, ref_seqs=refs)
    for reader in (cram.CramReader, jax_cram.CramReader):
        back = {r.qname: r for r in reader(ours, ref_seqs=refs).records()}
        assert back["past-the-end"].seq == recs[-1].seq and back["past-the-end"].cigar == "50M"
        assert {q: r.seq for q, r in back.items()} == {
            r.qname: r.seq for r in recs}
    assert ours[26:] != theirs[26:]
    inside = mapped(port_sam, one, 6)
    assert (_write(cram, port_sam, inside, ref_seqs=refs)[26:]
            == _write(jax_cram, jax_sam, mapped(jax_sam, one, 6), ref_seqs=refs)[26:])


def test_read_records_dispatches_and_refuses_rr_true(tmp_path):
    """``read_records`` reads a non-reference CRAM as the JAX function does,
    and raises on a reference-based one, naming the contig it needs, as the
    JAX function does; ``CramReader(ref_seqs=...)`` reads that file."""
    from dorado_tpu.io.bam_reader import read_records as jax_read_records

    refs = _refs()
    path = tmp_path / "u.cram"
    path.write_bytes(_write(cram, port_sam, unmapped(port_sam, 12)))
    text, recs = bam_reader.read_records(path)
    jtext, jrecs = jax_read_records(path)
    assert text == jtext and "@RG\tID:rg1" in text
    assert _canonical(recs) == _canonical(jrecs) and len(recs) == 12
    rr = tmp_path / "rr.cram"
    rr.write_bytes(_write(cram, port_sam, mapped(port_sam, {"chr2": refs["chr2"]}, 5),
                          ref_seqs=refs))
    for fn in (bam_reader.read_records, jax_read_records):
        with pytest.raises(ValueError, match="ref_seqs\\['chr2'\\]"):
            fn(rr)
    assert len(list(cram.CramReader(rr, ref_seqs=refs).records())) == 5


def test_no_seq_flag_defined_once():
    source = open(cram.__file__).read()
    assert source.count("CF_NO_SEQ = ") == 1 and cram.CF_NO_SEQ == jax_cram.CF_NO_SEQ == 0x8


@pytest.mark.parametrize("seed", range(4))
def test_compute_md_nm_matches_jax(seed):
    refs = _refs(seed)
    for rec in mapped(port_sam, refs, 20, seed=seed):
        if rec.seq == "*":
            continue
        assert cram.compute_md_nm(rec.seq, rec.cigar, refs[rec.rname], rec.pos) == \
            jax_cram.compute_md_nm(rec.seq, rec.cigar, refs[rec.rname], rec.pos)


def test_varints_match_jax():
    rng = np.random.RandomState(0)
    values = [0, 1, 127, 128, 16383, 16384, 2**21 - 1, 2**21, 2**28 - 1, 2**28, 2**31 - 1, -1,
              -5, *rng.randint(0, 2**31, 200).tolist()]
    for v in values:
        assert cram.write_itf8(v) == jax_cram.write_itf8(v)
        assert cram.ByteReader(cram.write_itf8(v)).itf8() == v
    for v in values + [2**35, 2**42 + 3, 2**49 + 1, 2**56 + 7, 2**62]:
        if v < 0:
            continue
        assert cram.write_ltf8(v) == jax_cram.write_ltf8(v)
        assert cram.ByteReader(cram.write_ltf8(v)).ltf8() == v


def test_scan_structure_matches_jax(tmp_path):
    path = tmp_path / "m.cram"
    path.write_bytes(_write(cram, port_sam, unmapped(port_sam, 4200, seed=5, length=(8, 20))))
    got = cram.scan_structure(path)
    assert got == jax_cram.scan_structure(path)
    assert got["version"] == (3, 0) and got["eof"] and got["records"] == 4200
    assert got["containers"] == 3 and cram.RANS4x8 in got["methods"]
