"""The port's adapter and primer finders and record trimmer
(``dorado_tpu_torch.demux.adapters``, ``.trimmer``) against the JAX
package's on the same reads: the search for each kit's adapters and primers
and for custom primers, with scores, positions and retained intervals
exact; ``trim_record`` on records with a move table, MM/ML modbase tags and
``is_rna``; and ``ReadTrimmer`` against the JAX command's trimming of
basecalls (adapters, then primers)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import dorado_tpu.demux.adapters as jax_adapters
from dorado_tpu.demux.trimmer import trim_move_table as jax_trim_move_table
from dorado_tpu.demux.trimmer import trim_record as jax_trim_record
from dorado_tpu.io.sam import SamRecord as JaxRecord
from dorado_tpu.io.sam import SamTag as JaxTag
from dorado_tpu_torch.demux import adapters
from dorado_tpu_torch.demux.trimmer import trim_modbase_info, trim_move_table, trim_record
from dorado_tpu_torch.io.sam import SamRecord, SamTag
from dorado_tpu_torch.utils.sequence import reverse_complement
from tests.torch_demux import mutate, random_seq

KITS = sorted(adapters._LSK110_KITS | adapters._RNA004_KITS) + [
    "SQK-NBD114-24-260", "SQK-UNKNOWN", None]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def jax_custom_primers(monkeypatch):
    """The JAX package's process-wide custom primer registry, emptied for
    one test and restored after it."""
    table = {}
    monkeypatch.setattr(jax_adapters, "_custom_primers", table)
    return table


def planted(rng, front: str, rear: str, insert: int = 400, error: float = 0.0) -> str:
    read = random_seq(rng, 12) + front + random_seq(rng, insert) + rear + random_seq(rng, 8)
    return mutate(rng, read, error) if error else read


def same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def to_jax(rec: SamRecord) -> JaxRecord:
    fields = {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec) if f.name != "tags"}
    return JaxRecord(**fields, tags=[JaxTag(t.tag, t.type, copy.copy(t.value), t.subtype)
                                     for t in rec.tags])


def same_record(ours: SamRecord, theirs: JaxRecord):
    assert (ours.qname, ours.seq, ours.qual) == (theirs.qname, theirs.seq, theirs.qual)
    assert [(t.tag, t.type, t.subtype) for t in ours.tags] == [
        (t.tag, t.type, t.subtype) for t in theirs.tags]
    for a, b in zip(ours.tags, theirs.tags):
        if isinstance(b.value, np.ndarray):
            assert a.value.dtype == b.value.dtype
            np.testing.assert_array_equal(a.value, b.value)
        else:
            assert a.value == b.value, a.tag


@pytest.mark.parametrize("kit", KITS)
def test_adapters_and_primers_match_jax(kit):
    rng = np.random.RandomState(KITS.index(kit))
    assert adapters.adapters_for_kit(kit) == jax_adapters.adapters_for_kit(kit)
    assert adapters.primers_for_kit(kit) == jax_adapters.primers_for_kit(kit)
    lsk_f, lsk_r = adapters.ADAPTERS["LSK110"]
    ssp, vnp = adapters.PRIMERS["PCS110"]
    trimmed = 0
    for error in (0.0, 0.04):
        reads = [planted(rng, lsk_f + ssp, reverse_complement(vnp) + lsk_r, error=error),
                 planted(rng, adapters.PRIMERS["cDNA"][0], "", error=error),
                 planted(rng, "", adapters.ADAPTERS["RNA004"][1], error=error),
                 random_seq(rng, 300), random_seq(rng, 40)]
        for read in reads:
            for find, jax_find in ((adapters.find_adapters, jax_adapters.find_adapters),
                                   (adapters.find_primers, jax_adapters.find_primers)):
                a, b = find(read, kit), jax_find(read, kit)
                same(a, b)
                got = adapters.determine_trim_interval(a, len(read))
                assert got == jax_adapters.determine_trim_interval(b, len(read))
                same(a, b)  # the interval marks weak ends unclassified in both
                trimmed += got != (0, len(read))
    assert trimmed > 0 or not (adapters.adapters_for_kit(kit) or adapters.primers_for_kit(kit))


def test_custom_primers_match_jax(jax_custom_primers):
    rng = np.random.RandomState(2)
    custom = {"MY_FWD": random_seq(rng, 24), "OTHER": random_seq(rng, 30)}
    jax_custom_primers.update(custom)
    assert (adapters.primers_for_kit("SQK-LSK114", custom)
            == jax_adapters.primers_for_kit("SQK-LSK114"))
    for read in (planted(rng, custom["MY_FWD"], reverse_complement(custom["MY_FWD"])),
                 planted(rng, custom["OTHER"], "", error=0.05), random_seq(rng, 500)):
        a = adapters.find_primers(read, "SQK-LSK114", custom)
        b = jax_adapters.find_primers(read, "SQK-LSK114")
        same(a, b)
        assert (adapters.determine_trim_interval(a, len(read))
                == jax_adapters.determine_trim_interval(b, len(read)))
    # without the argument the port searches the kit's own primers
    assert adapters.primers_for_kit("SQK-LSK114")[0][0] == "cDNA_FWD"


def modbase_record(rng, n: int, stride: int = 5) -> SamRecord:
    """A record of ``n`` bases with a move table, ts/ns, and MM/ML for C+m
    and A+a calls (sparse skips, one ML value a call)."""
    seq = random_seq(rng, n)
    steps = rng.randint(1, 4, n)
    moves = np.zeros(int(steps.sum()), dtype=np.uint8)
    moves[np.concatenate([[0], np.cumsum(steps)[:-1]])] = 1
    mm, ml = [], []
    for base, code in (("C", "C+m?"), ("A", "A+a."), ("G", "G-h?")):
        count = seq.count(base)
        skips, left = [], count
        while left > 0:
            k = int(rng.randint(0, 4))
            if k >= left:
                break
            skips.append(k)
            left -= k + 1
        mm.append(code + "".join(f",{k}" for k in skips) + ";")
        ml += list(rng.randint(0, 256, len(skips)))
    qual = "".join(chr(33 + q) for q in rng.randint(3, 40, n))
    return SamRecord(qname=f"r{n}", seq=seq, qual=qual, tags=[
        SamTag("ns", "i", len(moves) * stride + 7), SamTag("ts", "i", 7),
        SamTag("mv", "B", np.concatenate([[stride], moves]).astype(np.uint8), subtype="c"),
        SamTag("MN", "i", n), SamTag("MM", "Z", "".join(mm)),
        SamTag("ML", "B", np.asarray(ml, dtype=np.uint8), subtype="C"),
    ])


@pytest.mark.parametrize("is_rna", [False, True])
def test_trim_record_matches_jax(is_rna):
    rng = np.random.RandomState(7 + is_rna)
    for n in (40, 200, 901):
        for interval in ((0, n), (3, n), (0, n - 5), (n // 3, 2 * n // 3), (n - 1, n), (5, 5),
                         (7, 2)):
            rec = modbase_record(rng, n)
            theirs = to_jax(rec)
            trim_record(rec, interval, is_rna=is_rna)
            jax_trim_record(theirs, interval, is_rna=is_rna)
            same_record(rec, theirs)
    # a record without moves or modbase tags, and one without qualities
    for rec in (SamRecord(qname="a", seq="ACGTACGTAC", qual="IIIIIIIIII"),
                SamRecord(qname="b", seq="ACGTACGTAC")):
        theirs = to_jax(rec)
        trim_record(rec, (2, 8), is_rna=is_rna)
        jax_trim_record(theirs, (2, 8), is_rna=is_rna)
        same_record(rec, theirs)
    assert rec.seq == "GTACGT" and rec.qual == "*"


def test_trim_move_table_and_modbase_info():
    moves = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 1], dtype=np.uint8)
    for interval in ((0, 6), (1, 4), (2, 2), (5, 6), (0, 0)):
        n, got = trim_move_table(moves, interval)
        m, want = jax_trim_move_table(moves, interval)
        assert n == m
        np.testing.assert_array_equal(got, want)
    assert trim_modbase_info("ACCGC", "", np.zeros(0, np.uint8), (1, 4))[0] == ""
    mm, ml = trim_modbase_info("CACCGC", "C+m,0,1;", np.array([10, 20], np.uint8), (1, 5))
    assert (mm, list(ml)) == ("C+m,1;", [20])


@pytest.mark.parametrize("what", ["all", "adapters", "primers"])
def test_read_trimmer_matches_jax_command(what, jax_custom_primers):
    """``ReadTrimmer`` against the JAX basecaller's trimming of a record
    (its _FinishingWriter: adapters, then primers on what is left)."""
    rng = np.random.RandomState(3)
    lsk_f, lsk_r = adapters.ADAPTERS["LSK110"]
    ssp, vnp = adapters.PRIMERS["cDNA"]
    trimmer = adapters.ReadTrimmer(adapters=what in ("all", "adapters"),
                                   primers=what in ("all", "primers"), kit_name="SQK-LSK114")
    cut = 0
    for _ in range(4):
        rec = modbase_record(rng, 10)
        rec.seq = planted(rng, lsk_f + ssp, reverse_complement(vnp) + lsk_r, 300, 0.02)
        rec.qual = "".join(chr(33 + q) for q in rng.randint(3, 40, len(rec.seq)))
        rec.tags = [t for t in rec.tags if t.tag not in ("MM", "ML", "MN", "mv")]
        theirs = to_jax(rec)
        before = len(rec.seq)
        trimmer.trim(rec)
        if what in ("all", "adapters"):
            res = jax_adapters.find_adapters(theirs.seq, "SQK-LSK114")
            jax_trim_record(theirs, jax_adapters.determine_trim_interval(res, len(theirs.seq)))
        if what in ("all", "primers") and theirs.seq:
            res = jax_adapters.find_primers(theirs.seq, "SQK-LSK114")
            jax_trim_record(theirs, jax_adapters.determine_trim_interval(res, len(theirs.seq)))
        same_record(rec, theirs)
        cut += len(rec.seq) < before
    assert cut == 4
    star = SamRecord(qname="s")
    assert trimmer.trim(star).seq == "*"
