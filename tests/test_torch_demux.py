"""The port's barcode classifier (``dorado_tpu_torch.demux``) against the JAX
package's on the same reads: the kit table, ``classify`` for a read of every
kit (perfect and at 5% errors), both ends, mid-strand, a rear-only kit,
allowed barcodes, unbarcoded reads and a custom arrangement, with every
field of the result exact; ``normalize_barcode_name`` and
``determine_barcode_trim_interval``; and the aligner with the barcode
equality table against the JAX native aligner."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import dorado_tpu.demux as jax_demux
import dorado_tpu.demux.barcoder as jax_barcoder
from dorado_tpu import native
from dorado_tpu.demux.custom_kit import parse_custom_arrangement as jax_parse_arrangement
from dorado_tpu.demux.custom_kit import parse_custom_sequences as jax_parse_sequences
from dorado_tpu_torch import demux
from dorado_tpu_torch.demux.barcoder import determine_barcode_trim_interval
from dorado_tpu_torch.demux.custom_kit import (
    check_normalized_id_pattern,
    parse_custom_arrangement,
    parse_custom_sequences,
    parse_scoring_params,
)
from dorado_tpu_torch.utils import align as port_align
from tests.torch_demux import barcoded_read, mutate, random_seq

KITS = [k for k in demux.list_kits() if demux.get_kit_info(k)["barcodes"]]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def jax_custom_barcodes(monkeypatch):
    """The JAX package's process-wide custom barcode registry, emptied for
    one test and restored after it."""
    table = {}
    monkeypatch.setattr(jax_barcoder, "_custom_barcodes", table)
    return table


def same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_kit_table_equals_jax():
    with open(jax_barcoder._DATA_PATH) as f:
        theirs = json.load(f)
    with open(demux.barcoder._DATA_PATH) as f:
        ours = json.load(f)
    assert ours == theirs and len(ours["kits"]) == 45
    assert demux.list_kits() == jax_demux.list_kits()
    for name in ("NB01", "BC96", "RB24", "16S01"):
        if name in theirs["barcodes"]:
            assert demux.get_barcode_sequence(name) == jax_demux.get_barcode_sequence(name)


@pytest.mark.parametrize("kit", KITS)
def test_classify_every_kit_matches_jax(kit):
    rng = np.random.RandomState(KITS.index(kit))
    info = demux.get_kit_info(kit)
    ours, theirs = demux.BarcodeClassifier(kit), jax_demux.BarcodeClassifier(kit)
    right = 0
    for name in rng.choice(info["barcodes"], 2, replace=False):
        for error in (0.0, 0.05):
            read = barcoded_read(rng, kit, name, int(rng.randint(150, 700)), error)
            res = ours.classify(read)
            same(res, theirs.classify(read))
            right += error == 0 and res.barcode_name == name
    assert right == 2


def test_classify_unbarcoded_both_ends_midstrand_match_jax():
    rng = np.random.RandomState(1)
    kit = "SQK-NBD114-24"
    ours, theirs = demux.BarcodeClassifier(kit), jax_demux.BarcodeClassifier(kit)
    info = demux.get_kit_info(kit)
    calls = []
    for i in range(6):
        read = random_seq(rng, 800)
        res = ours.classify(read)
        same(res, theirs.classify(read))
        calls.append(res.barcode_name)
    assert calls.count("unclassified") >= 5
    # --barcode-both-ends: a read with one end's context cut off is dropped
    for name in ("NB03", "NB17"):
        full = barcoded_read(rng, kit, name, 500, 0.03)
        front_only = full[: len(full) - 60]
        for read in (full, front_only):
            for both in (False, True):
                same(ours.classify(read, barcode_both_ends=both),
                     theirs.classify(read, barcode_both_ends=both))
        assert ours.classify(front_only, barcode_both_ends=True).barcode_name == "unclassified"
    # a barcode context between long inserts: an unsplit read
    bc = demux.get_barcode_sequence("NB05")
    context = info["top_front_flank"] + bc + info["top_rear_flank"]
    read = random_seq(rng, 400) + context + random_seq(rng, 400)
    res = ours.classify(read)
    same(res, theirs.classify(read))
    assert res.found_midstrand and res.barcode_name == "unclassified"
    same(ours.classify(""), theirs.classify(""))


@pytest.mark.parametrize("kit", ["SQK-DRB004-24", "SQK-16S114-24", "SQK-PCB114-24"])
def test_classify_rear_only_and_wildcard_kits_match_jax(kit):
    rng = np.random.RandomState(5)
    info = demux.get_kit_info(kit)
    ours, theirs = demux.BarcodeClassifier(kit), jax_demux.BarcodeClassifier(kit)
    for name in info["barcodes"][:4]:
        read = barcoded_read(rng, kit, name, 700, 0.02)
        res = ours.classify(read)
        same(res, theirs.classify(read))
        assert res.barcode_name == name


def test_allowed_barcodes_match_jax():
    rng = np.random.RandomState(3)
    kit = "SQK-NBD114-24"
    allowed = {"barcode03", "NB09"}
    ours = demux.BarcodeClassifier(kit, allowed_barcodes=allowed)
    theirs = jax_demux.BarcodeClassifier(kit, allowed_barcodes=allowed)
    names = []
    for name in ("NB03", "NB07", "NB09"):
        read = barcoded_read(rng, kit, name, 400)
        res = ours.classify(read)
        same(res, theirs.classify(read))
        names.append(res.barcode_name)
    assert names == ["NB03", "unclassified", "NB09"]


def test_unknown_and_empty_kits_raise():
    with pytest.raises(ValueError, match="unknown barcode kit"):
        demux.BarcodeClassifier("SQK-NOPE")
    with pytest.raises(ValueError, match="lists no barcodes"):
        demux.BarcodeClassifier("TWIST-16-UDI")
    with pytest.raises(IndexError):
        jax_demux.BarcodeClassifier("TWIST-16-UDI")


ARRANGEMENT = """
[arrangement]
name = "custom_kit"
kit = "CK12"
mask1_front = "ACGTTGCAAGGT"
mask1_rear = "CAGCTTGA"
mask2_front = "TTGACGGTCAAC"
mask2_rear = "GGATCCAA"
barcode1_pattern = "CB%02i"
barcode2_pattern = "CB%02i"
first_index = 1
last_index = 6

[scoring]
max_barcode_penalty = 8
min_flank_score = 0.6
"""


def write_custom_kit(tmp_path, seed=11):
    rng = np.random.RandomState(seed)
    toml = tmp_path / "arrangement.toml"
    toml.write_text(ARRANGEMENT)
    fasta = tmp_path / "barcodes.fasta"
    fasta.write_text("".join(f">CB{i:02d} extra=tag\n{random_seq(rng, 24)}\n"
                             for i in range(1, 7)))
    return toml, fasta


def test_custom_arrangement_matches_jax(tmp_path, jax_custom_barcodes):
    toml, fasta = write_custom_kit(tmp_path)
    name, info = parse_custom_arrangement(toml)
    assert (name, info) == jax_parse_arrangement(toml)
    assert info["double_ends"] and info["ends_different"]
    assert info["scoring_params"]["max_barcode_penalty"] == 8
    seqs = parse_custom_sequences(fasta)
    assert seqs == jax_parse_sequences(fasta) and len(seqs) == 6
    jax_custom_barcodes.update(jax_parse_sequences(fasta))
    ours = demux.BarcodeClassifier(name, kit_info=info, custom_barcodes=seqs)
    theirs = jax_demux.BarcodeClassifier(name, kit_info=info)
    rng = np.random.RandomState(4)
    for bc in ("CB02", "CB05"):
        for error in (0.0, 0.04):
            read = barcoded_read(rng, name, bc, 500, error, custom=seqs, kit_info=info)
            res = ours.classify(read)
            same(res, theirs.classify(read))
            assert error or res.barcode_name == bc
    # custom sequences stay with their classifier: the table has no CB02
    with pytest.raises(KeyError):
        demux.get_barcode_sequence("CB02")


@pytest.mark.parametrize("bad", [
    ("barcode1_pattern = \"CB%02i\"", "barcode1_pattern = \"CB%02d\""),
    ("first_index = 1", "first_index = 9"),
    ("mask2_rear = \"GGATCCAA\"\n", ""),
])
def test_custom_arrangement_errors_match_jax(tmp_path, bad):
    toml = tmp_path / "bad.toml"
    toml.write_text(ARRANGEMENT.replace(*bad))
    with pytest.raises(ValueError) as ours:
        parse_custom_arrangement(toml)
    with pytest.raises(ValueError) as theirs:
        jax_parse_arrangement(toml)
    assert str(ours.value) == str(theirs.value)


def test_custom_kit_helpers_match_jax(tmp_path):
    from dorado_tpu.demux import custom_kit as jax_custom_kit

    for pattern in ("BC%02i", "X%i", "BC%02d", "BC", "%i", "B%2xi"):
        assert (check_normalized_id_pattern(pattern)
                == jax_custom_kit.check_normalized_id_pattern(pattern))
    toml, _ = write_custom_kit(tmp_path)
    base = dict(jax_custom_kit.DEFAULT_SCORING_PARAMS, flank_left_pad=7)
    assert parse_scoring_params(toml, base) == jax_custom_kit.parse_scoring_params(toml, base)
    fastq = tmp_path / "seqs.fastq"
    fastq.write_text("@A1 x\nACGT\n+\nIIII\n>B2\nGG\nTT\n")
    assert parse_custom_sequences(fastq) == jax_parse_sequences(fastq) == {
        "A1": "ACGT", "B2": "GGTT"}


def test_normalize_and_trim_interval_match_jax():
    for name in ("BC01", "NB24", "RB96", "16S07", "barcode12", "CB%", "x", "RLB12A"):
        assert demux.normalize_barcode_name(name) == jax_demux.normalize_barcode_name(name)
    rng = np.random.RandomState(8)
    for kit in ("SQK-NBD114-24", "SQK-RBK114-96", "SQK-DRB004-24", "SQK-PCB114-24"):
        ours, theirs = demux.BarcodeClassifier(kit), jax_demux.BarcodeClassifier(kit)
        info = demux.get_kit_info(kit)
        for name in info["barcodes"][5:8]:
            read = barcoded_read(rng, kit, name, 300, 0.03)
            a, b = ours.classify(read), theirs.classify(read)
            got = determine_barcode_trim_interval(a, len(read))
            assert got == jax_barcoder.determine_barcode_trim_interval(b, len(read))
            assert got != (0, len(read)) or a.barcode_name == "unclassified"
    none = demux.BarcodeScoreResult()
    assert determine_barcode_trim_interval(none, 50) == (0, 50)
    crossed = demux.BarcodeScoreResult(
        barcode_name="NB01", kit="k", top_penalty=1, bottom_penalty=1, top_flank_score=0.9,
        bottom_flank_score=0.9, top_barcode_pos=(0, 40), bottom_barcode_pos=(20, 45),
        use_top=False)
    assert determine_barcode_trim_interval(crossed, 50) == (0, 20)
    assert jax_barcoder.determine_barcode_trim_interval(
        jax_demux.BarcodeScoreResult(**dataclasses.asdict(crossed)), 50) == (0, 20)


@pytest.mark.parametrize("mode", [port_align.MODE_NW, port_align.MODE_HW, port_align.MODE_SHW])
def test_align_with_equalities_matches_jax(mode):
    rng = np.random.RandomState(mode)
    ours_eq = port_align.make_equality_table(port_align.BARCODE_EQUALITIES)
    assert ours_eq == native.make_equality_table(native.BARCODE_EQUALITIES)
    assert port_align.BARCODE_EQUALITIES == native.BARCODE_EQUALITIES
    for _ in range(40):
        target = random_seq(rng, int(rng.randint(20, 300)))
        start = int(rng.randint(0, max(1, len(target) - 30)))
        query = list(mutate(rng, target[start : start + int(rng.randint(8, 60))], 0.15))
        for i in rng.choice(len(query), min(len(query), 6), replace=False):
            query[i] = rng.choice(list("NNNM"))
        query = "".join(query)
        for eq in (ours_eq, None):
            a = port_align.align(query, target, mode=mode, equalities=eq)
            b = native.align(query, target, mode=mode, equalities=eq)
            assert (a.distance, a.t_start, a.t_end) == (b.distance, b.t_start, b.t_end)
            np.testing.assert_array_equal(a.ops, b.ops)
    with pytest.raises(ValueError, match="256 x 256"):
        port_align.align("ACGT", "ACGT", equalities=b"\x01")
