"""The port's poly(A)/poly(T) calculators (``dorado_tpu_torch.polytail``)
against the JAX package's on synthetic reads: the DNA, plasmid and RNA
calculators, each on a read with planted primers or flanks around a tail
whose signal is a flat stretch in noise, with ``pt`` and ``pa`` (the result's
bases, anchor and ranges) equal; the poly(A) TOML with per-barcode overrides
and its errors; and the selector's rule for unclassified reads."""

import dataclasses

import numpy as np
import pytest
import torch

import dorado_tpu.polytail as jax_polytail
from dorado_tpu.polytail import calculator as jax_calculator
from dorado_tpu_torch import polytail
from dorado_tpu_torch.polytail import calculator
from dorado_tpu_torch.utils.sequence import reverse_complement
from tests.torch_demux import random_seq

SPB = 10  # samples a base: a move every other stride of 5


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def contexts(rng, seq: str, tail: tuple[int, int], **kw):
    """The port's and the JAX package's ReadContext of ``seq``: a base every
    two strides, noise of sd 1 around 0 but a flat level over the bases of
    ``tail``."""
    moves = np.zeros(2 * len(seq), dtype=np.uint8)
    moves[::2] = 1
    signal = rng.normal(0.0, 1.0, SPB * len(seq)).astype(np.float32)
    signal[tail[0] * SPB : tail[1] * SPB] = 1.2 + rng.normal(0, 0.05, (tail[1] - tail[0]) * SPB)
    args = dict(seq=seq, moves=moves, signal=signal, stride=5, **kw)
    return calculator.ReadContext(**args), jax_calculator.ReadContext(**args)


def same_result(ours, theirs, read, jax_read):
    a, b = ours.calculate_num_bases(read), theirs.calculate_num_bases(jax_read)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    return a


@pytest.mark.parametrize("code", ["FLO-MIN114", "FLO-PRO114M"])
@pytest.mark.parametrize("reverse", [False, True])
def test_dna_calculator_matches_jax(code, reverse):
    rng = np.random.RandomState(2 * reverse + (code == "FLO-PRO114M"))
    cfg = polytail.PolyTailConfig()
    rear_rc = cfg.rc_rear_primer[4:]  # the VNP's four trailing Ts are the tail's
    found = 0
    for tail_len in (30, 60, 110):
        lead = random_seq(rng, 15) + cfg.front_primer + random_seq(rng, 500)
        seq = lead + "A" * tail_len + rear_rc + random_seq(rng, 12)
        tail = (len(lead), len(lead) + tail_len)
        if reverse:
            seq = reverse_complement(seq)
            tail = (len(seq) - tail[1], len(seq) - tail[0])
        read, jax_read = contexts(rng, seq, tail, num_trimmed_samples=37,
                                  flow_cell_product_code=code)
        for speed, offset in ((None, None), (1.1, 2.0)):
            ours = polytail.make_calculator(speed=speed, offset=offset)
            theirs = jax_polytail.make_calculator(speed=speed, offset=offset)
            res = same_result(ours, theirs, read, jax_read)
            found += res.num_bases > 0
            if speed is None and res.num_bases > 0:
                assert abs(res.num_bases - tail_len) < 0.3 * tail_len + 8
                assert res.signal_anchor >= 37
    assert found >= 4
    # no primer, no anchor
    read, jax_read = contexts(rng, random_seq(rng, 600), (100, 160))
    assert same_result(polytail.make_calculator(), jax_polytail.make_calculator(),
                       read, jax_read).num_bases == -1


FRONT = "CCGGTTAACCGGTTGCAAAA"  # plasmid flanks: 4 trailing As
REAR = "AAGGCCAATTGGCCAATT"  # 2 leading As


def test_plasmid_calculator_matches_jax():
    rng = np.random.RandomState(9)
    cfg = dict(front_primer=FRONT, rear_primer=REAR, is_plasmid=True, flank_threshold=0.85)
    ours = polytail.make_calculator(polytail.PolyTailConfig(**cfg))
    theirs = jax_polytail.make_calculator(jax_polytail.PolyTailConfig(**cfg))
    assert type(ours).__name__ == type(theirs).__name__ == "PlasmidPolyTailCalculator"
    found = 0
    filler = random_seq(rng, 300)
    for seq, tail in (
        (filler + FRONT + "A" * 50 + REAR + filler, None),
        (reverse_complement(filler + FRONT + "A" * 50 + REAR + filler), None),
        ("A" * 30 + REAR + random_seq(rng, 400) + FRONT + "A" * 25, None),  # split tail
    ):
        starts = [i for i in range(len(seq) - 20) if seq[i : i + 20] in ("A" * 20, "T" * 20)]
        tail = (starts[0], starts[-1] + 20) if starts else (0, 0)
        read, jax_read = contexts(rng, seq, tail)
        info = ours.determine_signal_anchor_and_strand(read)
        assert [dataclasses.asdict(i) for i in info] == [
            dataclasses.asdict(i) for i in theirs.determine_signal_anchor_and_strand(jax_read)]
        found += same_result(ours, theirs, read, jax_read).num_bases > 0
    assert found >= 2


@pytest.mark.parametrize("rna_adapter", [False, True])
def test_rna_calculator_matches_jax(rna_adapter):
    rng = np.random.RandomState(4 + rna_adapter)
    cfg = polytail.PolyTailConfig()
    ours = polytail.make_calculator(is_rna=True, is_rna_adapter=rna_adapter)
    theirs = jax_polytail.make_calculator(is_rna=True, is_rna_adapter=rna_adapter)
    assert type(ours).__name__ == type(theirs).__name__ == "RNAPolyTailCalculator"
    found = 0
    for tail_len in (40, 90):
        # the read's 3' end (adapter, then tail) is the signal's start: the
        # adapter ends 30 bases in, where the flat tail begins
        seq = random_seq(rng, 400) + "A" * tail_len + cfg.rna_adapter + random_seq(rng, 10)
        read, jax_read = contexts(rng, seq, (30, 30 + tail_len),
                                  rna_adapter_end_signal_pos=30 * SPB)
        res = same_result(ours, theirs, read, jax_read)
        found += res.num_bases > 0
    sizes = rng.gamma(4.0, 2.5, 300).astype(np.float32)
    assert ours.average_samples_per_base(sizes) == theirs.average_samples_per_base(sizes)
    assert (ours.signal_length_adjustment(read, 900)
            == theirs.signal_length_adjustment(jax_read, 900))
    assert found == 2


def write_config(tmp_path, text: str):
    path = tmp_path / "polya.toml"
    path.write_text(text)
    return path


CONFIG = """
[anchors]
front_primer = "AAGGTTCCAA"
rear_primer = "CCTTAAGGTTTTT"
primer_window = 120
min_primer_separation = 6

[threshold]
flank_threshold = 0.7

[tail]
tail_interrupt_length = 5

[[overrides]]
barcode_id = "NB24_barcode02"
[overrides.threshold]
flank_threshold = 0.9

[[overrides]]
barcode_id = "NB24_barcode05"
[overrides.anchors]
plasmid_front_flank = "ACGTACGTAAAA"
plasmid_rear_flank = "TTTTGCATGCAT"
[overrides.status]
enabled = false
"""


def test_config_with_overrides_matches_jax(tmp_path):
    path = write_config(tmp_path, CONFIG)
    ours, theirs = polytail.load_poly_tail_configs(path), jax_polytail.load_poly_tail_configs(path)
    assert {k: dataclasses.asdict(v) for k, v in ours.items()} == {
        k: dataclasses.asdict(v) for k, v in theirs.items()}
    assert ours["NB24_barcode02"].flank_threshold == 0.9
    assert ours["NB24_barcode02"].front_primer == "AAGGTTCCAA"
    assert ours["NB24_barcode05"].is_plasmid and not ours["NB24_barcode05"].enabled
    assert (dataclasses.asdict(polytail.load_poly_tail_config(path))
            == dataclasses.asdict(jax_polytail.load_poly_tail_config(path)))


@pytest.mark.parametrize("text", [
    '[anchors]\nfront_primer = "ACGT"\n',
    '[anchors]\nfront_primer = "ACGT"\nrear_primer = "TT"\nplasmid_front_flank = "A"\n'
    'plasmid_rear_flank = "C"\n',
    '[anchors]\nplasmid_front_flank = "ACGT"\n',
    '[anchors]\nprimer_window = 0\n',
    '[anchors]\nmin_primer_separation = -1\n',
    'barcode_id = "x"\n',
    '[[overrides]]\n[overrides.tail]\ntail_interrupt_length = 3\n',
    '[[overrides]]\nbarcode_id = "a"\n[[overrides]]\nbarcode_id = "a"\n',
])
def test_config_errors_match_jax(tmp_path, text):
    path = write_config(tmp_path, text)
    with pytest.raises(ValueError) as ours:
        polytail.load_poly_tail_configs(path)
    with pytest.raises(ValueError) as theirs:
        jax_polytail.load_poly_tail_configs(path)
    assert str(ours.value) == str(theirs.value)


def test_selector_matches_jax(tmp_path):
    configs = polytail.load_poly_tail_configs(write_config(tmp_path, CONFIG))
    jax_configs = jax_polytail.load_poly_tail_configs(write_config(tmp_path, CONFIG))
    ours = polytail.PolyTailCalculatorSelector(configs, speed=1.2)
    theirs = jax_polytail.PolyTailCalculatorSelector(jax_configs, speed=1.2)

    def kind(calc):
        return None if calc is None else (type(calc).__name__, calc.config.flank_threshold,
                                          calc.speed)

    for barcode in (None, "", "NB24_barcode02", "NB24_barcode05", "NB24_barcode07",
                    "unclassified", "alias_x"):
        assert kind(ours.get_calculator(barcode)) == kind(theirs.get_calculator(barcode))
    # overrides present: an unclassified read gets no calculator
    assert ours.get_calculator("unclassified") is None
    assert ours.get_calculator("NB24_barcode05") is None  # disabled
    # one config, or none: every read gets the default
    for cfg in (None, polytail.PolyTailConfig(flank_threshold=0.65)):
        plain = polytail.PolyTailCalculatorSelector(cfg)
        assert plain.get_calculator("unclassified") is plain.get_calculator("NB24_barcode02")
        assert plain.get_calculator("unclassified") is not None
