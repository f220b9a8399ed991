"""The port's variant decoding (``secondary/variant.py``) and the slot
model's phasing pass against the JAX package's on the same seeded inputs:
``decode_variants`` (haploid and diploid, gVCF, ``ambig_ref``, LowQual,
merged and left-aligned events), ``call_variants``,
``call_variants_diploid``, ``normalize_genotype``, ``VcfWriter`` and
``batch_adjacency_phase``; records, text and arrays equal."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from dorado_tpu.secondary import architectures as jax_arch
from dorado_tpu.secondary import variant as jax_variant
from dorado_tpu_torch.secondary import architectures, variant

SYMBOLS = "*ACGT"


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def columns(seed: int, n_major: int, ins_rate: float = 0.08):
    """(positions_major, positions_minor) of a pileup over ``n_major``
    draft positions, with 1-2 insert columns after ``ins_rate`` of them."""
    rng = np.random.RandomState(seed)
    pm, pn = [], []
    for m in range(n_major):
        k = rng.randint(1, 3) if rng.rand() < ins_rate else 0
        pm += [m] * (k + 1)
        pn += list(range(k + 1))
    return np.asarray(pm), np.asarray(pn)


def probabilities(seed: int, draft: str, pm, pn, haps: int, event_rate: float = 0.06,
                  weak_rate: float = 0.05):
    """[P, haps, 5] probabilities: at each column the draft base ('*' at an
    insert column) most likely, but at ``event_rate`` of columns a SNP, a
    deletion or an inserted base on one haplotype or both, and at
    ``weak_rate`` a winner barely ahead (low qualities, LowQual); seeded
    noise throughout."""
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.ones(5) * 0.3, size=(len(pm), haps)) * 0.2
    for i, (m, n) in enumerate(zip(pm, pn)):
        ref = "*" if n else draft[m]
        ref = SYMBOLS.index(ref if ref in SYMBOLS else "A")
        calls = [ref] * haps
        if rng.rand() < event_rate:
            alt = rng.choice([c for c in range(5) if c != ref])
            # heterozygous (the first haplotype) or homozygous
            calls = [alt] + [alt if rng.rand() < 0.5 else ref for _ in range(haps - 1)]
        for h, call in enumerate(calls):
            p[i, h, call] += 0.4 if rng.rand() < weak_rate else 2.0
    return p / p.sum(-1, keepdims=True)


def records(vs):
    return [dataclasses.asdict(v) for v in vs]


def vcf_text(module, vs, gvcf):
    fh = io.StringIO()
    w = module.VcfWriter(fh, [("ctg", 400), ("other", 10)], gvcf=gvcf)
    for v in vs:
        w.write(v)
    return fh.getvalue(), w.records_written


DRAFT = "".join(np.random.RandomState(3).choice(list("ACGT"), 400))
# ambiguous draft bases: not called without ambig_ref
DRAFT_N = DRAFT[:50] + "NNR" + DRAFT[53:200] + "N" + DRAFT[201:]


@pytest.mark.parametrize("haps", [1, 2])
@pytest.mark.parametrize("draft", [DRAFT, DRAFT_N], ids=["acgt", "ambiguous"])
@pytest.mark.parametrize("kwargs", [
    {}, {"return_all": True}, {"ambig_ref": True}, {"min_qual": 20.0},
    {"merge_overlapping": False, "merge_adjacent": False}, {"normalize": False},
    {"return_all": True, "ambig_ref": True, "min_qual": 8.0},
], ids=["default", "gvcf", "ambig_ref", "lowqual", "unmerged", "unnormalised", "gvcf_ambig"])
def test_decode_variants_equal(haps, draft, kwargs):
    pm, pn = columns(haps, len(draft))
    p = probabilities(10 + haps, draft, pm, pn, haps)
    if haps == 1:
        p = p[:, 0]
    want = jax_variant.decode_variants(draft, "ctg", p, pm, pn, **kwargs)
    got = variant.decode_variants(draft, "ctg", p, pm, pn, **kwargs)
    assert records(got) == records(want)
    assert len(want) > (len(draft) if kwargs.get("return_all") else 5)
    gvcf = kwargs.get("return_all", False)
    assert vcf_text(variant, got, gvcf) == vcf_text(jax_variant, want, gvcf)


def test_decode_covers_each_kind():
    """The default decode of the diploid inputs holds SNPs, insertions,
    left-aligned deletions (a reference base before the deleted ones),
    heterozygous and homozygous genotypes, merged multi-column events and
    LowQual records: the cases above exercise each."""
    pm, pn = columns(2, len(DRAFT))
    p = probabilities(12, DRAFT, pm, pn, 2)
    vs = variant.call_variants_diploid(DRAFT, "ctg", p, pm, pn, min_qual=20.0)
    assert records(vs) == records(
        jax_variant.call_variants_diploid(DRAFT, "ctg", p, pm, pn, min_qual=20.0))
    kinds = {"snp": 0, "ins": 0, "del": 0, "anchored del": 0, "het": 0, "hom": 0, "merged": 0,
             "lowqual": 0}
    for v in vs:
        for a in v.alts:
            if len(a) == len(v.ref) == 1:
                kinds["snp"] += 1
            elif len(a) > len(v.ref):
                kinds["ins"] += 1
            elif len(a) < len(v.ref):
                kinds["del"] += 1
                # a deletion after its anchoring reference base
                kinds["anchored del"] += v.ref.startswith(a)
        gt = dict(v.genotype)["GT"]
        kinds["het" if len(set(gt.split("/"))) > 1 else "hom"] += 1
        kinds["merged"] += v.rend - v.rstart > 2
        kinds["lowqual"] += v.filter == "LowQual"
    assert all(kinds.values()), kinds


def test_call_variants_haploid_logits_equal():
    pm, pn = columns(5, len(DRAFT))
    logits = np.log(probabilities(15, DRAFT, pm, pn, 1)[:, 0]) * 1.7 + 0.3
    want = jax_variant.call_variants(DRAFT, "ctg", logits, pm, pn, return_all=True)
    got = variant.call_variants(DRAFT, "ctg", logits, pm, pn, return_all=True)
    assert records(got) == records(want) and len(got) > len(DRAFT)


@pytest.mark.parametrize("alts,qual,flt", [
    (["C", "C"], 30.0, "PASS"), (["A", "C"], 2.5, "PASS"), (["C", "G"], 10.0, "PASS"),
    (["C", "G", "T"], 40.0, "PASS"), (["."], 7.4, "PASS"), ([], 3.0, "PASS"),
    (["C", "A"], 12.0, "."),
])
def test_normalize_genotype_equal(alts, qual, flt):
    args = dict(contig="ctg", pos=7, ref="A", alts=alts, qual=qual, filter=flt,
                genotype=[("GT", "1"), ("GQ", "0")], rstart=9, rend=10)
    for ploidy in (1, 2):
        want = jax_variant.normalize_genotype(jax_variant.Variant(**args), ploidy, 3.0)
        got = variant.normalize_genotype(variant.Variant(**args), ploidy, 3.0)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.is_valid == want.is_valid


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_adjacency_phase_equal(seed):
    """The slot model's host phasing pass on seeded softmax outputs and
    basecalls: reads that follow one of two haplotypes (deletions, as class
    0, among their calls), padding reads, and slots swapped at a tenth of
    the positions. Equal arrays, and the pass swaps some positions back."""
    rng = np.random.RandomState(seed)
    b, p, d = 2, 120, 9
    haps = rng.randint(0, 5, (b, p, 2))
    probs = rng.dirichlet(np.ones(5), size=(b, p, 2)).astype(np.float32) * 0.3
    swapped = rng.rand(b, p) < 0.1
    for s, h in ((0, 0), (1, 1)):
        idx = np.where(swapped, 1 - h, h)
        np.put_along_axis(probs[:, :, s], np.take_along_axis(haps, idx[..., None], -1),
                          1.0, axis=-1)
    calls = np.zeros((b, p, d), np.float32)  # padding
    for r in range(d - 1):
        calls[:, :, r] = haps[:, :, r % 2]
    calls[calls == 0] = 5  # class 0 is a deletion call
    calls[:, :, d - 2] = rng.randint(0, 6, (b, p))  # noise
    want = jax_arch.batch_adjacency_phase(probs, calls, lookback=4)
    got = architectures.batch_adjacency_phase(probs, calls, lookback=4)
    np.testing.assert_array_equal(got, want)
    assert (got != probs).any()
