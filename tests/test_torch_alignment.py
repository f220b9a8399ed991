"""The port's read mapper (``dorado_tpu_torch.alignment``) against
``dorado_tpu.alignment``: minimizers, the index, chains and the mapper's
alignments (ref start and end, CIGAR, strand, MAPQ, NM, score), exactly,
on the same seeded sequences."""

import numpy as np
import pytest

from dorado_tpu.alignment import index as jax_index
from dorado_tpu.alignment import mapper as jax_mapper
from dorado_tpu.alignment import minimizer as jax_minimizer
from dorado_tpu.native import chain_native as jax_chain
from dorado_tpu_torch.alignment import index, mapper, minimizer
from dorado_tpu_torch.utils import chain
from tests.torch_polish import mutate, polish_inputs, revcomp, write_fasta


def _seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


@pytest.mark.parametrize("k, w", [(15, 10), (11, 5), (19, 1)])
def test_minimizers_equal_jax(k, w):
    rng = np.random.RandomState(k + w)
    seqs = [_seq(rng, 3000), _seq(rng, 40) + "N" * 5 + _seq(rng, 400), "acgt" * 30,
            _seq(rng, k - 1), _seq(rng, k + w // 2), "A" * 200]
    for s in seqs:
        ours = minimizer.minimizers(s, k, w)
        theirs = jax_minimizer.minimizers(s, k, w)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    codes = "ACGTNacgtx"
    assert np.array_equal(minimizer.encode_seq(codes), jax_minimizer.encode_seq(codes))


def test_index_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    repeat = _seq(rng, 300)
    contigs = [("a", _seq(rng, 2000) + repeat * 4 + _seq(rng, 500)), ("b", _seq(rng, 1500)),
               ("c", repeat + _seq(rng, 100))]
    fasta = write_fasta(tmp_path / "draft.fa", contigs)
    assert index.read_fasta(fasta) == jax_index.read_fasta(fasta)
    for src in (fasta, contigs):
        ours, theirs = index.ReferenceIndex.build(src), jax_index.ReferenceIndex.build(src)
        assert (ours.names, ours.lengths, ours.seqs, ours.k, ours.w, ours.max_occ) == (
            theirs.names, theirs.lengths, theirs.seqs, theirs.k, theirs.w, theirs.max_occ)
        for name in ("hashes", "positions", "strands", "seq_ids"):
            assert np.array_equal(getattr(ours, name), getattr(theirs, name)), name
        q = minimizer.minimizers(contigs[0][1][1800:3000])[0]
        for a, b in zip(ours.lookup(q), theirs.lookup(q)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 7, 400])
def test_chain_equals_jax(n):
    rng = np.random.RandomState(n)
    # a colinear run with jitter, plus scattered anchors, sorted by (r, q)
    r = np.sort(rng.randint(0, 20000, n)).astype(np.int64)
    q = (r // 2 + rng.randint(-30, 30, n)).astype(np.int64)
    scatter = rng.rand(n) < 0.2
    q[scatter] = rng.randint(0, 10000, int(scatter.sum()))
    order = np.lexsort((q, r))
    q, r = q[order], r[order]
    for k, gap, look in ((15, 5000, 50), (11, 200, 7)):
        ours = chain.chain(q, r, k, max_gap=gap, lookback=look)
        theirs = jax_chain(q, r, k, max_gap=gap, lookback=look)
        assert np.array_equal(ours[0], theirs[0]) and ours[1] == theirs[1]
    ci, score = mapper._chain(q, r, 15)
    ci_j, score_j = jax_mapper._chain(q, r, 15)
    assert np.array_equal(ci, ci_j) and score == score_j


def test_cigar_and_mapq_equal_jax():
    rng = np.random.RandomState(5)
    for n in (0, 1, 50):
        ops = rng.randint(0, 4, n).astype(np.uint8)
        assert mapper._ops_to_cigar(ops) == jax_mapper._ops_to_cigar(ops)
    for best, second in ((0, 0), (120, 0), (80, 60), (300, 299), (50.5, 10)):
        assert mapper.Mapper._mapq(best, second) == jax_mapper.Mapper._mapq(best, second)


def test_mapper_equals_jax():
    """Noisy reads from both strands, reads overhanging the contig ends, a
    read of a repeated segment (secondary candidates with
    ``max_alignments``), an unmappable read and a read shorter than k."""
    draft, _, reads = polish_inputs(11, 5000, 24, (300, 2500), error=0.1)
    rng = np.random.RandomState(12)
    seg = _seq(rng, 600)
    contigs = [("ctg", draft), ("rep", _seq(rng, 800) + seg + _seq(rng, 900) + seg
                                + _seq(rng, 700))]
    queries = [s for _, s, _ in reads] + [
        _seq(rng, 200) + draft[:800], draft[-700:] + _seq(rng, 300),
        revcomp(mutate(rng, seg, 0.05)), _seq(rng, 1500), "ACGTACG",
    ]
    for max_alignments in (1, 3):
        ours = mapper.Mapper(index.ReferenceIndex.build(contigs), max_alignments=max_alignments)
        theirs = jax_mapper.Mapper(jax_index.ReferenceIndex.build(contigs),
                                   max_alignments=max_alignments)
        mapped = secondary = 0
        for q in queries:
            a, b = ours.map(q), theirs.map(q)
            assert [vars(x) for x in a] == [vars(x) for x in b], q[:40]
            mapped += bool(a)
            secondary += sum(x.is_secondary for x in a)
        assert mapped >= len(reads)
    assert secondary >= 1
