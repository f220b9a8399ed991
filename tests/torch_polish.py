"""Seeded polishing inputs: a draft contig, the sequence it was drawn from,
and reads of that sequence from both strands with substitutions, deletions
and insertions, written as FASTA or FASTQ (numpy only; ``chip_smoke.py``
uses them too); the parity tests' drafts, reads and SAM
(``polish_files``, through the port's mapper) and JAX-layout weights drawn
with numpy (``jax_gru_params``, ``jax_rl_params``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


def revcomp(seq: str) -> str:
    return _COMP[np.frombuffer(seq.encode(), dtype=np.uint8)[::-1]].tobytes().decode()


def mutate(rng: np.random.RandomState, seq: str, rate: float) -> str:
    """``seq`` with a substitution, a deletion or an insertion of a random
    base each at ``rate / 3`` of its positions."""
    s = np.frombuffer(seq.encode(), dtype=np.uint8)
    kind = rng.choice(4, size=len(s), p=[1.0 - rate, rate / 3, rate / 3, rate / 3])
    subs = _BASES[rng.randint(0, 4, len(s))]
    ins = _BASES[rng.randint(0, 4, len(s))]
    base = np.where(kind == 1, subs, s)
    keep = kind != 2
    counts = keep.astype(np.int64) + (kind == 3)
    out = np.empty(int(counts.sum()), dtype=np.uint8)
    ends = np.cumsum(counts)
    firsts = ends - counts
    out[firsts[keep]] = base[keep]
    out[ends[kind == 3] - 1] = ins[kind == 3]
    return out.tobytes().decode()


def polish_inputs(seed: int, draft_len: int, n_reads: int, read_len: tuple[int, int],
                  error: float = 0.08, draft_error: float = 0.01):
    """(draft, truth, reads): a random ``truth`` of ``draft_len`` bases, the
    draft drawn from it at ``draft_error``, and ``n_reads`` reads of
    ``read_len`` (low, high) bases of the truth at ``error``, each on a
    random strand: (name, sequence, phred qualities 5-30 as a string)."""
    rng = np.random.RandomState(seed)
    truth = _BASES[rng.randint(0, 4, draft_len)].tobytes().decode()
    draft = mutate(rng, truth, draft_error)
    reads = []
    for i in range(n_reads):
        n = rng.randint(*read_len)
        start = rng.randint(0, max(1, len(truth) - n // 2))
        seq = mutate(rng, truth[start:start + n], error)
        if rng.rand() < 0.5:
            seq = revcomp(seq)
        qual = (rng.randint(5, 31, len(seq)) + 33).astype(np.uint8).tobytes().decode()
        reads.append((f"read_{i}", seq, qual))
    return draft, truth, reads


def write_fasta(path: Path | str, records: list[tuple[str, str]]) -> Path:
    path = Path(path)
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80] + "\n")
    return path


def write_fastq(path: Path | str, reads) -> Path:
    path = Path(path)
    with open(path, "w") as fh:
        for name, seq, qual in reads:
            fh.write(f"@{name}\n{seq}\n+\n{qual}\n")
    return path


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def jax_gru_params(rng: np.random.RandomState, num_features: int = 10, gru_size: int = 16,
                   num_layers: int = 2, bidirectional: bool = True, num_classes: int = 5):
    """A GRU param pytree in the JAX package's layout (``init_gru_params``'),
    drawn with numpy: the weights both packages load in the parity tests."""
    s = 1.0 / np.sqrt(gru_size)
    layers, in_size = [], num_features
    for _ in range(num_layers):
        layers.append({key: {
            "w_ih": _uniform(rng, (3 * gru_size, in_size), s),
            "w_hh": _uniform(rng, (3 * gru_size, gru_size), s),
            "b_ih": _uniform(rng, (3 * gru_size,), s),
            "b_hh": _uniform(rng, (3 * gru_size,), s),
        } for key in (["fwd", "rev"] if bidirectional else ["fwd"])})
        in_size = gru_size * (2 if bidirectional else 1)
    return {"layers": layers, "linear": {
        "w": (rng.randn(num_classes, in_size) / np.sqrt(in_size)).astype(np.float32),
        "b": (0.1 * rng.randn(num_classes)).astype(np.float32)}}


def jax_rl_params(rng: np.random.RandomState, lstm_size: int = 16, cnn_size: int = 12,
                  kernel_sizes=(1, 5), use_dwells: bool = False, num_classes: int = 5,
                  embedding: int = 6, alphabet: int = 6):
    """A LatentSpaceLSTM param pytree in the JAX package's layout
    (``init_latent_space_lstm``'), drawn with numpy, with batch-norm running
    stats and affine weights away from the identity."""
    def lin(i, o):
        s = 1.0 / np.sqrt(i)
        return {"w": _uniform(rng, (o, i), s), "b": _uniform(rng, (o,), s)}

    conv, in_ch = [], embedding + (2 if use_dwells else 1)
    for k in kernel_sizes:
        s = 1.0 / np.sqrt(in_ch * k)
        conv.append({
            "conv": {"w": _uniform(rng, (cnn_size, in_ch, k), s),
                     "b": _uniform(rng, (cnn_size,), s)},
            "bn": {"g": (1 + 0.2 * rng.randn(cnn_size)).astype(np.float32),
                   "b": (0.1 * rng.randn(cnn_size)).astype(np.float32),
                   "mean": (0.1 * rng.randn(cnn_size)).astype(np.float32),
                   "var": (0.5 + rng.rand(cnn_size)).astype(np.float32)}})
        in_ch = cnn_size
    s = 1.0 / np.sqrt(lstm_size)
    lstm, in_size = [], lstm_size
    for _ in range(2):
        lstm.append({key: {
            "w_ih": _uniform(rng, (4 * lstm_size, in_size), s),
            "w_hh": _uniform(rng, (4 * lstm_size, lstm_size), s),
            "b_ih": _uniform(rng, (4 * lstm_size,), s),
            "b_hh": _uniform(rng, (4 * lstm_size,), s)} for key in ("fwd", "rev")})
        in_size = 2 * lstm_size
    return {
        "base_embedder": {"w": rng.randn(alphabet, embedding).astype(np.float32)},
        "strand_embedder": {"w": rng.randn(3, embedding).astype(np.float32)},
        "read_level_conv": {"layers": conv},
        "pre_pool_expansion_layer": lin(cnn_size, lstm_size),
        "lstm": {"layers": lstm},
        "linear": lin(2 * lstm_size, num_classes),
    }


def polish_files(d: Path, seed: int = 31):
    """Two drafts (2.0 kb, three windows of 1000 overlapping by 200, and
    0.9 kb, one window) and 24 reads of them from both strands, aligned by
    the port's mapper: {"fasta", "fastq", "sam" (the alignments in two read
    groups, with NM tags), "by_contig" (AlignedReads), "dir"}."""
    from dorado_tpu_torch.alignment import Mapper, ReferenceIndex
    from dorado_tpu_torch.io.sam import SamHeader, SamRecord, SamTag, SamWriter
    from dorado_tpu_torch.secondary.pileup import AlignedRead

    draft_a, _, reads_a = polish_inputs(seed, 2000, 16, (400, 1200))
    draft_b, _, reads_b = polish_inputs(seed + 1, 900, 8, (300, 800))
    reads = reads_a + [(f"b{n}", s, q) for n, s, q in reads_b]
    drafts = [("ctg_a", draft_a), ("ctg_b", draft_b)]
    out = {"dir": d, "fasta": write_fasta(d / "draft.fa", drafts),
           "fastq": write_fastq(d / "reads.fastq", reads), "by_contig": {}}
    mapper = Mapper(ReferenceIndex.build(drafts))
    records = []
    for i, (name, seq, qual) in enumerate(reads):
        q = np.frombuffer(qual.encode(), np.uint8).astype(np.int16) - 33
        for a in mapper.map(seq):
            s = revcomp(seq) if a.is_reverse else seq
            out["by_contig"].setdefault(a.ref_name, []).append(AlignedRead(
                a.ref_start, a.cigar, s, a.is_reverse, qual=q[::-1].copy() if a.is_reverse
                else q, mapq=a.mapq, qname=name))
            records.append(SamRecord(
                qname=name, flag=16 if a.is_reverse else 0, rname=a.ref_name,
                pos=a.ref_start + 1, mapq=a.mapq, cigar=a.cigar, seq=s,
                qual=qual[::-1] if a.is_reverse else qual,
                tags=[SamTag("RG", "Z", "rg_a" if i % 2 else "rg_b"), SamTag("NM", "i", a.nm)]))
    header = SamHeader(references=[(n, len(s)) for n, s in drafts],
                       read_groups=[{"ID": "rg_a", "SM": "a"}, {"ID": "rg_b", "SM": "b"}])
    out["sam"] = d / "two_groups.sam"
    with open(out["sam"], "w") as fh:
        w = SamWriter(fh, header)
        for rec in records:
            w.write(rec)
    return out
