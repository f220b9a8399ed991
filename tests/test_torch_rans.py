"""The port's rANS codecs (``dorado_tpu_torch/io/rans.py``) against the JAX
package's on seeded numpy data: rANS 4x8 at orders 0 and 1 and rANS Nx16
(order 0, its CAT and PACK forms) encode to the same bytes, and each
package decodes the other's output. The Nx16 decoder's other paths (PACK
over order 0, RLE, order 1, striping) are held on streams this file builds
from the format (no encoder of either package writes them): both decoders
give the data back. And the one divergence: a frequency table whose rare
symbols, each raised to 1, outgrow the floors makes the JAX encoders raise
OverflowError; the port's normalises it and both decoders read it."""

import numpy as np
import pytest
import torch

from dorado_tpu.io import rans as jax_rans
from dorado_tpu_torch.io import rans


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, from before the module's fixtures run: several test
    workers share the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _data(kind: str, n: int, seed: int = 0) -> bytes:
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        return rng.randint(0, 256, n).astype(np.uint8).tobytes()
    if kind == "quals":  # phred qualities of a basecaller, skewed
        return np.clip(rng.normal(20, 6, n), 2, 50).astype(np.uint8).tobytes()
    if kind == "bases":
        return bytes(rng.choice(list(b"ACGT"), n, p=[0.3, 0.2, 0.2, 0.3]))
    if kind == "runs":  # a Markov chain: order 1 pays
        out, s = np.empty(n, np.uint8), 0
        for i in range(n):
            s = s if rng.rand() < 0.9 else rng.randint(0, 8)
            out[i] = 65 + s
        return out.tobytes()
    raise ValueError(kind)


KINDS = ["uniform", "quals", "bases", "runs"]
SIZES = [1, 7, 300, 5000]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_rans4x8_bytes_and_cross_decode(order, kind, n):
    data = _data(kind, n, seed=n)
    ours, theirs = rans.rans4x8_encode(data, order), jax_rans.rans4x8_encode(data, order)
    assert ours == theirs
    assert rans.rans4x8_decode(theirs) == data == jax_rans.rans4x8_decode(ours)


@pytest.mark.parametrize("kind", KINDS + ["single", "empty"])
@pytest.mark.parametrize("n", [5, 2000])
def test_ransnx16_bytes_and_cross_decode(kind, n):
    if kind == "single":
        data = b"Q" * n
    elif kind == "empty":
        data = b""
    else:
        data = _data(kind, n, seed=n + 1)
    ours, theirs = rans.ransNx16_encode(data), jax_rans.ransNx16_encode(data)
    assert ours == theirs
    assert rans.ransNx16_decode(theirs) == data == jax_rans.ransNx16_decode(ours)
    if kind == "single" and n:
        assert ours[0] & (rans.ORDER_PACK | rans.ORDER_CAT)


# ---- Nx16 streams built from the format ----------------------------------------


def _packed(data: bytes) -> bytes:
    """PACK over order 0: the symbol map, the packed size, the packed bytes
    order-0 coded."""
    mapping, packed = rans._pack(data)
    body = rans._nx16_encode_o0(packed)
    return (bytes([rans.ORDER_PACK]) + rans._put_u7(len(data)) + bytes([len(mapping)])
            + mapping + rans._put_u7(len(packed)) + body)


def _rle(data: bytes) -> bytes:
    """RLE over order 0, the run metadata stored raw."""
    meta, lits = rans._rle_encode(data)
    return (bytes([rans.ORDER_RLE]) + rans._put_u7(len(data)) + rans._put_u7(len(meta) << 1 | 1)
            + rans._put_u7(len(lits)) + meta + rans._nx16_encode_o0(lits))


def _striped(data: bytes, n_streams: int = 4) -> bytes:
    subs = [data[j::n_streams] for j in range(n_streams)]
    coded = [bytes([rans.ORDER_NOSZ]) + rans._nx16_encode_o0(s) for s in subs]
    return (bytes([rans.ORDER_STRIPE]) + rans._put_u7(len(data)) + bytes([n_streams])
            + b"".join(rans._put_u7(len(c)) for c in coded) + b"".join(coded))


def _o1(data: bytes, shift: int = 12) -> bytes:
    """An order-1 Nx16 stream, 4 states, its frequency table uncompressed:
    each context's row over the alphabet (zero runs coded), normalised to
    ``1 << shift``; the states interleaved as the decoder reads them."""
    arr = np.frombuffer(data, np.uint8)
    n, N = len(arr), 4
    isz = n // N
    lanes = [list(range(j * isz, (j + 1) * isz)) for j in range(N)]
    lanes[N - 1] += list(range(N * isz, n))
    counts = np.zeros((256, 256), np.int64)
    for lane in lanes:
        prev = 0
        for p in lane:
            counts[prev, arr[p]] += 1
            prev = arr[p]
    syms = sorted(set(np.nonzero(counts.sum(1))[0]) | set(np.nonzero(counts.sum(0))[0]))
    table = bytearray(rans._write_alphabet(syms))
    F = {}
    for i in syms:
        f = rans._normalize_freqs(counts[i], 1 << shift) if counts[i].sum() else np.zeros(256)
        F[i] = (f.astype(np.int64), np.concatenate([[0], np.cumsum(f)]).astype(np.int64))
        run = 0
        for k, j in enumerate(syms):
            if run:
                run -= 1
                continue
            table += rans._put_u7(int(f[j]))
            if f[j] == 0:
                while k + run + 1 < len(syms) and f[syms[k + run + 1]] == 0:
                    run += 1
                table.append(run)
    # the decoder's order of steps: lane-major rounds, then lane N-1's tail
    order = [(j, lanes[j][t]) for t in range(isz) for j in range(N)]
    order += [(N - 1, p) for p in lanes[N - 1][isz:]]
    ctx = {}
    for j, lane in enumerate(lanes):
        prev = 0
        for p in lane:
            ctx[p] = prev
            prev = arr[p]
    R = [rans._LN16] * N
    words = []
    for j, p in reversed(order):
        f_row, cum = F[ctx[p]]
        s = arr[p]
        f = int(f_row[s])
        x = R[j]
        if x >= ((rans._LN16 >> shift) << 16) * f:
            words.append(x & 0xFFFF)
            x >>= 16
        R[j] = ((x // f) << shift) + (x % f) + int(cum[s])
    body = b"".join(int(r).to_bytes(4, "little") for r in R)
    body += b"".join(int(w).to_bytes(2, "little") for w in reversed(words))
    return (bytes([rans.ORDER_O1]) + rans._put_u7(n) + bytes([shift << 4]) + bytes(table)
            + body)


@pytest.mark.parametrize("form", ["pack", "rle", "stripe", "o1", "o1 shift 10"])
@pytest.mark.parametrize("kind", ["bases", "runs", "quals"])
def test_ransnx16_decoders_read_every_form(form, kind):
    data = _data(kind, 3001, seed=7)
    if form == "pack":
        data = bytes(b % 4 + 65 for b in data)  # four symbols: 2 bits each
    stream = {"pack": _packed, "rle": _rle, "stripe": _striped, "o1": _o1,
              "o1 shift 10": lambda d: _o1(d, 10)}[form](data)
    assert rans.ransNx16_decode(stream) == data == jax_rans.ransNx16_decode(stream)


def test_rans_overflowing_table_is_normalised():
    """A hundred symbols of 10 counts each beside one of 99,000: raised to
    1, they outgrow the floors' total of 4096. The JAX encoders raise; the
    port's take the drift from the largest symbol, and both decoders read
    its bytes back."""
    rng = np.random.RandomState(0)
    arr = np.full(100_000, ord("A"), np.uint8)
    arr[rng.choice(np.arange(1, 100_000, 2), 1000, replace=False)] = np.repeat(
        np.arange(100, 200), 10)
    data = arr.tobytes()
    for order in (0, 1):
        with pytest.raises(OverflowError):
            jax_rans.rans4x8_encode(data, order)
        ours = rans.rans4x8_encode(data, order)
        assert rans.rans4x8_decode(ours) == data == jax_rans.rans4x8_decode(ours)
        assert len(ours) < len(data) // 20
    f = rans._normalize_freqs(np.bincount(arr, minlength=256), 4096)
    assert f.dtype == np.uint32 and int(f.sum()) == 4096 and f[100:200].min() == 1
