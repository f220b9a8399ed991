"""The port's read splitter and its aligner on the CPU against the JAX
package's (``dorado_tpu.native.align``, ``dorado_tpu.splitter``), on seeded
numpy inputs: planted concatemers of 1-3 kb strands (``torch_concatemers``)
and reads with nothing to split. Tolerance: exact everywhere, since a split
point comes from the aligner's traceback ties."""

import numpy as np
import pytest

from dorado_tpu import native as jax_native
from dorado_tpu.modbase.encode import moves_to_map as jax_moves_to_map
from dorado_tpu.splitter import DuplexReadSplitter as JaxSplitter
from dorado_tpu.splitter import DuplexSplitSettings as JaxSettings
from dorado_tpu.splitter import utils as jax_utils
from dorado_tpu.utils import reverse_complement as jax_reverse_complement
from dorado_tpu_torch.splitter import DuplexReadSplitter, DuplexSplitSettings
from dorado_tpu_torch.splitter import utils
from dorado_tpu_torch.utils import align as port_align
from dorado_tpu_torch.utils.sequence import reverse_complement
from tests.torch_concatemers import concatemer

STRIDE = 6


def _bases(rs, n):
    return "".join(rs.choice(list("ACGT"), n))


def _pairs(rs):
    """Empty and one-base sequences, random pairs, related pairs (a mutated
    copy inside a longer target) and pairs more than 4x apart in length,
    which take the band-widening loop."""
    pairs = [("", ""), ("", "A"), ("A", ""), ("A", "A"), ("A", "C"), ("", "ACGT"),
             ("ACGTACGT", "")]
    for _ in range(60):
        pairs.append((_bases(rs, rs.randint(0, 80)), _bases(rs, rs.randint(0, 120))))
    for _ in range(30):
        q = _bases(rs, rs.randint(20, 200))
        t = list(_bases(rs, rs.randint(0, 300)) + q + _bases(rs, rs.randint(0, 300)))
        for i in rs.randint(0, len(t), len(q) // 8):
            t[i] = "ACGT"[rs.randint(4)]
        pairs.append((q, "".join(t)))
    for _ in range(20):
        n = rs.randint(1, 60)
        pairs.append((_bases(rs, n), _bases(rs, 4 * n + rs.randint(1, 400))))
        pairs.append((_bases(rs, 4 * n + rs.randint(1, 400)), _bases(rs, n)))
    return pairs


@pytest.mark.parametrize("mode", [port_align.MODE_NW, port_align.MODE_HW, port_align.MODE_SHW])
def test_align_matches_jax(mode):
    rs = np.random.RandomState(11 + mode)
    widened = 0
    for q, t in _pairs(rs):
        ours = port_align.align(q, t, mode=mode)
        ref = jax_native.align(q, t, mode=mode)
        assert (ours.distance, ours.t_start, ours.t_end) == (
            ref.distance, ref.t_start, ref.t_end), (q, t)
        np.testing.assert_array_equal(ours.ops, ref.ops)
        widened += abs(len(q) - len(t)) > 3 * min(len(q), len(t)) + 32
    assert widened > 20


def test_align_codes_and_library():
    assert (port_align.EDOP_MATCH, port_align.EDOP_INSERT, port_align.EDOP_DELETE,
            port_align.EDOP_MISMATCH) == (jax_native.EDOP_MATCH, jax_native.EDOP_INSERT,
                                          jax_native.EDOP_DELETE, jax_native.EDOP_MISMATCH)
    assert (port_align.MODE_NW, port_align.MODE_HW, port_align.MODE_SHW) == (
        jax_native.MODE_NW, jax_native.MODE_HW, jax_native.MODE_SHW)
    res = port_align.align("TACTTCG", "GGTACTACGGG", mode=port_align.MODE_HW)
    assert (res.distance, res.t_start, res.t_end) == (1, 2, 9)  # TACT[T>A]CG
    assert port_align.library_path().exists()


def test_pore_signal_ranges_and_qscores_match_jax():
    rs = np.random.RandomState(3)
    for _ in range(20):
        sig = rs.normal(0, 1.0, rs.randint(1000, 20000)).astype(np.float32)
        for args in ((2.4, 500, 5000), (2.8, 500, 5000), (1.5, 20, 0)):
            ours = utils.detect_pore_signal(sig, *args)
            ref = jax_utils.detect_pore_signal(sig, *args)
            assert [vars(r) for r in ours] == [vars(r) for r in ref]
        starts = np.sort(rs.randint(0, 5000, rs.randint(0, 12)))
        ranges = [(int(a), int(a + rs.randint(1, 200))) for a in starts]
        for dist in (0, 50, 2900):
            assert utils.merge_ranges(ranges, dist) == jax_utils.merge_ranges(ranges, dist)
        q = (rs.randint(0, 45, rs.randint(0, 100)) + 33).astype(np.uint8).tobytes().decode()
        for a, b in ((0, 5), (3, 8), (0, len(q) + 4), (len(q), len(q) + 5)):
            assert utils.qscore_mean(q, a, b) == jax_utils.qscore_mean(q, a, b)
        moves = (rs.rand(rs.randint(1, 300)) < 0.4).astype(np.uint8)
        np.testing.assert_array_equal(utils.moves_to_map(moves, STRIDE, len(moves) * STRIDE),
                                      jax_moves_to_map(moves, STRIDE, len(moves) * STRIDE))
        np.testing.assert_array_equal(utils.move_cum_sums(moves), jax_utils.move_cum_sums(moves))
        seq = _bases(rs, rs.randint(0, 50)) + "N"
        assert reverse_complement(seq) == jax_reverse_complement(seq)


def _reads():
    """Planted concatemers (simplex and duplex, one junction without an
    adapter), two template-complement reads whose junction has no spike
    (the middle-adapter and middle-split finders), reads with nothing to
    split and an empty call."""
    rs = np.random.RandomState(21)
    reads = []
    for i in range(6):
        duplex = i % 2 == 1
        lengths = list(rs.randint(1000, 3001, 3 if i == 5 else rs.randint(2, 5)))
        c = concatemer(rs, lengths, STRIDE, duplex, adapter_free=(1,) if i == 5 else ())
        reads.append((c.seq, c.qstring, c.moves, c.signal, c))
    for adapter_free in ((), (0,)):
        c = concatemer(rs, [2000, 2000], STRIDE, True, adapter_free=adapter_free, quiet=(0,))
        reads.append((c.seq, c.qstring, c.moves, c.signal, "middle"))
    single = concatemer(rs, [2500], STRIDE, duplex=False, decoys=2)
    reads.append((single.seq, single.qstring, single.moves, single.signal, single))
    short = concatemer(rs, [300], STRIDE, duplex=False, decoys=0)
    reads.append((short.seq, short.qstring, short.moves, short.signal, short))
    reads.append(("", "", np.zeros(0, np.uint8), np.zeros(60, np.float32), None))
    return reads


@pytest.mark.parametrize("pa", [False, True], ids=["default", "pa"])
@pytest.mark.parametrize("simplex", [True, False], ids=["simplex", "duplex"])
def test_split_matches_jax(simplex, pa):
    ours = DuplexReadSplitter(DuplexSplitSettings.for_pa_scaling() if pa else DuplexSplitSettings())
    ref = JaxSplitter(JaxSettings.for_pa_scaling() if pa else JaxSettings())
    assert vars(ours.settings) == vars(ref.settings)
    ours.settings.simplex_mode = ref.settings.simplex_mode = simplex
    split_reads = 0
    for seq, qstring, moves, signal, planted in _reads():
        got = ours.split(seq, qstring, moves, signal, STRIDE)
        want = ref.split(seq, qstring, moves, signal, STRIDE)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a.seq, a.qstring, a.seq_range, a.signal_range) == (
                b.seq, b.qstring, b.seq_range, b.signal_range)
            np.testing.assert_array_equal(a.moves, b.moves)
            np.testing.assert_array_equal(a.signal, b.signal)
        if planted == "middle":
            assert len(got) == (1 if simplex else 2)
        elif planted is not None:
            # cut at each planted base: every junction in duplex mode, those
            # with an adapter in simplex mode
            cuts = [b for b, adapter in zip(planted.junctions, planted.with_adapter)
                    if adapter or not simplex]
            assert [s.seq for s in got] == planted.pieces(cuts)
            split_reads += len(got) > 1
    assert split_reads == 6
