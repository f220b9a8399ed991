"""Barcoding, poly(A) estimation and trimming in the port's basecall
finisher against the JAX pipeline's finisher and the JAX command's trimming,
on stitched calls planted with an adapter, an SQK-NBD114-24 barcode at each
end, the cDNA primers and a poly(A) tail whose signal is flat: BC, the RG
suffix with the sample sheet's alias for the read's run, pt/pa, the tag
order, the trimmed sequence, qualities and move table, and the per-barcode
read groups of the header. And the one divergence: a split read's subreads
get their poly(A) estimate from their own signal, where the JAX pipeline
reads the parent's signal with the subread's moves."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dorado_tpu.pipeline.basecaller as jax_pipeline_module
from dorado_tpu.demux import BarcodeClassifier as JaxClassifier
from dorado_tpu.demux.adapters import determine_trim_interval as jax_interval
from dorado_tpu.demux.adapters import find_adapters as jax_find_adapters
from dorado_tpu.demux.adapters import find_primers as jax_find_primers
from dorado_tpu.demux.trimmer import trim_record as jax_trim_record
from dorado_tpu.io import pod5 as jax_pod5
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.utils.sample_sheet import SampleSheet as JaxSampleSheet
import dorado_tpu_torch.pipeline.basecaller as port_pipeline_module
from dorado_tpu_torch.demux import BarcodeClassifier
from dorado_tpu_torch.demux.adapters import ADAPTERS, PRIMERS, ReadTrimmer
from dorado_tpu_torch.io import pod5
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config
from dorado_tpu_torch.pipeline import BasecallerPipeline
from dorado_tpu_torch.polytail import make_calculator
from dorado_tpu_torch.polytail.calculator import PolyTailConfig, ReadContext
from dorado_tpu_torch.utils.sample_sheet import SampleSheet
from dorado_tpu_torch.utils.sequence import reverse_complement
from tests.test_torch_runner import _narrow_hac, jax_params_with_moves
from tests.torch_concatemers import concatemer
from tests.torch_demux import barcoded_read, random_seq

KIT = "SQK-NBD114-24"
SSP, VNP = PRIMERS["PCS110"]
VNP_RC = reverse_complement(VNP)[4:]  # the VNP's trailing Ts are the tail's
SHEET = ("experiment_id,kit,flow_cell_id,position_id,barcode,alias,type\n"
         "exp-a,SQK-NBD114-24,FAB00001,X2,barcode03,donor_3,test_sample\n"
         "exp-a,SQK-NBD114-24,FAB00001,X2,barcode11,donor_11,test_sample\n"
         "exp-a,SQK-NBD114-24,FAB00001,X2,barcode20,donor_20,test_sample\n")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_info(module, i: int):
    return module.RunInfo(
        acquisition_id=f"acq{i}", sample_rate=5000, flow_cell_id=f"FAB0000{i}",
        flow_cell_product_code="FLO-MIN114", protocol_run_id=f"run{i}",
        acquisition_start_time_ms=1_700_000_000_000, sample_id="sample0",
        experiment_name="exp-a", sequencer_position=f"X{i + 1}")


def pod5_read(module, i: int, run: int):
    return module.Pod5Read(
        read_id=f"read-{i}", signal=np.zeros(10, np.int16), read_number=i, start_sample=0,
        median_before=200.0, channel=i + 1, well=1, pore_type="not_set",
        calibration_offset=0.0, calibration_scale=0.2, end_reason="signal_positive",
        end_reason_forced=False, open_pore_level=float("nan"), num_reads_since_mux_change=0,
        time_since_mux_change=0.0, num_minknow_events=3, tracked_scaling_scale=float("nan"),
        tracked_scaling_shift=float("nan"), predicted_scaling_scale=float("nan"),
        predicted_scaling_shift=float("nan"), run_info=run_info(module, run),
        filename="planted.pod5")


def planted_call(rng, barcode: str | None, tail: int, stride: int):
    """(seq, qstring, moves, signal) of a stitched call: the LSK110 adapter,
    ``barcode``'s context at both ends (or none), the PCS110 SSP primer (the
    poly(A) default's front anchor), an insert, ``tail`` As, the VNP
    primer's reverse complement; a move a base with 0-3 stays; noise of sd 1
    but a flat level over the tail."""
    body = SSP + random_seq(rng, 700) + "A" * tail + VNP_RC
    if barcode is None:
        seq = random_seq(rng, 90) + body + random_seq(rng, 80)
    else:
        core = barcoded_read(rng, KIT, barcode, 0)
        front, rear = core[:20 + 46], core[20 + 46:]
        seq = front + body + rear
    seq = ADAPTERS["LSK110"][0] + seq + ADAPTERS["LSK110"][1]
    tail_start = seq.index("A" * tail) if tail else 0
    stays = rng.randint(0, 4, len(seq))
    moves = np.zeros(len(seq) + int(stays.sum()), np.uint8)
    base_move = np.concatenate([[0], np.cumsum(stays + 1)[:-1]])
    moves[base_move] = 1
    signal = rng.normal(0.0, 1.0, len(moves) * stride).astype(np.float32)
    if tail:
        a, b = base_move[tail_start] * stride, base_move[tail_start + tail] * stride
        signal[a:b] = 1.1 + rng.normal(0.0, 0.05, b - a)
    qstring = "".join(chr(33 + q) for q in rng.randint(8, 35, len(seq)))
    return seq, qstring, moves, signal


def working_read(module, read, call, num_trimmed=10):
    seq, qstring, moves, signal = call
    res = SimpleNamespace(sequence=seq, qstring=qstring, moves=moves)
    return module._WorkingRead(
        read=read, scaled=signal.copy(), num_trimmed=num_trimmed, shift_pa=91.9, scale_pa=22.5,
        scaling_method="quantile", offsets=[0], chunk_sizes=[len(signal)], results=[res],
        pending=0)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """A JAX and a port pipeline on the narrow hac model with SQK-NBD114-24,
    the sample sheet (matched on each read's run) and poly(A) estimation;
    the port's also trims adapters and primers."""
    sheet = tmp_path_factory.mktemp("sheet") / "sheet.csv"
    sheet.write_text(SHEET)
    params = jax_params_with_moves(2)
    cfg = _narrow_hac(hac_v43_config())
    kw = dict(chunk_size=1200, batch_size=8, emit_moves=True, estimate_poly_a=True)
    jsheet, psheet = JaxSampleSheet(str(sheet)), SampleSheet(str(sheet))
    jp = jax_pipeline_module.BasecallerPipeline(
        _narrow_hac(jax_hac_config()), params, compute_dtype=jnp.float32,
        barcode_classifier=JaxClassifier(KIT, allowed_barcodes=jsheet.get_barcode_values()),
        sample_sheet=jsheet, **kw)
    tp = BasecallerPipeline(
        cfg, params_from_jax(params, cfg), device="cpu",
        barcode_classifier=BarcodeClassifier(KIT, allowed_barcodes=psheet.get_barcode_values()),
        sample_sheet=psheet, trimmer=ReadTrimmer(), **kw)
    return jp, tp


def jax_trim(rec):
    """The JAX command's --trim all on a finished record."""
    res = jax_find_adapters(rec.seq, None)
    jax_trim_record(rec, jax_interval(res, len(rec.seq)))
    res = jax_find_primers(rec.seq, None)
    jax_trim_record(rec, jax_interval(res, len(rec.seq)))
    return rec


def same_records(got, want):
    assert [r.qname for r in got] == [r.qname for r in want]
    for a, b in zip(want, got):
        assert (b.seq, b.qual, b.flag) == (a.seq, a.qual, a.flag)
        assert [t.tag for t in b.tags] == [t.tag for t in a.tags]
        for ta, tb in zip(a.tags, b.tags):
            if isinstance(ta.value, np.ndarray):
                np.testing.assert_array_equal(tb.value, ta.value)
                assert tb.value.dtype == ta.value.dtype and tb.subtype == ta.subtype
            else:
                assert (tb.type, tb.value) == (ta.type, ta.value), ta.tag


def test_finisher_matches_jax(pipelines):
    jp, tp = pipelines
    stride = tp.config.stride
    rng = np.random.RandomState(3)
    cases = [("NB03", 1, 60), ("NB11", 0, 90), ("NB07", 1, 45), (None, 1, 70), ("NB20", 1, 0)]
    tags = []
    for i, (barcode, run, tail) in enumerate(cases):
        call = planted_call(rng, barcode, tail, stride)
        want = [jax_trim(r) for r in jp._finish_read(
            working_read(jax_pipeline_module, pod5_read(jax_pod5, i, run), call))]
        got = tp._finish_read(working_read(port_pipeline_module, pod5_read(pod5, i, run), call))
        assert len(got) == 1
        same_records(got, want)
        rec = got[0]
        names = [t.tag for t in rec.tags]
        assert names.index("RG") < names.index("BC") < names.index("pt") < names.index("pa")
        assert names.index("pa") < names.index("po") < names.index("me")
        assert len(rec.seq) < len(call[0]) - 40  # adapters and primers cut
        tags.append({t.tag: t.value for t in rec.tags})
    # barcode03 of run 1 takes the sheet's alias; barcode11 is permitted but
    # run 0 is not the sheet's; barcode07 is not permitted
    assert [t["BC"] for t in tags] == ["donor_3", "NB24_barcode11", "unclassified",
                                       "unclassified", "donor_20"]
    assert tags[0]["RG"].endswith("_donor_3") and tags[2]["RG"] == "run1_" + tp.config.model_name
    pts = [t["pt"] for t in tags]
    assert pts[4] == -1 and sum(p > 0 for p in pts[:4]) >= 3
    assert abs(pts[0] - 60) < 25 and abs(pts[1] - 90) < 30


def test_header_barcode_groups_match_jax(pipelines):
    jp, tp = pipelines
    infos = [run_info(pod5, 0), run_info(pod5, 1), run_info(pod5, 1)]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_pipeline_module, "Pod5File",
               lambda f: SimpleNamespace(run_infos=[run_info(jax_pod5, int(str(f)[-1]))]))
    try:
        want = jp.build_header(["f0", "f1", "f1"], cli_line="x")
    finally:
        mp.undo()
    got = tp.build_header(infos, cli_line="x")
    assert got.read_groups == want.read_groups
    ids = [rg["ID"] for rg in got.read_groups]
    assert len(ids) == 2 + 2 * 3 and f"run1_{tp.config.model_name}_donor_3" in ids
    assert f"run0_{tp.config.model_name}_NB24_barcode03" in ids


def test_split_subreads_estimate_on_their_own_signal(pipelines):
    """A concatemer of three strands whose second holds the primers and a
    flat tail: the port's subread 1 gets the estimate of its own signal, with
    no trimmed samples; the JAX pipeline's uses the parent's signal with the
    subread's moves, which index the subread's signal, so its tail is not
    the planted one. The other subreads, with no primers, get -1 in both."""
    jp, tp = pipelines
    stride = tp.config.stride
    rng = np.random.RandomState(4)
    c = concatemer(rng, [1500, 2200, 1800], stride, duplex=False)
    lo, hi = c.junctions
    start, end = lo + 60, hi - 40
    insert = end - start - len(SSP) - 80 - len(VNP_RC)
    middle = SSP + random_seq(rng, insert) + "A" * 80 + VNP_RC
    seq = c.seq[:start] + middle + c.seq[end:]
    base_move = np.flatnonzero(c.moves)
    t0 = seq.index("A" * 80, start)
    signal = c.signal.copy()
    a, b = base_move[t0] * stride, base_move[t0 + 80] * stride
    signal[a:b] = 1.1 + rng.normal(0.0, 0.05, b - a)
    call = (seq, c.qstring, c.moves, signal)
    want = jp._finish_read(working_read(jax_pipeline_module, pod5_read(jax_pod5, 0, 1), call))
    got = tp._finish_read(working_read(port_pipeline_module, pod5_read(pod5, 0, 1), call))
    assert [r.qname for r in got] == [r.qname for r in want] == ["read-0:0", "read-0:1",
                                                                 "read-0:2"]
    subs = tp.read_splitter.split(seq, c.qstring, c.moves, signal, stride)
    calc = make_calculator(PolyTailConfig())
    pts = []
    for i, (sub, rec, jrec) in enumerate(zip(subs, got, want)):
        ours = calc.calculate_num_bases(ReadContext(
            seq=sub.seq, moves=sub.moves, signal=sub.signal, stride=stride,
            flow_cell_product_code="FLO-MIN114"))
        theirs = calc.calculate_num_bases(ReadContext(
            seq=sub.seq, moves=sub.moves, signal=signal, stride=stride, num_trimmed_samples=10,
            flow_cell_product_code="FLO-MIN114"))
        tags = {t.tag: t.value for t in rec.tags}
        jtags = {t.tag: t.value for t in jrec.tags}
        pa = [ours.signal_anchor, *ours.signal_range, *ours.split_signal_range]
        assert tags["pt"] == ours.num_bases and list(tags["pa"]) == pa
        assert jtags["pt"] == theirs.num_bases
        pts.append((tags["pt"], jtags["pt"]))
    assert pts[0] == pts[2] == (-1, -1)
    assert abs(pts[1][0] - 80) < 25 and pts[1][1] != pts[1][0]
