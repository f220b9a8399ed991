"""Simplex basecalling pipeline: reads -> scaled chunks -> device engine -> BAM.

Port of ``dorado_tpu/pipeline/basecaller.py::BasecallerPipeline`` for
simplex DNA and direct-RNA basecalling with read splitting (on by default:
for DNA the simplex chain of ``splitter.DuplexReadSplitter`` on the calls,
for RNA ``splitter.RNAReadSplitter`` on the raw signal before scaling), the
read filters (``min_qscore``, ``skip_read_ids``, ``only_read_ids``,
``max_reads``), modified-base
calling (``modbase_caller``: MN/MM/ML tags), barcode classification
(``barcode_classifier``, ``barcode_both_ends``, ``sample_sheet``: BC tags,
the RG suffix and per-barcode read groups) and poly(A) estimation
(``estimate_poly_a``, ``poly_a_config``: pt/pa tags). An RNA model's reads
lose their DNA adapter (``Scaler(is_rna=True)``, also for a DNA model with
``force_rna_adapter_trim``) in place of the DNA signal trim, and their calls
are reversed to 5'->3' after the mux-change trim; their mean q-score skips
the poly(A) tail. ``run`` basecalls
the POD5 files under a path, ``run_reads`` any iterable of reads; both
admit reads through the same gate. ``device`` goes to the runner (one model
replica on each visible card by default, as the JAX pipeline takes a mesh);
a modbase caller stays on its own device. Host code is
a *feeder* (gate + scale + trim + chunk + batch fill) and a *finisher*
(stitch + split + tags + modbase + filter + write) around
``TorchBasecallRunner``; the device computes batch k+1 while the host
finishes batch k. With a modbase caller, the finisher threads share its
device batches through a ``ModBaseBatchScheduler`` made for each run.
With a ``trimmer`` (``demux.adapters.ReadTrimmer``, the CLI's ``--trim``)
the finisher threads cut adapters and primers from each record that passes
the filters, after its modbase tags, as the JAX command trims records
before it writes them; with an ``aligner`` (``alignment.aligner.RecordAligner``,
the CLI's ``--reference``) they then map it.

A split read's subreads get their poly(A) estimate from their own signal
with no trimmed samples (the ``ts:i:0`` of their records), where the JAX
pipeline passes the parent's signal and trim with the subread's moves,
which index the subread's signal.

Per-read semantics follow ScalerNode (dorado/read_pipeline/nodes/
ScalerNode.cpp:143-270), BasecallerNode chunking/stitch (BasecallerNode.cpp:
96-286) and ReadCommon tag generation (read_pipeline/base/messages.cpp:43-130).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from dorado_tpu_torch.alignment.aligner import RecordAligner
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
from dorado_tpu_torch.config import BasecallModelConfig
from dorado_tpu_torch.demux.adapters import ReadTrimmer
from dorado_tpu_torch.demux.barcoder import (
    UNCLASSIFIED,
    BarcodeClassifier,
    normalize_barcode_name,
)
from dorado_tpu_torch.io.pod5 import Pod5File, Pod5Read, RunInfo, find_pod5_files
from dorado_tpu_torch.io.sam import SamHeader, SamRecord, SamTag
from dorado_tpu_torch.modbase.caller import ModBaseBatchScheduler, ModBaseCaller
from dorado_tpu_torch.modbase.tags import generate_modbase_tags, modbase_threshold_uint8
from dorado_tpu_torch.models.crf_model import LSTMCRFModel
from dorado_tpu_torch.models.tx_model import TxModel
from dorado_tpu_torch.pipeline.host import OrderedPool, OrderedSink, default_host_threads
from dorado_tpu_torch.polytail import PolyTailCalculatorSelector
from dorado_tpu_torch.polytail.calculator import PolyTailCalculator, ReadContext
from dorado_tpu_torch.signal.chunk import generate_chunks
from dorado_tpu_torch.signal.scaling import Scaler
from dorado_tpu_torch.signal.stitch import CalledChunk, stitch_chunks
from dorado_tpu_torch.signal.trim import trim_signal
from dorado_tpu_torch.splitter import DuplexReadSplitter, DuplexSplitSettings, RNAReadSplitter
from dorado_tpu_torch.utils.read_trim import mux_change_trim
from dorado_tpu_torch.utils.sample_sheet import SampleSheet
from dorado_tpu_torch.utils.sequence import find_rna_polya, mean_qscore_from_qstring
from dorado_tpu_torch.utils.time_utils import timestamp_from_unix_ms


@dataclass
class PipelineStats:
    reads_called: int = 0
    reads_skipped: int = 0  # POD5 rows that failed to decode (``run``)
    samples_processed: int = 0  # real samples fed to the model (excl. padding)
    samples_incl_padding: int = 0  # incl. the repeat-padding of short chunks
    bases_called: int = 0
    batches: int = 0
    elapsed_s: float = 0.0
    # wall time with no batch in flight on the device while the run loop was
    # live: the host-starvation metric
    device_idle_s: float = 0.0
    # wall time the host spent blocked in runner.finish() waiting for the
    # device: large values mean the device, not the host, is the bottleneck
    finish_wait_s: float = 0.0
    dispatch_wait_s: float = 0.0  # blocked in the dispatch call
    device_fetch_s: float = 0.0  # blocked on the device results
    host_decode_s: float = 0.0  # compacting calls on the host
    # cumulative time inside _finish_read across sink worker threads
    # (thread-seconds: can exceed wall time)
    host_finish_s: float = 0.0

    @property
    def device_idle_frac(self) -> float:
        return self.device_idle_s / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def samples_per_s(self) -> float:
        return self.samples_processed / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def bases_per_s(self) -> float:
        return self.bases_called / self.elapsed_s if self.elapsed_s else 0.0


@dataclass
class _WorkingRead:
    read: Pod5Read
    scaled: np.ndarray
    num_trimmed: int
    shift_pa: float
    scale_pa: float
    scaling_method: str
    offsets: list[int]
    chunk_sizes: list[int]
    results: list = field(default_factory=list)
    pending: int = 0


class BasecallerPipeline:
    def __init__(
        self,
        config: BasecallModelConfig,
        model: LSTMCRFModel | TxModel,
        chunk_size: int | None = None,
        batch_size: int | None = None,
        overlap: int | None = None,
        emit_moves: bool = False,
        device: torch.device | str | None = None,
        decoder: str = "viterbi",
        lstm_precision: str | None = None,
        tx_precision: str | None = None,
        tx_attention: str | None = None,
        tx_fused_norm: bool | None = None,
        compute_dtype: torch.dtype | None = None,
        split_reads: bool = True,
        min_qscore: float = 0.0,
        skip_read_ids: set | None = None,
        only_read_ids: set | None = None,
        max_reads: int | None = None,
        modbase_caller: ModBaseCaller | None = None,
        modbase_threshold: float = 0.05,
        barcode_classifier: BarcodeClassifier | None = None,
        barcode_both_ends: bool = False,
        sample_sheet: SampleSheet | None = None,
        estimate_poly_a: bool = False,
        poly_a_config=None,
        trimmer: ReadTrimmer | None = None,
        aligner: RecordAligner | None = None,
        force_rna_adapter_trim: bool = False,
    ):
        self.config = config
        if not config.has_normalised_basecaller_params():
            config.normalise_basecaller_params()
        self.runner = TorchBasecallRunner(
            config,
            model,
            chunk_size=chunk_size,
            batch_size=batch_size,
            device=device,
            decoder=decoder,
            lstm_precision=lstm_precision,
            tx_precision=tx_precision,
            tx_attention=tx_attention,
            tx_fused_norm=tx_fused_norm,
            compute_dtype=compute_dtype,
        )
        self.overlap = int(overlap if overlap is not None else config.basecaller.overlap)
        self.overlap -= self.overlap % config.stride
        self.emit_moves = emit_moves
        self.modbase_caller = modbase_caller
        self.modbase_threshold = modbase_threshold
        self.barcode_classifier = barcode_classifier
        self.barcode_both_ends = barcode_both_ends
        self.sample_sheet = sample_sheet
        # per-barcode calculator selection, keyed on the read's classified
        # barcode (PolyACalculatorNode.cpp:46); poly_a_config is one
        # PolyTailConfig or a {barcode: config} dict from load_poly_tail_configs
        self.poly_tail_selector = None
        if estimate_poly_a:
            self.poly_tail_selector = PolyTailCalculatorSelector(
                poly_a_config,
                is_rna=config.is_rna_model,
                speed=config.polya_speed_correction,
                offset=config.polya_offset_correction,
            )
        self.trimmer = trimmer
        # inline alignment (AlignerNode in the basecall pipeline,
        # pipeline_creation.cpp): each record that passes the filters is
        # mapped on the finish threads, before it reaches the writer
        self.aligner = aligner
        self._modbase_scheduler: ModBaseBatchScheduler | None = None  # one a run
        self.read_splitter = None
        self.rna_splitter = None
        if split_reads and config.is_rna_model:
            # RNA reads split in signal space before scaling
            # (pipeline_creation.cpp:56-63 prepends the RNA ReadSplitNode)
            self.rna_splitter = RNAReadSplitter()
        elif split_reads:
            pa = config.signal_norm_params.standardisation.standardise
            self.read_splitter = DuplexReadSplitter(
                DuplexSplitSettings.for_pa_scaling() if pa else DuplexSplitSettings()
            )
            # the simplex pipeline runs the reduced finder chain (ReadSplitNode
            # in simplex mode, pipeline_creation.cpp:84-99)
            self.read_splitter.settings.simplex_mode = True
        self.min_qscore = min_qscore
        self.skip_read_ids = skip_read_ids or set()
        self.only_read_ids = only_read_ids  # --read-ids allow-list
        self.max_reads = max_reads
        self._reads_fed = 0  # reads admitted by _gate_read over the pipeline's life
        self.reads_filtered = 0  # records dropped by min_qscore
        self.scaler = Scaler(config.signal_norm_params,
                             is_rna=config.is_rna_model or force_rna_adapter_trim)
        self.stats = PipelineStats()
        self._stats_lock = threading.Lock()
        self._inflight_total = 0  # batches dispatched but not yet harvested
        self._idle_mark: float | None = None  # when inflight last hit zero
        # one batching lane per configured chunk size
        self._lanes = [
            {
                "buffer": self.runner.make_input_buffer(i),
                "spare": self.runner.make_input_buffer(i),
                "batch": [],  # (read, chunk index)
                "inflight": None,  # (device handle, batch)
            }
            for i in range(len(self.runner.chunk_sizes))
        ]

    def sample_stats(self) -> dict:
        """The pipeline's and the runner's counters under the JAX
        pipeline's names: a ``StatsSampler`` provider (``--dump-stats-file``'s
        ``basecaller.`` columns)."""
        rs = self.runner.stats
        return {
            "reads_called": self.stats.reads_called,
            "bases_called": self.stats.bases_called,
            "samples_processed": self.stats.samples_processed,
            "samples_incl_padding": self.stats.samples_incl_padding,
            "batches_called": rs.batches_called,
            "chunks_called": rs.chunks_called,
            "reads_filtered": self.reads_filtered,
            "batch_queue_depth": sum(len(lane["batch"]) for lane in self._lanes),
            "device_idle_s": round(self.stats.device_idle_s, 4),
            "finish_wait_s": round(self.stats.finish_wait_s, 4),
            "dispatch_wait_s": round(rs.dispatch_s, 4),
            "device_fetch_s": round(rs.fetch_s, 4),
            "host_decode_s": round(rs.host_decode_s, 4),
            "host_finish_s": round(self.stats.host_finish_s, 4),
        }

    # ------------------------------------------------------------------
    # header
    # ------------------------------------------------------------------

    def build_header(
        self, sources: Iterable[RunInfo | Path | str], cli_line: str = ""
    ) -> SamHeader:
        """@PG plus one @RG per distinct protocol run, in order of first
        appearance, and with a barcode classifier one more for each of those
        and each barcode of the kit that the sample sheet permits.
        ``sources`` are run infos or POD5 files, whose run infos are read (as
        the JAX pipeline's ``build_header`` takes files)."""
        run_infos = []
        for src in sources:
            run_infos += [src] if isinstance(src, RunInfo) else Pod5File(src).run_infos
        header = SamHeader()
        header.programs.append(
            {
                "ID": "basecaller",
                "PN": "dorado_tpu_torch",
                "VN": "0.1.0",
                "CL": cli_line or "dorado_tpu_torch basecaller",
            }
        )
        seen: dict[str, dict] = {}
        # each read group's sample-sheet index (flow_cell_id, position_id,
        # experiment_id), the first run's where runs share a group, so that
        # aliases resolve per run (bam_utils.cpp:103-112)
        sheet_index: dict[str, tuple[str, str, str]] = {}
        for ri in run_infos:
            rg_id = f"{ri.protocol_run_id}_{self.config.model_name}"
            sheet_index.setdefault(
                rg_id, (ri.flow_cell_id, ri.sequencer_position, ri.experiment_name))
            if rg_id in seen:
                continue
            started = timestamp_from_unix_ms(ri.acquisition_start_time_ms)
            seen[rg_id] = {
                "ID": rg_id,
                "PU": ri.flow_cell_id or "unknown",
                "PM": ri.system_name or "unknown",
                "DT": started,
                "PL": "ONT",
                "DS": (
                    f"runid={ri.protocol_run_id or 'unknown'}"
                    f" basecall_model={self.config.model_name}"
                    f" acquisition_start_time={started}"
                    f" model_stride={self.config.stride}"
                ),
                "LB": ri.sample_id or "unknown",
            }
        header.read_groups = list(seen.values())
        if self.barcode_classifier is not None:
            header.read_groups += self._barcode_read_groups(header.read_groups, sheet_index)
        return header

    def _barcode_read_groups(self, base_groups: list[dict], sheet_index: dict) -> list[dict]:
        """One read group for each base group and each kit barcode the
        sample sheet permits, with BC, bk, SM and al fields and the sheet's
        alias as its suffix where it has one (bam_utils.cpp
        add_barcode_kit_rg_hdrs)."""
        classifier, sheet = self.barcode_classifier, self.sample_sheet
        info = classifier.kit_info
        groups = []
        for barcode_name in info["barcodes"]:
            norm = normalize_barcode_name(barcode_name)
            if sheet is not None and not (
                sheet.barcode_is_permitted(norm) or sheet.barcode_is_permitted(barcode_name)
            ):
                continue
            for rg in base_groups:
                fc, pos, exp = sheet_index.get(rg["ID"], ("", "", ""))
                alias = sheet.get_alias(norm, fc, pos, exp) if sheet is not None else ""
                groups.append({
                    **rg,
                    "ID": f"{rg['ID']}_{alias or info['name'] + '_' + norm}",
                    "BC": classifier.barcode_sequence(barcode_name),
                    "bk": classifier.kit_name,
                    "SM": norm,
                    "al": alias or norm,
                })
        return groups

    # ------------------------------------------------------------------
    # per-read feed
    # ------------------------------------------------------------------

    def _scale_and_trim(self, read: Pod5Read) -> tuple[np.ndarray, int, float, float, str]:
        strategy = self.config.signal_norm_params.strategy
        # the scaler drops an RNA read's DNA adapter (rna_trim samples; 0 for a
        # DNA model without force_rna_adapter_trim)
        scaled, trim, result = self.scaler.scale_read(
            read.signal,
            read_scale=read.calibration_scale,
            read_offset=read.calibration_offset,
            open_pore_level=read.open_pore_level,
            flow_cell_product_code=read.run_info.flow_cell_product_code,
        )
        if not self.config.is_rna_model:
            if self.config.signal_norm_params.standardisation.standardise:
                # kit14 pA-standardised data: constant trim (ScalerNode.cpp:238-243)
                dna_trim = 10
            else:
                dna_trim = trim_signal(scaled[: min(8000, len(scaled) // 2)])
            if dna_trim < len(scaled):
                scaled = scaled[dna_trim:]
            else:
                dna_trim = 0
            # both trims count toward ts and ns
            trim += dna_trim
        # tags report shift/scale in pA space (ScalerNode.cpp:231-234)
        shift_pa = read.calibration_scale * (result.shift + read.calibration_offset)
        scale_pa = read.calibration_scale * result.scale
        return scaled.astype(np.float32), trim, shift_pa, scale_pa, strategy.value

    def _gate_read(self, read: Pod5Read) -> bool:
        """--resume-from skip, --read-ids and --max-reads admission, in that
        order (main thread only)."""
        if read.read_id in self.skip_read_ids:
            return False
        if self.only_read_ids is not None and read.read_id not in self.only_read_ids:
            return False
        if self.max_reads is not None and self._reads_fed >= self.max_reads:
            return False
        self._reads_fed += 1
        return True

    def _prepare_read(self, read: Pod5Read) -> list[_WorkingRead]:
        """RNA signal split + scale/trim + chunk layout. Thread-safe: touches
        no pipeline state, so the run loop fans it out on the scale pool."""
        subreads = [read]
        if self.rna_splitter is not None:
            ranges = self.rna_splitter.split(read.signal)
            if len(ranges) > 1:
                subreads = [
                    replace(read, read_id=f"{read.read_id}:{i}", signal=read.signal[s:e],
                            read_number=-1, start_sample=read.start_sample + s)
                    for i, (s, e) in enumerate(ranges)
                ]
        out = []
        for sub in subreads:
            scaled, trimmed, shift_pa, scale_pa, method = self._scale_and_trim(sub)
            if len(scaled) == 0:
                continue
            offsets = generate_chunks(
                len(scaled), self.runner.chunk_size, self.config.stride, self.overlap
            )
            sizes = [min(self.runner.chunk_size, len(scaled) - off) for off in offsets]
            wr = _WorkingRead(
                read=sub,
                scaled=scaled,
                num_trimmed=trimmed,
                shift_pa=shift_pa,
                scale_pa=scale_pa,
                scaling_method=method,
                offsets=offsets,
                chunk_sizes=sizes,
            )
            wr.results = [None] * len(offsets)
            wr.pending = len(offsets)
            out.append(wr)
        return out

    def _feed_read(self, read: Pod5Read, flush_cb) -> None:
        """Admit, prepare and feed one read on this thread, without the
        scale pool: the duplex pipeline's feed."""
        if not self._gate_read(read):
            return
        for wr in self._prepare_read(read):
            self._feed_prepared(wr, flush_cb)

    def _feed_prepared(self, wr: _WorkingRead, flush_cb) -> None:
        self.stats.samples_processed += len(wr.scaled)
        for ci, off in enumerate(wr.offsets):
            size = wr.chunk_sizes[ci]
            lane = self._lanes[self.runner.lane_for(size)]
            idx = len(lane["batch"])
            self.runner.accept_chunk(lane["buffer"], idx, wr.scaled[off : off + size])
            lane["batch"].append((wr, ci))
            if len(lane["batch"]) == lane["buffer"].shape[0]:
                flush_cb()

    def _flush_batch(self, finished: list[_WorkingRead], force: bool = False) -> None:
        """Dispatch full lanes (all lanes when ``force``) and harvest the
        batches dispatched before: the device computes batch k+1 while the
        host decodes batch k (the stream overlap of CudaCaller.cpp:634)."""
        for lane in self._lanes:
            rows = lane["buffer"].shape[0]
            if lane["batch"] and (force or len(lane["batch"]) == rows):
                n = len(lane["batch"])
                if self._inflight_total == 0 and self._idle_mark is not None:
                    self.stats.device_idle_s += time.perf_counter() - self._idle_mark
                handle = self.runner.dispatch(lane["buffer"], n)
                self._inflight_total += 1
                self.stats.batches += 1
                self.stats.samples_incl_padding += n * lane["buffer"].shape[1]
                inflight = (handle, lane["batch"])
                lane["batch"] = []
                lane["buffer"], lane["spare"] = lane["spare"], lane["buffer"]
            else:
                inflight = None

            if lane["inflight"] is not None:
                handle, batch = lane["inflight"]
                t_wait = time.perf_counter()
                decoded = self.runner.finish(handle)
                self.stats.finish_wait_s += time.perf_counter() - t_wait
                self._inflight_total -= 1
                if self._inflight_total == 0:
                    self._idle_mark = time.perf_counter()
                for (wr, ci), chunk in zip(batch, decoded):
                    wr.results[ci] = chunk
                    wr.pending -= 1
                    if wr.pending == 0:
                        finished.append(wr)
            lane["inflight"] = inflight

    def _drain(self, finished: list[_WorkingRead]) -> None:
        """Flush any partial batches and harvest all in-flight work."""
        self._flush_batch(finished, force=True)
        self._flush_batch(finished, force=True)

    # ------------------------------------------------------------------
    # finish: stitch + record
    # ------------------------------------------------------------------

    def _finish_read(self, wr: _WorkingRead) -> list[SamRecord]:
        t_start = time.perf_counter()
        try:
            return self._finish_read_inner(wr)
        finally:
            dt = time.perf_counter() - t_start
            with self._stats_lock:
                self.stats.host_finish_s += dt

    def _finish_read_inner(self, wr: _WorkingRead) -> list[SamRecord]:
        called = [
            CalledChunk(
                seq=res.sequence,
                qstring=res.qstring,
                moves=np.asarray(res.moves, dtype=np.uint8),
                input_offset=off,
                raw_chunk_size=size,
            )
            for res, off, size in zip(wr.results, wr.offsets, wr.chunk_sizes)
        ]
        stitched = stitch_chunks(called, self.config.stride, len(wr.scaled))
        # mux-change/unblock trimming: the garbage is at the pore-exit end
        # (BasecallerNode.cpp:251-254)
        seq, qstring, moves, wr.scaled = mux_change_trim(
            stitched.seq, stitched.qstring, stitched.moves, wr.scaled,
            self.config.stride, wr.read.end_reason,
        )
        if self.config.is_rna_model:
            # RNA is sequenced 3'->5': emit it 5'->3' (BasecallerNode.cpp:251-259)
            seq, qstring = seq[::-1], qstring[::-1]
            moves = np.ascontiguousarray(moves[::-1])
        parts = [(seq, qstring, moves, wr.scaled, None)]
        if self.read_splitter is not None and len(seq):
            subs = self.read_splitter.split(seq, qstring, moves, wr.scaled, self.config.stride)
            if len(subs) > 1:
                parts = [(s.seq, s.qstring, s.moves, s.signal, s.signal_range[0]) for s in subs]

        records = []
        for i, (s_seq, s_q, s_moves, s_signal, split_point) in enumerate(parts):
            rec = self._make_record(wr, s_seq, s_q, s_moves)
            # a subread's signal starts at its own first sample (its ts is 0)
            s_trimmed = wr.num_trimmed if len(parts) == 1 else 0
            if len(parts) > 1:
                # split subreads: derived id, pi parent tag, sp split point,
                # rn = -1, sample counts of the subread's signal
                # (messages.cpp:95-108). The splitter gives every subread the
                # signal range (0, len), so sp is always 0, as in the JAX
                # pipeline; st keeps the parent's start time.
                rec.qname = f"{wr.read.read_id}:{i}"
                rec.tags.append(SamTag("pi", "Z", wr.read.read_id))
                rec.tags.append(SamTag("sp", "i", split_point))
                sample_rate = wr.read.run_info.sample_rate or self.config.sample_rate
                for t in rec.tags:
                    if t.tag == "rn":
                        t.value = -1
                    elif t.tag == "ns":
                        t.value = len(s_signal)
                    elif t.tag == "ts":
                        t.value = 0
                    elif t.tag == "du":
                        t.value = len(s_signal) / float(max(1, sample_rate))
            barcode = None
            if self.barcode_classifier is not None and len(s_seq):
                barcode = self._add_barcode_tags(rec, s_seq, wr.read.run_info)
            if self.poly_tail_selector is not None and len(s_seq):
                calculator = self.poly_tail_selector.get_calculator(barcode)
                if calculator is not None:
                    self._add_poly_a_tags(calculator, rec, wr.read.run_info, s_seq, s_moves,
                                          s_signal, s_trimmed)
            # pore type / end reason / minknow event count close the read-tag
            # block (messages.cpp:134-147 order)
            if wr.read.pore_type:
                rec.tags.append(SamTag("po", "Z", wr.read.pore_type))
            if wr.read.end_reason:
                rec.tags.append(SamTag("er", "Z", wr.read.end_reason))
            rec.tags.append(SamTag("me", "I", wr.read.num_minknow_events & 0xFFFFFFFF))
            if self.modbase_caller is not None and len(s_seq):
                self._add_modbase_tags(rec, s_seq, s_moves, s_signal)
            if self.min_qscore > 0:
                qs = next((t.value for t in rec.tags if t.tag == "qs"), 0.0)
                if qs < self.min_qscore:
                    with self._stats_lock:
                        self.reads_filtered += 1
                    continue
            # counted only for records that pass the qscore filter, so
            # reads_called + reads_filtered never double-counts
            with self._stats_lock:
                self.stats.reads_called += 1
                self.stats.bases_called += len(s_seq)
            if self.trimmer is not None:
                self.trimmer.trim(rec)
            records.append(rec)
            if self.aligner is not None:
                records += self.aligner.align(rec)
        return records

    def _add_barcode_tags(self, rec: SamRecord, seq: str, run_info: RunInfo) -> str:
        """Classify ``seq``; append BC (the sheet's alias for the read's run
        where it has one) and suffix RG with it for a classified read
        (BarcodeClassifierNode.cpp:212-221, messages.cpp:27-40). Returns
        the BC value."""
        classifier = self.barcode_classifier
        result = classifier.classify(seq, barcode_both_ends=self.barcode_both_ends)
        if result.barcode_name == UNCLASSIFIED:
            bc = UNCLASSIFIED
        else:
            bc = f"{classifier.kit_info['name']}_{normalize_barcode_name(result.barcode_name)}"
            if self.sample_sheet is not None:
                alias = self.sample_sheet.get_alias(
                    bc, run_info.flow_cell_id, run_info.sequencer_position,
                    run_info.experiment_name)
                if alias:
                    bc = alias
            for t in rec.tags:
                if t.tag == "RG":
                    t.value = f"{t.value}_{bc}"
        rec.tags.append(SamTag("BC", "Z", bc))
        return bc

    def _add_poly_a_tags(self, calculator: PolyTailCalculator, rec: SamRecord,
                         run_info: RunInfo, seq: str, moves, signal: np.ndarray,
                         num_trimmed: int) -> None:
        """pt (the tail's bases, -1 where estimation failed) and pa (anchor,
        signal range and split signal range in untrimmed samples)."""
        result = calculator.calculate_num_bases(ReadContext(
            seq=seq, moves=np.asarray(moves), signal=signal, stride=self.config.stride,
            num_trimmed_samples=num_trimmed,
            flow_cell_product_code=run_info.flow_cell_product_code,
        ))
        rec.tags.append(SamTag("pt", "i", result.num_bases if result.num_bases >= 0 else -1))
        pa = np.array([result.signal_anchor, *result.signal_range,
                       *result.split_signal_range], dtype=np.int32)
        rec.tags.append(SamTag("pa", "B", pa, subtype="i"))

    def _add_modbase_tags(self, rec: SamRecord, seq: str, moves, scaled_signal) -> None:
        """MN, MM and ML of one record (a read or a subread, on its own
        signal), after the read tags (messages.cpp:134-147 order)."""
        if self._modbase_scheduler is not None:
            # the finisher threads share device batches
            prepared = self.modbase_caller.prepare_read(seq, np.asarray(moves), scaled_signal)
            result = self._modbase_scheduler.call(prepared)
        else:
            result = self.modbase_caller.call_read(seq, np.asarray(moves), scaled_signal)
        mm, ml, mn = generate_modbase_tags(
            seq, result.base_mod_probs, result.info, result.motif_hits,
            modbase_threshold_uint8(self.modbase_threshold),
        )
        rec.tags.append(SamTag("MN", "i", mn))
        rec.tags.append(SamTag("MM", "Z", mm))
        rec.tags.append(SamTag("ML", "B", ml, subtype="C"))

    def _mean_qscore(self, seq: str, qstring: str) -> float:
        if self.config.is_rna_model:
            # over the bases before the poly(A) tail
            polya = find_rna_polya(seq)
            return mean_qscore_from_qstring(qstring[:polya] if polya else qstring)
        start = self.config.mean_qscore_start_pos
        if start < 0:
            start = 60
        if len(qstring) <= start:
            return mean_qscore_from_qstring(qstring)
        return mean_qscore_from_qstring(qstring[start:])

    def _make_record(
        self, wr: _WorkingRead, seq: str, qstring: str, moves: np.ndarray
    ) -> SamRecord:
        read = wr.read
        ri = read.run_info
        sample_rate = ri.sample_rate or self.config.sample_rate
        num_samples = len(wr.scaled)
        start_ms = ri.acquisition_start_time_ms + (read.start_sample * 1000) // max(
            1, sample_rate
        )
        tags = [
            SamTag("qs", "f", self._mean_qscore(seq, qstring)),
            SamTag("du", "f", (num_samples + wr.num_trimmed) / float(max(1, sample_rate))),
            SamTag("ns", "i", num_samples + wr.num_trimmed),
            SamTag("ts", "i", wr.num_trimmed),
            SamTag("mx", "i", read.well),
            SamTag("ch", "i", read.channel),
            SamTag("st", "Z", timestamp_from_unix_ms(start_ms)),
            SamTag("rn", "i", read.read_number),
            SamTag("fn", "Z", read.filename),
            SamTag("sm", "f", wr.shift_pa),
            SamTag("sd", "f", wr.scale_pa),
            SamTag("sv", "Z", wr.scaling_method),
            SamTag("dx", "i", 0),
            SamTag("RG", "Z", f"{ri.protocol_run_id}_{self.config.model_name}"),
        ]
        if self.emit_moves:
            mv = np.concatenate([[np.uint8(self.config.stride)], moves.astype(np.uint8)])
            tags.append(SamTag("mv", "B", mv, subtype="c"))
        return SamRecord(qname=read.read_id, seq=seq, qual=qstring, tags=tags)

    # ------------------------------------------------------------------
    # run
    # ------------------------------------------------------------------

    def run(
        self,
        input_path: Path | str,
        writer,
        recursive: bool = False,
        max_seconds: float | None = None,
    ) -> PipelineStats:
        """Basecall every read of every POD5 file under ``input_path`` (a
        file or a directory, searched recursively when asked) into
        ``writer``. Each read's ``fn`` tag names its file; rows that fail to
        decode are skipped and counted in ``reads_skipped``. ``max_seconds``
        as for ``run_reads``."""
        files = find_pod5_files(input_path, recursive=recursive)
        skipped = 0

        def reads():
            nonlocal skipped
            for f in files:
                reader = Pod5File(f)
                try:
                    for read in reader.reads():
                        read.filename = f.name
                        yield read
                finally:
                    skipped += reader.reads_skipped

        source = reads()
        try:
            stats = self.run_reads(source, writer, max_seconds=max_seconds)
        finally:
            source.close()  # a deadline leaves the generator open: count its skips
        stats.reads_skipped = skipped
        return stats

    def run_reads(
        self,
        reads: Iterable[Pod5Read],
        writer,
        max_seconds: float | None = None,
    ) -> PipelineStats:
        """Basecall every read of ``reads`` that the gate admits (the
        ``skip_read_ids``, ``only_read_ids`` and ``max_reads`` of the
        pipeline) and write its records to ``writer``, in input order: one
        per read, or one per subread of a split read, less those under
        ``min_qscore``. Once ``max_reads`` reads were admitted, no further
        read is taken from ``reads``. ``max_seconds`` time-boxes the run: no
        new reads are fed after the deadline; in-flight reads still finish."""
        t0 = time.perf_counter()
        self.stats = PipelineStats()
        rs_before = self.runner.stats
        self._idle_mark = t0  # initial fill counts as device idle
        self._inflight_total = 0
        deadline = t0 + max_seconds if max_seconds is not None else None
        finished: list[_WorkingRead] = []
        workers = default_host_threads()
        if workers > 0 and self.modbase_caller is not None:
            self._modbase_scheduler = ModBaseBatchScheduler(self.modbase_caller)
        # scale pool ahead of the feed loop; finish pool behind the device
        # step; records written on this thread in submission order
        scale_pool = OrderedPool(self._prepare_read, workers)
        finish_sink = OrderedSink(
            self._finish_read, lambda recs: [writer.write(r) for r in recs], workers
        )

        def flush():
            self._flush_batch(finished)
            for wr in finished:
                finish_sink.submit(wr)
            finished.clear()
            finish_sink.drain_ready()

        def gated_reads():
            if self.max_reads is not None and self._reads_fed >= self.max_reads:
                return
            for read in reads:
                if deadline is not None and time.perf_counter() > deadline:
                    return
                if self._gate_read(read):
                    yield read
                if self.max_reads is not None and self._reads_fed >= self.max_reads:
                    return  # take no further read: each would be decoded for nothing

        try:
            for prepared in scale_pool.map(gated_reads()):
                for wr in prepared:
                    self._feed_prepared(wr, flush)
            self._drain(finished)
            for wr in finished:
                finish_sink.submit(wr)
            finished.clear()
        finally:
            finish_sink.shutdown()
            scale_pool.shutdown()
            if self._modbase_scheduler is not None:
                self._modbase_scheduler.close()
                self._modbase_scheduler = None
        self.stats.elapsed_s = time.perf_counter() - t0
        rs_after = self.runner.stats
        self.stats.dispatch_wait_s = rs_after.dispatch_s - rs_before.dispatch_s
        self.stats.device_fetch_s = rs_after.fetch_s - rs_before.fetch_s
        self.stats.host_decode_s = rs_after.host_decode_s - rs_before.host_decode_s
        return self.stats
