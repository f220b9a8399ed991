"""Stereo duplex basecalling pipeline.

Port of ``dorado_tpu/duplex/pipeline.py`` (after the reference's stereo
path, dorado/api/pipeline_creation.cpp:122-201 and dorado/cli/cli_lib/
duplex.cpp:472-620): simplex-call reads in channel order with moves, pair
template and complement calls, align each pair's calls, build the
13-feature stereo tensor, basecall it with the stereo CRF model on a second
``TorchBasecallRunner``, and write the duplex records (``dx:1``) as they are
found, then every simplex record (``dx:-1`` on a duplex parent, ``dx:0``
on the rest: DuplexReadTaggingNode's tags).

It differs from the JAX pipeline where that one loses work: a run ends with
the simplex pipeline's ``_drain``, so the reads of a batch that never fills
are called and written too (the JAX run leaves such a batch undispatched),
a read whose records ``min_qscore`` filtered is not paired (the JAX run
raises on it), and each harvest's reads go to the pairer in the order they
finished (the JAX run pushes them in reverse). As there, the candidate of a
split read is its first record, with the whole read's scaled signal, and
the splitter runs in simplex mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
from dorado_tpu_torch.config import BasecallModelConfig
from dorado_tpu_torch.duplex.modbase import call_duplex_mods
from dorado_tpu_torch.duplex.pairing import CandidateRead, DuplexPairer, PairingResult
from dorado_tpu_torch.duplex.stereo import StereoFeatureInputs, generate_stereo_features
from dorado_tpu_torch.io.pod5 import Pod5Read, find_pod5_files, iter_reads
from dorado_tpu_torch.io.sam import SamRecord, SamTag
from dorado_tpu_torch.modbase.caller import ModBaseCaller
from dorado_tpu_torch.modbase.tags import generate_modbase_tags, modbase_threshold_uint8
from dorado_tpu_torch.models.crf_model import LSTMCRFModel
from dorado_tpu_torch.pipeline.basecaller import BasecallerPipeline, PipelineStats, _WorkingRead
from dorado_tpu_torch.signal.chunk import generate_chunks
from dorado_tpu_torch.signal.stitch import CalledChunk, stitch_chunks
from dorado_tpu_torch.utils.align import align
from dorado_tpu_torch.utils.sequence import mean_qscore_from_qstring, reverse_complement


@dataclass
class DuplexStats:
    simplex_reads: int = 0  # simplex records written
    pairs: int = 0
    duplex_reads: int = 0
    elapsed_s: float = 0.0
    # host seconds of the pairs' alignments and stereo features, and wall
    # seconds of their stereo calls (the device steps and their harvest)
    pair_align_s: float = 0.0
    stereo_features_s: float = 0.0
    stereo_call_s: float = 0.0


class DuplexPipeline:
    """Simplex and stereo models on the same devices: ``device`` goes to the
    simplex runner (one replica on each visible card by default, as
    ``TorchBasecallRunner`` takes it), and the stereo runner takes the
    simplex runner's devices. ``decoder``, ``lstm_precision`` and ``compute_dtype`` apply to
    both runners, as ``BasecallerPipeline`` takes them; the stereo runner's
    batch is a quarter of the simplex runner's, at least 4 rows a replica.
    ``min_qscore`` and ``only_read_ids`` are the simplex pipeline's read
    filters. With ``modbase_caller``, each duplex record gets MM, ML and MN
    from both strands' signals (``duplex.modbase``), at
    ``modbase_threshold`` (a fraction, as ``--modified-bases-threshold``)."""

    def __init__(
        self,
        simplex_config: BasecallModelConfig,
        simplex_model: LSTMCRFModel,
        stereo_config: BasecallModelConfig,
        stereo_model: LSTMCRFModel,
        chunk_size: int | None = None,
        batch_size: int | None = None,
        overlap: int | None = None,
        device: torch.device | str | None = None,
        decoder: str = "viterbi",
        lstm_precision: str | None = None,
        compute_dtype: torch.dtype | None = None,
        min_qscore: float = 0.0,
        only_read_ids: set | None = None,
        modbase_caller: ModBaseCaller | None = None,
        modbase_threshold: float = 0.05,
    ):
        self.simplex = BasecallerPipeline(
            simplex_config, simplex_model, chunk_size=chunk_size, batch_size=batch_size,
            overlap=overlap, emit_moves=True, device=device, decoder=decoder,
            lstm_precision=lstm_precision, compute_dtype=compute_dtype, min_qscore=min_qscore,
            only_read_ids=only_read_ids,
        )
        if not stereo_config.has_normalised_basecaller_params():
            stereo_config.normalise_basecaller_params()
        self.stereo_config = stereo_config
        simplex_runner = self.simplex.runner
        self.stereo_runner = TorchBasecallRunner(
            stereo_config, stereo_model, chunk_size=chunk_size,
            batch_size=max(4, simplex_runner.batch_size // 4), device=simplex_runner.devices,
            decoder=decoder, lstm_precision=lstm_precision,
            compute_dtype=simplex_runner.compute_dtype,
        )
        self._stereo_buffer = self.stereo_runner.make_input_buffer(0)
        self.pairer = DuplexPairer()
        self.stats = DuplexStats()
        self.modbase_caller = modbase_caller
        self.modbase_threshold = modbase_threshold_uint8(modbase_threshold)

    # ------------------------------------------------------------------

    def _simplex_to_candidate(self, rec: SamRecord, wr: _WorkingRead) -> CandidateRead:
        read = wr.read
        sample_rate = max(1, read.run_info.sample_rate or self.simplex.config.sample_rate)
        mv = next(t for t in rec.tags if t.tag == "mv")
        return CandidateRead(
            read_id=rec.qname,
            channel=read.channel,
            mux=read.well,
            start_time_ms=(read.start_sample * 1000) // sample_rate,
            duration_ms=(len(read.signal) * 1000) // sample_rate,
            seq=rec.seq,
            qstring=rec.qual,
            moves=np.asarray(mv.value[1:], dtype=np.uint8),
            signal=wr.scaled,
            payload=rec,
        )

    def _call_stereo(self, pair: PairingResult) -> SamRecord | None:
        """The duplex record of a pair, or None where the stereo model calls
        no base."""
        temp, comp = pair.template, pair.complement
        stats = self.stats
        t0 = time.perf_counter()
        rc_comp = reverse_complement(comp.seq)
        res = align(
            temp.seq[pair.template_seq_start : pair.template_seq_end + 1],
            rc_comp[pair.complement_seq_start : pair.complement_seq_end + 1],
        )
        t1 = time.perf_counter()
        features = generate_stereo_features(StereoFeatureInputs(
            alignment=res.ops,
            template_seq=temp.seq,
            template_qstring=temp.qstring,
            template_moves=temp.moves,
            template_signal=temp.signal,
            complement_seq=rc_comp,
            complement_qstring=comp.qstring,
            complement_moves=comp.moves,
            complement_signal=np.ascontiguousarray(comp.signal[::-1]),
            signal_stride=self.simplex.config.stride,
            template_seq_start=pair.template_seq_start,
            complement_seq_start=pair.complement_seq_start,
        )).T  # [T, 13]
        t2 = time.perf_counter()
        stats.pair_align_s += t1 - t0
        stats.stereo_features_s += t2 - t1

        runner, buffer = self.stereo_runner, self._stereo_buffer
        stride = self.stereo_config.stride
        t_len = len(features)
        overlap = self.stereo_config.basecaller.overlap
        overlap -= overlap % stride
        offsets = generate_chunks(t_len, runner.chunk_size, stride, overlap)
        chunks = [(off, min(runner.chunk_size, t_len - off)) for off in offsets]
        called: list[CalledChunk] = []
        for lo in range(0, len(chunks), len(buffer)):
            batch = chunks[lo : lo + len(buffer)]
            for i, (off, size) in enumerate(batch):
                runner.accept_chunk(buffer, i, features[off : off + size])
            for (off, size), chunk in zip(batch, runner.call_chunks(buffer, len(batch))):
                called.append(CalledChunk(
                    seq=chunk.sequence, qstring=chunk.qstring,
                    moves=np.asarray(chunk.moves, dtype=np.uint8), input_offset=off,
                    raw_chunk_size=size,
                ))
        stitched = stitch_chunks(called, stride, t_len)
        stats.stereo_call_s += time.perf_counter() - t2
        if not stitched.seq:
            return None

        stats.duplex_reads += 1
        tags = [
            SamTag("qs", "f", mean_qscore_from_qstring(stitched.qstring)),
            SamTag("dx", "i", 1),
            SamTag("ch", "i", temp.channel),
            SamTag("mx", "i", temp.mux),
        ]
        if self.modbase_caller is not None:
            # both strands' move tables realigned onto the duplex call, the mod
            # models on their simplex signals (ModBaseCallerNode.cpp:155-300);
            # every duplex read is tagged once mod models are loaded, also with
            # no site called
            probs = call_duplex_mods(
                self.modbase_caller, stitched.seq, self.simplex.config.stride,
                temp.seq, temp.moves, temp.signal, comp.seq, comp.moves, comp.signal,
            )
            mm, ml, mn = generate_modbase_tags(
                stitched.seq, probs, self.modbase_caller.info, None, self.modbase_threshold,
                is_duplex=True,
            )
            tags += [SamTag("MM", "Z", mm), SamTag("ML", "B", ml, subtype="C"),
                     SamTag("MN", "i", mn)]
        return SamRecord(qname=f"{temp.read_id};{comp.read_id}", seq=stitched.seq,
                         qual=stitched.qstring, tags=tags)

    # ------------------------------------------------------------------

    def run(self, input_path: Path | str, writer, recursive: bool = False) -> DuplexStats:
        """Duplex-call every read of the POD5 files under ``input_path`` (a
        file or a directory), in channel order, into ``writer``."""
        files = find_pod5_files(input_path, recursive=recursive)
        return self.run_reads(iter_reads(files, by_channel=True), writer)

    def run_reads(self, reads: Iterable[Pod5Read], writer) -> DuplexStats:
        """Duplex-call ``reads`` (in channel order, as ``run`` reads them)
        into ``writer``: the duplex records as their pairs are found, then
        every simplex record with its ``dx`` tag."""
        t0 = time.perf_counter()
        self.stats = DuplexStats()
        simplex = self.simplex
        simplex.stats = PipelineStats()
        finished: list[_WorkingRead] = []
        parent_ids: set[str] = set()
        simplex_records: list[SamRecord] = []

        def harvest():
            for wr in finished:
                recs = simplex._finish_read(wr)
                self.stats.simplex_reads += len(recs)
                simplex_records.extend(recs)
                if not recs:
                    continue  # min_qscore dropped every record: nothing to pair
                pair = self.pairer.push(self._simplex_to_candidate(recs[0], wr))
                if pair is None:
                    continue
                self.stats.pairs += 1
                duplex = self._call_stereo(pair)
                if duplex is not None:
                    parent_ids.update((pair.template.read_id, pair.complement.read_id))
                    writer.write(duplex)
            finished.clear()

        def flush():
            simplex._flush_batch(finished)
            harvest()

        for read in reads:
            simplex._feed_read(read, flush)
        simplex._drain(finished)  # the partial batches too
        harvest()

        for rec in simplex_records:
            dx = -1 if rec.qname in parent_ids else 0
            for t in rec.tags:
                if t.tag == "dx":
                    t.value = dx
            writer.write(rec)
        self.stats.elapsed_s = time.perf_counter() - t0
        return self.stats
