"""Per-read modified-base calling.

Port of ``dorado_tpu/modbase/caller.py``. Chunked-model flow (parity:
dorado/read_pipeline/nodes/ModBaseChunkCallerNode.cpp): motif hits in
sequence space -> signal space through the move table -> chunk windows that
keep context around each hit -> batched (signal, encoded kmer) inference on
the caller's device -> each hit's probabilities merged into
``base_mod_probs`` (uint8, a row per sequence position over the whole modbase
alphabet).

One deliberate divergence: a batch computes only its filled rows, where the
JAX caller pads every batch to ``batch_size`` (each row is independent).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from dorado_tpu_torch.basecall.runner import resolve_device
from dorado_tpu_torch.modbase.config import ModBaseModelConfig
from dorado_tpu_torch.modbase.encode import (
    encode_kmer_chunk,
    moves_to_map,
    reverse_seq_to_sig_map,
    sequence_to_ints,
)
from dorado_tpu_torch.modbase.model import (
    ModBaseConvLSTM,
    load_modbase_params,
    load_refine_levels,
    stride_ratio,
)
from dorado_tpu_torch.modbase.motif import MotifMatcher
from dorado_tpu_torch.modbase.scaler import ModBaseScaler

CARDINAL_BASES = "ACGT"


@dataclass
class ModBaseInfo:
    alphabet: list[str]  # e.g. ["A", "C", "h", "m", "G", "T"]
    long_names: str
    context: str
    base_counts: list[int]

    @property
    def num_states(self) -> int:
        return len(self.alphabet)


def get_modbase_info(configs: list[ModBaseModelConfig]) -> ModBaseInfo:
    """The alphabet over all modbase models
    (config/ModBaseModelConfig.cpp get_modbase_info)."""
    per_base_alphabet = [[b] for b in CARDINAL_BASES]
    per_base_longnames = [[] for _ in range(4)]
    per_base_counts = [1, 1, 1, 1]
    motifs = ["", "", "", ""]
    for cfg in configs:
        bid = cfg.mods.base_id
        per_base_alphabet[bid] = [CARDINAL_BASES[bid]] + list(cfg.mods.codes)
        per_base_longnames[bid] = list(cfg.mods.long_names)
        per_base_counts[bid] = cfg.mods.count + 1
        if len(cfg.mods.motif) > 1:
            motifs[bid] = cfg.mods.motif

    alphabet: list[str] = []
    long_names: list[str] = []
    for b in range(4):
        alphabet.extend(per_base_alphabet[b])
        long_names.extend(per_base_longnames[b])

    context_parts = []
    for b in range(4):
        if motifs[b]:
            cfg_b = next(c for c in configs if c.mods.base_id == b)
            m = list(motifs[b])
            m[cfg_b.mods.motif_offset] = "X"
            context_parts.append("".join(m))
        else:
            context_parts.append("_")

    return ModBaseInfo(
        alphabet=alphabet,
        long_names=" ".join(long_names),
        context=":".join(context_parts),
        base_counts=per_base_counts,
    )


def base_prob_offsets(info: ModBaseInfo) -> list[int]:
    offsets = [0, 0, 0, 0]
    acc = 0
    for b in range(4):
        offsets[b] = acc
        acc += info.base_counts[b]
    return offsets


@dataclass
class ModBaseCallResult:
    base_mod_probs: np.ndarray  # uint8 [seq_len * num_states]
    info: ModBaseInfo
    motif_hits: np.ndarray  # bool [seq_len]


@dataclass
class _PreparedModel:
    """One (read, model)'s chunk work: everything before the device."""

    model_id: int
    sig: np.ndarray  # scaled signal (the model's input)
    kmers: np.ndarray  # encoded kmer block
    ssr: int
    chunk_list: list[tuple[int, int]]
    hits_seq: np.ndarray
    hits_sig: np.ndarray
    scores: list | None = None  # filled by call_reads


@dataclass
class PreparedRead:
    """A read staged for modbase inference, batched across reads."""

    probs: np.ndarray
    motif_hits: np.ndarray
    int_seq: np.ndarray
    models: list[_PreparedModel]

    @property
    def num_chunks(self) -> int:
        return sum(len(m.chunk_list) for m in self.models)


def get_chunk_starts(
    signal_len: int,
    hits_to_sig: np.ndarray,
    chunk_size: int,
    samples_before: int,
    samples_after: int,
    end_align_last_chunk: bool = True,
) -> list[tuple[int, int]]:
    """(chunk signal start, index of its first hit) pairs
    (ModBaseChunkCallerNode.cpp:616-659)."""
    chunks: list[tuple[int, int]] = []
    chunk_st = 0
    while chunk_st < signal_len:
        idx = int(np.searchsorted(hits_to_sig, chunk_st, side="left"))
        if idx >= len(hits_to_sig):
            break
        hit_sig = int(hits_to_sig[idx])
        chunk_st = max(0, hit_sig - samples_before)
        chunks.append((chunk_st, idx))
        chunk_st += chunk_size - samples_after + 1
        if chunk_st <= hit_sig:
            chunk_st = hit_sig + 1
    if len(chunks) > 1 and end_align_last_chunk:
        aligned = int(hits_to_sig[-1]) + samples_after - chunk_size
        if aligned > 0:
            chunks[-1] = (aligned, chunks[-1][1])
    return chunks


def resolve_score_index(
    hit_sig_abs: int,
    chunk_start: int,
    scores_states: int,
    chunk_size: int,
    samples_before: int,
    samples_after: int,
    stride: int,
) -> int:
    """-2: stop (a later chunk has the hit); -1: skip (an earlier chunk had
    it); else the flat score index (ModBaseChunkCallerNode.cpp:1034-1080)."""
    hit_rel = hit_sig_abs - chunk_start
    if hit_rel < 0:
        raise ValueError("modbase hit before chunk start")
    if hit_rel > chunk_size - samples_after:
        return -2
    if hit_sig_abs > samples_before and hit_rel < samples_before:
        return -1
    if hit_rel % stride != 0:
        raise ValueError("modbase score did not align to canonical base")
    return hit_rel // stride * scores_states


class ModBaseCaller:
    """One or more modbase models sharing a canonical basecall model, their
    weights on one device: ``device``'s first (``resolve_device``: the first
    visible card unless the caller names another). It stays on that card
    when the basecall runner has a replica on every card, as the JAX caller
    takes no mesh. ``models``
    (one ``ModBaseConvLSTM`` for each config) replaces loading the configs'
    directories, and with it their refinement levels, as the JAX caller's
    ``params_list`` does."""

    def __init__(
        self,
        configs: list[ModBaseModelConfig],
        models: list[ModBaseConvLSTM] | None = None,
        canonical_stride: int = 1,
        is_rna: bool = False,
        batch_size: int = 128,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        # context sample counts normalised to the canonical stride
        self.configs = [
            dataclasses.replace(cfg, context=cfg.context.normalised(canonical_stride))
            for cfg in configs
        ]
        self.canonical_stride = canonical_stride
        self.is_rna = is_rna
        self.batch_size = batch_size
        self.info = get_modbase_info(self.configs)
        self.offsets = base_prob_offsets(self.info)
        from_dirs = models is None
        if from_dirs:
            models = [load_modbase_params(c) for c in configs]
        self.models = [m.to(self.device).eval() for m in models]
        self.matchers = [MotifMatcher(c.mods.motif, c.mods.motif_offset) for c in self.configs]
        self.scalers = []
        for c in configs:
            levels = load_refine_levels(c) if from_dirs else None
            self.scalers.append(
                ModBaseScaler(levels, c.kmer_len, c.refine.center_idx)
                if levels is not None else None
            )
        self.ssr = [stride_ratio(c) for c in self.configs]

    def call_read(self, seq: str, moves: np.ndarray, signal: np.ndarray) -> ModBaseCallResult:
        """``seq`` and ``moves`` from the basecall, ``signal`` its scaled
        (model input) signal."""
        return self.call_reads([self.prepare_read(seq, moves, signal)])[0]

    def init_canonical_probs(self, int_seq: np.ndarray) -> np.ndarray:
        """uint8 [len * num_states], one at each position's canonical base
        (ModBaseChunkCallerNode.cpp:310-327)."""
        num_states = self.info.num_states
        n = len(int_seq)
        probs = np.zeros(n * num_states, dtype=np.uint8)
        if n:
            pos_off = np.array([self.offsets[b] for b in int_seq], dtype=np.int64)
            probs[np.arange(n, dtype=np.int64) * num_states + pos_off] = 1
        return probs

    def prepare_read(self, seq: str, moves: np.ndarray, signal: np.ndarray) -> PreparedRead:
        """The host's part up to the device: motif hits, the signal's
        rescaling, kmer encoding and chunk windows. ``call_reads`` batches
        the chunks of many prepared reads (the reference's per-model chunk
        queues, ModBaseChunkCallerNode.cpp:174-1010)."""
        seq_len = len(seq)
        int_seq = sequence_to_ints(seq)
        probs = self.init_canonical_probs(int_seq)
        motif_hits_mask = np.zeros(seq_len, dtype=bool)
        models: list[_PreparedModel] = []

        if self.is_rna:
            pad = (-len(signal)) % self.canonical_stride
            if pad:
                signal = np.concatenate([signal[len(signal) - pad :], signal[::-1]])
            else:
                signal = signal[::-1]
        signal_len = len(signal)

        seq_to_sig = moves_to_map(moves, self.canonical_stride, signal_len)
        if self.is_rna:
            seq_to_sig = reverse_seq_to_sig_map(seq_to_sig, signal_len)

        for model_id, cfg in enumerate(self.configs):
            hits_seq = np.asarray(self.matchers[model_id].get_motif_hits(seq), dtype=np.int64)
            if len(hits_seq) == 0:
                continue
            motif_hits_mask[hits_seq] = True
            hits_sig = seq_to_sig[hits_seq].astype(np.int64)

            scaler = self.scalers[model_id]
            sig = (
                scaler.scale_signal(signal, int_seq, seq_to_sig) if scaler is not None else signal
            ).astype(np.float32)

            ssr = self.ssr[model_id]
            s2s = seq_to_sig // ssr if ssr > 1 else seq_to_sig
            kmers = encode_kmer_chunk(
                int_seq, s2s, cfg.kmer_len, signal_len // ssr, kmer_centered=True
            )
            ctx = cfg.context
            chunk_list = get_chunk_starts(
                signal_len, hits_sig, ctx.chunk_size, ctx.samples_before, ctx.samples_after
            )
            if not chunk_list:
                continue
            models.append(_PreparedModel(model_id, sig, kmers, ssr, chunk_list, hits_seq,
                                         hits_sig))

        return PreparedRead(probs=probs, motif_hits=motif_hits_mask, int_seq=int_seq,
                            models=models)

    def call_reads(self, prepared: list[PreparedRead]) -> list[ModBaseCallResult]:
        """Inference for many prepared reads, their chunks batched across
        reads: each model's chunks of every read in one work list, run in
        batches of ``batch_size`` (the last of a model may be partial)."""
        by_model: dict[int, list[_PreparedModel]] = {}
        for pr in prepared:
            for pm in pr.models:
                pm.scores = []
                by_model.setdefault(pm.model_id, []).append(pm)

        for model_id, entries in by_model.items():
            work = [(pm, start) for pm in entries for (start, _hit) in pm.chunk_list]
            for batch_start in range(0, len(work), self.batch_size):
                batch = work[batch_start : batch_start + self.batch_size]
                for (pm, _start), row in zip(batch, self._run_batch(model_id, batch)):
                    pm.scores.append(row)

        out: list[ModBaseCallResult] = []
        for pr in prepared:
            for pm in pr.models:
                self._merge_scores(pr.probs, self.configs[pm.model_id], pm.scores,
                                   pm.chunk_list, pm.hits_seq, pm.hits_sig)
            out.append(ModBaseCallResult(base_mod_probs=pr.probs, info=self.info,
                                         motif_hits=pr.motif_hits))
        return out

    def _run_batch(self, model_id: int, batch) -> np.ndarray:
        """One device batch of (PreparedModel, chunk start) pairs: its rows'
        probabilities, [len(batch), T / stride * num_out] float32. A chunk
        past the signal's end is filled by repeating what it holds."""
        cfg = self.configs[model_id]
        chunk_size = cfg.context.chunk_size
        ssr = self.ssr[model_id]
        want = chunk_size // ssr
        sig_in = np.zeros((len(batch), chunk_size), dtype=np.float32)
        seq_in = np.zeros((len(batch), want, cfg.kmer_len * 4), dtype=np.int8)
        for i, (pm, start) in enumerate(batch):
            piece = pm.sig[start : min(start + chunk_size, len(pm.sig))]
            if len(piece) < chunk_size:
                piece = np.tile(piece, -(-chunk_size // len(piece)))[:chunk_size]
            sig_in[i] = piece
            kpiece = pm.kmers[start // ssr : min((start + chunk_size) // ssr, len(pm.kmers))]
            if len(kpiece) < want:
                kpiece = np.tile(kpiece, (-(-want // max(1, len(kpiece))), 1))[:want]
            seq_in[i] = kpiece
        with torch.inference_mode():
            probs = self.models[model_id](
                torch.from_numpy(sig_in).to(self.device), torch.from_numpy(seq_in).to(self.device)
            )
            return probs.cpu().numpy()

    def _merge_scores(self, probs, cfg, scores, chunk_list, hits_seq, hits_sig) -> None:
        num_states_model = cfg.num_states
        num_states = self.info.num_states
        ctx = cfg.context
        base_offset = self.offsets[cfg.mods.base_id]
        for (chunk_start, hit_start), chunk_scores in zip(chunk_list, scores):
            for h in range(hit_start, len(hits_sig)):
                idx = resolve_score_index(
                    int(hits_sig[h]), chunk_start, num_states_model, ctx.chunk_size,
                    ctx.samples_before, ctx.samples_after, cfg.stride,
                )
                if idx <= -2:
                    break
                if idx == -1:
                    continue
                row = int(hits_seq[h]) * num_states + base_offset
                for mod_offset in range(num_states_model):
                    score = chunk_scores[idx + mod_offset]
                    probs[row + mod_offset] = min(int(np.floor(score * 256)), 255)


class ModBaseBatchScheduler:
    """Chunks batched across reads behind concurrent finisher threads.

    The reference gathers chunks of many reads in per-model queues and runs a
    device batch when one is full or a timeout expires
    (ModBaseChunkCallerNode.cpp:174-290, chunk_queues_ and m_batch_timeout).
    Here finisher threads submit :class:`PreparedRead`s and wait for their
    read's result; one runner thread gathers submissions until ``batch_size``
    chunks are pending (or ``timeout_s`` has passed with work waiting) and
    runs one :meth:`ModBaseCaller.call_reads` over them, so short reads from
    different threads share device batches.
    """

    def __init__(self, caller: ModBaseCaller, timeout_s: float = 0.01):
        self.caller = caller
        self.timeout_s = timeout_s
        self._cv = threading.Condition()
        self._queue: list[tuple[PreparedRead, threading.Event, list]] = []
        self._pending_chunks = 0
        self._closed = False
        self._runner = threading.Thread(target=self._run, name="modbase-batcher", daemon=True)
        self._runner.start()

    def call(self, prepared: PreparedRead) -> ModBaseCallResult:
        ev = threading.Event()
        box: list = []
        with self._cv:
            if self._closed:
                raise RuntimeError("ModBaseBatchScheduler is closed")
            self._queue.append((prepared, ev, box))
            self._pending_chunks += prepared.num_chunks
            self._cv.notify()
        ev.wait()
        if isinstance(box[0], BaseException):
            raise box[0]
        return box[0]

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                deadline = time.monotonic() + self.timeout_s
                while self._pending_chunks < self.caller.batch_size and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._queue
                self._queue = []
                self._pending_chunks = 0
            try:
                results = self.caller.call_reads([p for p, _, _ in batch])
            except BaseException as exc:  # every waiter gets the fault
                for _, ev, box in batch:
                    box.append(exc)
                    ev.set()
                continue
            for (_, ev, box), res in zip(batch, results):
                box.append(res)
                ev.set()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._runner.join()
