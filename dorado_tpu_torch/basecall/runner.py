"""Batched basecall engine on a CUDA device (or the CPU, for tests).

Port of ``dorado_tpu/basecall/runner.py::BasecallRunner`` for the
``viterbi`` and ``beam`` decoders. One device step takes a batch of f16
signal chunks through the model, the decoder, and the qual and sequence byte
materialisation; only uint8 bases, qual chars and moves come back to the
host, which compacts them by the move mask (as
dorado/basecall/decode/CUDADecoder.cpp:115 does).

  - ``viterbi``: the backward LSE scan and the fused forward pass (alpha,
    posteriors, choices) over bf16 scores, then the traceback;
  - ``beam``: the forward and backward LSE scans over float32 scores, their
    posteriors, and the beam search guided by the backward scores (the
    reference's own default decode).

The LSTM input projections run W8A8 by default on the card
(``lstm_precision``), and so do a transformer (sup) model's qkv, fc1 and fc2
matmuls (``tx_precision``), as the JAX runner's do on the TPU. A transformer
model takes either decoder, and its attention and norm routes as arguments
(``tx_attention``, ``tx_fused_norm``) where the JAX runner reads environment
variables. Its head writes the scores in the decoder's type: bf16 for
``viterbi`` on the card, float32 for ``beam`` (as the JAX runner's
``device_beam`` takes the head's float32 output).

``compute_dtype`` is the model's type: bf16 on the card and float32 on the
CPU by default, as the JAX pipeline picks; float32 on the card runs the
float32 forms of the kernels (K1, K2, K10, K13 and K14 at float32). The
Viterbi decode on the card takes bf16 scores at either type, as the JAX
runner stores them (its ``score_dtype``), so K3, K4 and K5 are the same;
on the CPU it takes float32 scores, as the JAX runner's CPU path does.

The step is enqueued on the current CUDA stream and returns at once
(``dispatch``); ``finish`` waits for it, so the host feeds and finishes
other batches while the device computes.

By default the runner holds one replica of the model on each visible card,
as the JAX runner builds a data-parallel mesh over every device; each
replica takes a contiguous share of a batch's rows (``device`` selects the
cards). Unlike the JAX runner, which splits one global batch over the
devices, ``batch_size`` is each replica's batch: K1's time barely moves with
its rows, so splitting a fixed batch would give every card a small batch
at nearly the full step time. Rows are independent, so the calls are the
same either way.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import time
from dataclasses import astuple, dataclass
from typing import NamedTuple

import numpy as np
import torch

from dorado_tpu_torch.config import BasecallModelConfig
from dorado_tpu_torch.decode.common import DecodedChunk, DecoderOptions
from dorado_tpu_torch.models.crf_model import LSTMCRFModel, quantize_lstm_crf_w8a8
from dorado_tpu_torch.models.tx_model import (
    TxModel,
    check_attention_route,
    quantize_tx_int8,
    quantize_tx_w8a8,
    set_routes,
)
from dorado_tpu_torch.ops.beam import beam_search_device
from dorado_tpu_torch.ops.crf_cuda import (
    forward_backward_scores,
    fused_viterbi_decode,
    viterbi_traceback,
)

# chunk-length lanes {T, 3T/4}: the reference's dual batch dims
# (CudaCaller.cpp:391-415)
_CHUNK_LANES = 2
_ALPHABET = np.array(list(b"ACGT"), np.uint8)


def _no_cuda() -> RuntimeError:
    return RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")


def _one_device(device: torch.device | str) -> torch.device:
    """One named device; a CUDA device gets its index (the current card's
    when none is given) and must be visible."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise _no_cuda()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"{dev}: only {torch.cuda.device_count()} CUDA devices are visible")
    return torch.device("cuda", index)


def resolve_devices(device=None) -> list[torch.device]:
    """The devices an entry point runs on, one model replica on each.

    None, ``"cuda"`` and ``"auto"`` mean every visible card (the JAX
    runner's default mesh over all devices); ``"cuda:N"`` that one card;
    ``"cpu"`` the CPU; a list or tuple of devices one replica on each (the
    same device may appear more than once). Raises when CUDA is asked for
    (or left as the default) and the machine has none: it never falls back
    to the CPU."""
    if isinstance(device, (list, tuple)):
        devices = [_one_device(d) for d in device]
        if not devices:
            raise ValueError("no devices given")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"devices of one type expected, got {devices}")
        return devices
    if device is None or str(device) in ("cuda", "auto"):
        if not torch.cuda.is_available():
            raise _no_cuda()
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [_one_device(device)]


def resolve_device(device=None) -> torch.device:
    """The first of ``resolve_devices(device)``: the device of work that
    runs on one card only (the modbase caller, ``-b 0``'s sweep)."""
    return resolve_devices(device)[0]


def resolve_compute_dtype(
    compute_dtype: torch.dtype | None, device: torch.device
) -> torch.dtype:
    """The model's compute type: ``compute_dtype`` when it is float32 or bf16,
    else bf16 on CUDA and float32 on the CPU for None (the JAX pipeline's
    default: bf16 on the accelerator); anything else raises ValueError."""
    if compute_dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"unknown compute_dtype {compute_dtype!r}: expected torch.float32 or torch.bfloat16"
        )
    return compute_dtype


def on_device(device: torch.device):
    """A CUDA device's context (its current device and streams), or nothing
    for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def prepare_cuda() -> None:
    """The set-up of every entry point that runs a model on the card:
    float32 products in full precision (no TF32 in matmuls or cuDNN
    convolutions: the float32 model's products, the bf16 model's float32
    work), and the kernels built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dorado_tpu_torch.ops._cuda import build_kernels

    build_kernels()


@functools.lru_cache(maxsize=None)
def _qual_weight_table(num_states: int) -> np.ndarray:
    """Constant [S, S] candidate-weight table for the per-block posterior sum.

    Row s holds the weight of each posterior state for a Viterbi call in
    state s: 1.0 for s itself plus 1.0 for every *distinct* left/right
    k-mer shift of s that differs from s: the candidate set and dedup order
    of the reference qual calc (beam_search.cpp:411-470)."""
    msb = num_states >> 2
    table = np.zeros((num_states, num_states), np.float32)
    for s in range(num_states):
        table[s, s] = 1.0
        shifted = []
        for b in range(4):
            shifted.append((s >> 2) + msb * b)  # interleaved [l0, r0, ...]
            shifted.append(((s << 2) % num_states) + b)
        seen = []
        for cand in shifted:
            if cand != s and cand not in seen:
                table[s, cand] += 1.0
            seen.append(cand)
    return table


def device_qual(
    states_nt: torch.Tensor, t_posts: torch.Tensor, table: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block base probabilities on the device: (qual [N, T, 4],
    block_prob [N, T]), both rounded to bf16 as the JAX runner does.
    t_posts [N, T, S] are the posterior rows 1..T."""
    state = states_nt.long()
    block_prob = (table[state] * t_posts.float()).sum(dim=-1)
    block_prob = torch.clamp(block_prob, 0.0, 1.0) ** 0.4
    wrong = ((1.0 - block_prob) / 3.0)[..., None].expand(*block_prob.shape, 4)
    is_base = torch.nn.functional.one_hot(state & 3, 4).bool()
    qual = torch.where(is_base, block_prob[..., None], wrong)
    return qual.to(torch.bfloat16), block_prob.to(torch.bfloat16)


def device_sequence(
    states_nt: torch.Tensor,
    moves_nt: torch.Tensor,
    qual: torch.Tensor,
    block_prob: torch.Tensor,
    q_scale: float,
    q_shift: float,
    alphabet: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(ASCII bases [N, T] uint8, phred chars [N, T] uint8) in emit-position
    layout, valid where moves_nt == 1; ``alphabet`` is b"ACGT" as uint8 on
    the device.

    Per-base sums come from cumsum differences broadcast to the segment
    boundaries with monotone cummax/cummin scans, exactly the JAX runner's
    arithmetic (a segment starts at position 0 and at every emit but the
    first; pre-first-emit positions fold into base 0)."""
    n, t = states_nt.shape
    dev = states_nt.device
    moves_i = moves_nt.to(torch.int32)
    base_prob_blk = block_prob.float()
    total_blk = qual.float().sum(dim=-1)

    tidx = torch.arange(t, device=dev)
    cum = torch.cumsum(moves_i, dim=1)
    is_start = (tidx[None, :] == 0) | ((moves_i == 1) & (cum > 1))
    is_end = torch.cat([is_start[:, 1:], torch.ones(n, 1, dtype=torch.bool, device=dev)], 1)

    def seg_sums(vals: torch.Tensor) -> torch.Tensor:
        c = torch.cumsum(vals, dim=1)  # inclusive, non-decreasing
        # exclusive prefix via a shift (NOT c - vals, which rounds differently)
        e = torch.cat([torch.zeros(n, 1, device=dev), c[:, :-1]], dim=1)
        lo = torch.cummax(torch.where(is_start, e, float("-inf")), dim=1).values
        hi = torch.flip(
            torch.cummin(torch.flip(torch.where(is_end, c, float("inf")), [1]), dim=1).values,
            [1],
        )
        return hi - lo

    base_probs = seg_sums(base_prob_blk)
    total_probs = seg_sums(total_blk)
    err = 1.0 - base_probs / torch.clamp(total_probs, min=1e-30)
    phred = -10.0 * torch.log10(torch.clamp(err, min=1e-30))
    qscore = torch.clamp(phred * q_scale + q_shift, 1.0, 50.0)
    qchar = (33.5 + qscore).to(torch.uint8)  # truncates, as the reference
    return alphabet[(states_nt & 3).long()], qchar


class RunnerTotals(NamedTuple):
    """``RunnerStats`` read at one moment (``snapshot``), or the replicas'
    counts summed (``TorchBasecallRunner.stats``): a tuple, so a write to it
    fails."""

    batches_called: int
    chunks_called: int
    samples_called: int
    dispatch_s: float
    fetch_s: float
    host_decode_s: float


@dataclass
class RunnerStats:
    """One replica's counts."""

    batches_called: int = 0
    chunks_called: int = 0
    samples_called: int = 0  # incl. the repeat-padding of short chunks
    # host seconds blocked in the enqueue, waiting for the device results
    # (and the device-to-host copy), and compacting calls on the host
    dispatch_s: float = 0.0
    fetch_s: float = 0.0
    host_decode_s: float = 0.0

    def snapshot(self) -> RunnerTotals:
        return RunnerTotals(*astuple(self))


@dataclass
class Replica:
    """One copy of the model on one device, with its own device constants
    and counts."""

    device: torch.device
    model: LSTMCRFModel | TxModel
    qual_table: torch.Tensor
    alphabet: torch.Tensor
    stats: RunnerStats


class TorchBasecallRunner:
    """Owns a copy of the model on each of its devices (``replicas``) and
    runs the device step over fixed-size chunk batches, one batch shape per
    lane, each batch's rows split into contiguous shares over the replicas.

    device: as ``resolve_devices`` takes it: every visible card by default,
    ``"cuda:N"``, ``"cpu"``, or a list of devices (one replica each).
    batch_size: each replica's batch; a lane's buffer holds the replicas'
    batches one after another. A replica's failure raises: the runner never
    drops a card and carries on.

    decoder: ``"viterbi"`` (exact best path) or ``"beam"`` (the reference's
    beam search, width and cut from ``DecoderOptions``), for either model
    family.
    lstm_precision (conv + LSTM models): ``"w8a8"`` (int8 LSTM input
    projections where the widths are multiples of 128) or ``"bf16"``
    (unquantised); by default ``"w8a8"`` on CUDA and ``"bf16"`` on the CPU.
    tx_precision (transformer models): ``"w8a8"`` (int8 qkv, fc1 and fc2
    matmuls), ``"int8"`` (the same three as int8 weights times per-token
    quantised activations through ``torch._int_mm``) or ``"bf16"``
    (unquantised), with the same defaults as lstm_precision.
    tx_attention (transformer models): the attention route, ``"extf"``
    (the default), ``"ext"`` or ``"hp"`` (``models.tx_model``). All three
    give the same scores; ``"ext"`` (a separate rotation pass, then K10) is
    kept for parity with the JAX package and is slower than ``"extf"`` on an
    H100, so pick it only to reproduce that route. tx_fused_norm:
    whether the residual norms run fused into the matmuls in front of them
    (default False). The two lstm and tx argument sets raise on the other
    model family.
    compute_dtype: ``torch.float32`` or ``torch.bfloat16``; None means bf16 on
    CUDA and float32 on the CPU."""

    def __init__(
        self,
        config: BasecallModelConfig,
        model: LSTMCRFModel | TxModel,
        chunk_size: int | None = None,
        batch_size: int | None = None,
        device: torch.device | str | None = None,
        decoder: str = "viterbi",
        lstm_precision: str | None = None,
        tx_precision: str | None = None,
        tx_attention: str | None = None,
        tx_fused_norm: bool | None = None,
        compute_dtype: torch.dtype | None = None,
    ):
        self.devices = resolve_devices(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, self.device)
        if decoder not in ("viterbi", "beam"):
            raise ValueError(f"unknown decoder {decoder!r}: expected 'viterbi' or 'beam'")
        self.decoder = decoder
        if config.is_tx_model:
            kind, given, other = "a transformer", "tx_precision", "lstm_precision"
            chosen, unused = tx_precision, lstm_precision
            choices = ("w8a8", "int8", "bf16")
        else:
            kind, given, other = "a conv + LSTM", "lstm_precision", "tx_precision"
            chosen, unused = lstm_precision, tx_precision
            choices = ("w8a8", "bf16")
            for name, value in (("tx_attention", tx_attention), ("tx_fused_norm", tx_fused_norm)):
                if value is not None:
                    raise ValueError(f"{name} does not apply to {kind} model")
        if unused is not None:
            raise ValueError(f"{other} does not apply to {kind} model: pass {given}")
        if chosen is None:
            chosen = "w8a8" if self.device.type == "cuda" else "bf16"
        if chosen not in choices:
            raise ValueError(f"unknown {given} {chosen!r}: expected one of {choices}")
        self.lstm_precision = None if config.is_tx_model else chosen
        self.tx_precision = chosen if config.is_tx_model else None
        if config.is_tx_model:
            self.tx_attention = check_attention_route(tx_attention or "extf")
            self.tx_fused_norm = bool(tx_fused_norm)
        else:
            self.tx_attention = self.tx_fused_norm = None
        self.config = config
        self.chunk_size = int(chunk_size or config.basecaller.chunk_size)
        granularity = config.chunk_size_granularity
        self.chunk_size -= self.chunk_size % granularity
        # a geometric ladder of chunk lengths: short reads go to the smaller
        # lane, bounding padding waste
        overlap = config.basecaller.overlap
        self.chunk_sizes = [self.chunk_size]
        while len(self.chunk_sizes) < _CHUNK_LANES:
            nxt = self.chunk_sizes[-1] * 3 // 4
            nxt -= nxt % granularity
            if nxt <= overlap or nxt < granularity or nxt == self.chunk_sizes[-1]:
                break
            self.chunk_sizes.append(nxt)
        self.batch_size = int(batch_size or config.basecaller.batch_size or 128)
        self.options = DecoderOptions(
            blank_score=config.blank_score if config.blank_score is not None else 2.0,
            q_shift=config.qbias,
            q_scale=config.qscale,
        )
        # the Viterbi decode's scores: bf16 on the card at either compute
        # type (the JAX runner's score_dtype), float32 on the CPU
        self.score_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        if self.device.type == "cuda":
            prepare_cuda()
        # quantised from the float32 weights, before the cast to bf16
        if chosen == "bf16":
            own = copy.deepcopy(model)
        elif not config.is_tx_model:
            own = quantize_lstm_crf_w8a8(model)
        else:
            own = (quantize_tx_w8a8 if chosen == "w8a8" else quantize_tx_int8)(model)
        if config.is_tx_model:
            set_routes(own, self.tx_attention, self.tx_fused_norm)  # own is a private copy
        # quantised once, then one private copy for each further replica
        copies = [own] + [copy.deepcopy(own) for _ in self.devices[1:]]
        self.replicas = []
        for dev, m in zip(self.devices, copies):
            m = m.to(dev).eval()
            if config.is_tx_model:
                m.freeze_constants()
            else:
                m.freeze_lstm_constants(self.compute_dtype)
            m.to(self.compute_dtype)
            # device constants made once: creating them per step would copy
            # from the host, which waits for the stream and breaks async
            # dispatch
            self.replicas.append(Replica(
                dev, m, torch.as_tensor(_qual_weight_table(config.num_states), device=dev),
                torch.as_tensor(_ALPHABET, device=dev), RunnerStats(),
            ))

    @property
    def device(self) -> torch.device:
        """The first replica's device."""
        return self.devices[0]

    @property
    def model(self) -> LSTMCRFModel | TxModel:
        """The first replica's model."""
        return self.replicas[0].model

    @property
    def stats(self) -> RunnerTotals:
        """The replicas' counts, summed at this moment (read-only: each
        replica's own counts are ``replicas[i].stats``)."""
        return RunnerTotals(*(sum(v) for v in zip(*(r.stats.snapshot() for r in self.replicas))))

    def lane_for(self, raw_size: int) -> int:
        """Smallest configured chunk size that holds a chunk of raw_size."""
        for i in range(len(self.chunk_sizes) - 1, 0, -1):
            if raw_size <= self.chunk_sizes[i]:
                return i
        return 0

    def lane_batch_size(self, lane: int = 0) -> int:
        """Batch rows for a lane, scaled inversely to its chunk length so
        every lane dispatches about the same samples per batch, rounded up
        to 128 when the base batch is a multiple of 128, else to the base
        batch."""
        raw = self.batch_size * self.chunk_size / self.chunk_sizes[lane]
        g = 128 if self.batch_size % 128 == 0 else self.batch_size
        return min(-(-int(raw) // g) * g, 2048)

    def make_input_buffer(self, lane: int = 0) -> np.ndarray:
        """A zeroed host batch buffer [rows, chunk] of f16 signal (the
        reference feeds f16 signal too, ScalerNode.cpp:227-229), with the
        lane's batch rows for each replica. For a CUDA
        runner it lies in pinned memory, so ``dispatch`` copies it to the
        card without waiting: the caller must not write to a dispatched
        buffer until ``finish`` has returned its batch."""
        shape = (len(self.replicas) * self.lane_batch_size(lane), self.chunk_sizes[lane])
        if self.config.num_features > 1:
            shape += (self.config.num_features,)
        pinned = self.device.type == "cuda"
        return torch.zeros(shape, dtype=torch.float16, pin_memory=pinned).numpy()

    def accept_chunk(self, buffer: np.ndarray, idx: int, signal: np.ndarray) -> None:
        """Copy one (possibly short) chunk into the batch, repeat-padding to
        the buffer's chunk size (BasecallerNode.cpp:431-440)."""
        size = buffer.shape[1]
        n = len(signal)
        if n == size:
            buffer[idx] = signal
        else:
            reps = -(-size // n)
            tiled = np.tile(signal, (reps, 1) if signal.ndim == 2 else reps)
            buffer[idx] = tiled[:size]

    @torch.inference_mode()
    def _device_step(self, sig: torch.Tensor, rep: Replica) -> torch.Tensor:
        """f16 signal [N, T] on ``rep``'s device -> uint8 [3, N, T_out]:
        ASCII bases, phred chars and moves."""
        if self.config.is_tx_model:
            # the head writes the decoder's dtype itself: a copy of a full
            # batch's scores would be 2 GB (bf16) to 4 GB (float32) at sup's
            # 4096 transitions
            if self.decoder == "beam":
                return self.decode_scores_beam(rep.model(sig, score_dtype=torch.float32), rep)
            return self.decode_scores(rep.model(sig, score_dtype=self.score_dtype), rep)
        scores = rep.model(sig)
        if self.decoder == "beam":
            return self.decode_scores_beam(scores, rep)
        return self.decode_scores(scores.to(self.score_dtype), rep)

    @torch.inference_mode()
    def decode_scores(self, scores: torch.Tensor, replica: Replica | None = None) -> torch.Tensor:
        """Time-major CRF scores [T, N, C] in ``score_dtype`` -> uint8
        [3, N, T]: ASCII bases, phred chars and moves of each row's Viterbi
        path, with the constants of ``replica`` (the first unless given)."""
        rep = replica or self.replicas[0]
        blank = float(self.options.blank_score)
        t_posts, choices, final = fused_viterbi_decode(scores, blank)
        last_state = torch.argmax(final, dim=-1).to(torch.int32)
        states, moves = viterbi_traceback(choices, last_state)
        return self._materialise(states.t(), moves.t(), t_posts.transpose(0, 1), rep)

    @torch.inference_mode()
    def decode_scores_beam(
        self, scores: torch.Tensor, replica: Replica | None = None
    ) -> torch.Tensor:
        """Time-major float32 CRF scores [T, N, C] -> uint8 [3, N, T]: ASCII
        bases, phred chars and moves of each row's beam search path, with the
        constants of ``replica`` (the first unless given)."""
        rep = replica or self.replicas[0]
        blank = float(self.options.blank_score)
        scores = scores.contiguous()
        alpha, beta = forward_backward_scores(scores, blank)
        posts = torch.softmax(alpha + beta, dim=-1)
        states_nt, moves_nt = beam_search_device(
            scores, beta, int(self.options.beam_width), float(self.options.beam_cut), blank
        )
        return self._materialise(states_nt, moves_nt, posts[1:].transpose(0, 1), rep)

    def _materialise(
        self, states_nt: torch.Tensor, moves_nt: torch.Tensor, t_posts_nt: torch.Tensor,
        rep: Replica,
    ) -> torch.Tensor:
        """Decoded states and moves [N, T] and the posterior rows 1..T
        [N, T, S] -> uint8 [3, N, T]: ASCII bases, phred chars, moves, with
        ``rep``'s constants."""
        qual, block_prob = device_qual(states_nt, t_posts_nt, rep.qual_table)
        bases, qchars = device_sequence(
            states_nt, moves_nt, qual, block_prob,
            float(self.options.q_scale), float(self.options.q_shift), rep.alphabet,
        )
        return torch.stack([bases, qchars, moves_nt])

    def shares(self, num_chunks: int) -> list[tuple[Replica, int, int]]:
        """(replica, first row, end row) of each replica's share of a batch's
        first ``num_chunks`` rows: contiguous, in replica order, their sizes
        at most one apart; a replica with no row is left out."""
        count = len(self.replicas)
        base, extra = divmod(num_chunks, count)
        out, lo = [], 0
        for i, rep in enumerate(self.replicas):
            hi = lo + base + (i < extra)
            if hi > lo:
                out.append((rep, lo, hi))
            lo = hi
        return out

    def dispatch(self, buffer: np.ndarray, num_chunks: int):
        """Enqueue the device step for the first ``num_chunks`` rows of a
        batch, each replica's share on its device, and return a handle for
        ``finish``; on CUDA this does not wait for the device. Rows are
        independent, so the unused rows of a partial batch are not computed
        (the JAX runner pads to a fixed shape because each shape is a
        compiled program)."""
        handle = []
        for rep, lo, hi in self.shares(num_chunks):
            rep.stats.batches_called += 1
            rep.stats.chunks_called += hi - lo
            rep.stats.samples_called += (hi - lo) * buffer.shape[1]
            t0 = time.perf_counter()
            with on_device(rep.device):
                sig = torch.from_numpy(buffer[lo:hi]).to(rep.device, non_blocking=True)
                handle.append((rep, self._device_step(sig, rep)))
            rep.stats.dispatch_s += time.perf_counter() - t0
        return handle

    def finish(self, handle) -> list[DecodedChunk]:
        """Wait for a dispatched batch and materialise its per-chunk calls,
        in row order."""
        res = []
        for rep, out in handle:
            t0 = time.perf_counter()
            seq_chars, qchars, moves_all = out.cpu().numpy()
            t1 = time.perf_counter()
            rep.stats.fetch_s += t1 - t0
            for i in range(len(moves_all)):
                # device arrays are in emit-position layout; compact by the moves
                mask = moves_all[i].astype(bool)
                res.append(
                    DecodedChunk(
                        sequence=seq_chars[i][mask].tobytes().decode(),
                        qstring=qchars[i][mask].tobytes().decode(),
                        moves=moves_all[i],
                    )
                )
            rep.stats.host_decode_s += time.perf_counter() - t1
        return res

    def call_chunks(self, buffer: np.ndarray, num_chunks: int) -> list[DecodedChunk]:
        """Run the device step on a batch and materialise per-chunk calls."""
        return self.finish(self.dispatch(buffer, num_chunks))
