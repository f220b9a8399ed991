"""Batched CRF beam search on the device.

Port of ``dorado_tpu/ops/beam.py`` (the algorithm of the reference's
dorado/basecall/decode/beam_search.cpp:126-520: CRC32C sequence hashing,
stay/step log-sum-exp merging, a score cutoff with bisection width control),
vectorised across the chunk batch:

  - candidates live in a fixed [N, 5W] layout (4 steps per element, then W
    stays); dead slots carry the lowest finite float, not -inf;
  - a stay and a step that spell the same sequence (equal hash, equal last
    base) merge: the better one takes their log-sum-exp, the other dies;
  - survivors are the first W candidates at or above the cutoff, in
    candidate order;
  - the history (state, parent and stay per step) is traced back from the
    best final element.

``beam_forward`` and ``beam_traceback`` launch the kernels of
``csrc/beam_search.cu`` on CUDA tensors and run the plain PyTorch versions
below (one small-op step per time step) on CPU tensors. The two routes can
differ in the last bit of a merged score (``log1p`` and ``exp`` are not the
same functions in CUDA and in PyTorch), and a near-tie in the merge or the
cutoff can then go the other way; apart from such ties they agree exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dorado_tpu_torch.ops import _cuda

_POLY = 0x82F63B78
_CRC_SEED = 0x12345678
NEG = float(np.finfo(np.float32).min)
# the kernel's beam is one warp; the state counts it is built for
KERNEL_BEAM_WIDTH = 32
KERNEL_STATES = (64, 256, 1024)


def _crc_table(nbits: int) -> np.ndarray:
    table = np.zeros(1 << nbits, dtype=np.int64)
    for v in range(1 << nbits):
        crc = v
        for _ in range(nbits):
            b = crc & 1
            crc >>= 1
            if b:
                crc ^= _POLY
        table[v] = crc
    return table


_CRC2 = _crc_table(2)
_CRC8 = _crc_table(8)


def _crc2(crc: torch.Tensor, bits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """CRC32C of two more bits. Hashes are uint32 values held in int64."""
    folded = crc ^ (bits & 3)
    return (folded >> 2) ^ table[folded & 3]


def _crc32(crc: torch.Tensor, word: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """CRC32C of one more 32-bit word, a byte at a time."""
    folded = crc ^ (word & 0xFFFFFFFF)
    for _ in range(4):
        folded = (folded >> 8) ^ table[folded & 0xFF]
    return folded


def _lse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = (x - y).abs()
    return torch.maximum(x, y) + torch.where(d < 17.0, torch.log1p(torch.exp(-d)), 0.0)


def _log_beam_cut(beam_cut: float) -> float:
    return math.log(beam_cut) if beam_cut > 0 else float(np.finfo(np.float32).max)


def _check_inputs(scores: torch.Tensor, back_guide: torch.Tensor, w: int) -> tuple[int, int, int]:
    if scores.dim() != 3 or scores.shape[2] % 4 or 0 in scores.shape:
        raise ValueError(f"scores: expected [T, N, C], got {tuple(scores.shape)}")
    t_len, n, c = scores.shape
    s = c // 4
    if s & (s - 1) or tuple(back_guide.shape) != (t_len + 1, n, s):
        raise ValueError(
            f"back_guide: expected {(t_len + 1, n, s)}, got {tuple(back_guide.shape)}"
        )
    if not 0 < w <= min(s, 128):
        raise ValueError(f"beam_width {w} out of range for {s} states")
    return t_len, n, s


def beam_init(back0: torch.Tensor, w: int) -> torch.Tensor:
    """States [N, W] int64 of the initial beam: the W best states of the
    first row [N, S] of the backward scores, in state order. Each starts with score 0
    and the hash of its state from the CRC seed."""
    s = back0.shape[1]
    kth = torch.sort(back0, dim=1, descending=True).values[:, w - 1 : w]
    key = torch.where(back0 >= kth, 0, 1) * s + torch.arange(s, device=back0.device)
    return torch.sort(key, dim=1).values[:, :w] % s


def beam_forward_plain(
    scores: torch.Tensor,
    back_guide: torch.Tensor,
    beam_width: int = 32,
    beam_cut: float = 100.0,
    fixed_stay_score: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward beam, one step per time step in plain PyTorch.

    scores [T, N, C] float32, back_guide [T+1, N, S] float32 -> (hist_state
    [T, N, W] int32, hist_ps [T, N, W] uint8 = parent | stay << 7, final raw
    scores [N, W] float32)."""
    w = int(beam_width)
    t_len, n, s = _check_inputs(scores, back_guide, w)
    dev = scores.device
    bits = s.bit_length() - 1
    log_cut = _log_beam_cut(beam_cut)
    min_width = (w * 8) // 10
    crc2_table = torch.as_tensor(_CRC2, device=dev)
    base = torch.arange(4, device=dev)
    elem = torch.arange(w, device=dev)
    slot_base = torch.arange(4 * w, device=dev) & 3
    cand_parent = torch.cat([elem.repeat_interleave(4), elem]).expand(n, -1)
    cand_stay = torch.cat(
        [torch.zeros(4 * w, dtype=torch.bool, device=dev),
         torch.ones(w, dtype=torch.bool, device=dev)]
    ).expand(n, -1)

    state = beam_init(back_guide[0], w)
    hashes = _crc32(
        torch.full_like(state, _CRC_SEED), state, torch.as_tensor(_CRC8, device=dev)
    )
    score = torch.zeros(n, w, dtype=torch.float32, device=dev)
    raw = score
    hist_state = torch.empty(t_len, n, w, dtype=torch.int32, device=dev)
    hist_ps = torch.empty(t_len, n, w, dtype=torch.uint8, device=dev)

    for t in range(t_len):
        sc_t, back_t = scores[t], back_guide[t + 1]
        shifted = (state << 2) & (s - 1)
        dropped = state >> (bits - 2)
        step_state = shifted[..., None] | base  # [N, W, 4]
        trans = sc_t.gather(1, (step_state * 4 + dropped[..., None]).reshape(n, -1))
        back_step = back_t.gather(1, step_state.reshape(n, -1))  # [N, 4W]
        step_s = score.repeat_interleave(4, dim=1) + trans + back_step
        step_h = _crc2(hashes[..., None], base, crc2_table).reshape(n, -1)
        stay_back = back_t.gather(1, state)
        stay_score = score + fixed_stay_score + stay_back

        # the stay/step merge as one [N, W stays, 4W steps] comparison
        match = (
            (step_h[:, None, :] == hashes[:, :, None])
            & (slot_base == (state[:, :, None] & 3))
            & (step_s[:, None, :] > NEG / 2)
            & (stay_score[:, :, None] > NEG / 2)
        )
        folded = _lse(stay_score[:, :, None], step_s[:, None, :])
        stay_wins = stay_score[:, :, None] > step_s[:, None, :]
        wins, loses = match & stay_wins, match & ~stay_wins
        new_step = torch.where(
            wins.any(dim=1), NEG,
            torch.where(loses.any(dim=1), torch.where(loses, folded, NEG).amax(dim=1), step_s),
        )
        new_stay = torch.where(
            loses.any(dim=2), NEG,
            torch.where(wins.any(dim=2), torch.where(wins, folded, NEG).amax(dim=2), stay_score),
        )
        cand_score = torch.cat([new_step, new_stay], dim=1)  # [N, 5W]

        # cutoff with bisection width control (at most 9 rounds)
        max_score = cand_score.amax(dim=1)
        cutoff = max_score - log_cut

        def count_ge(cut):
            return (cand_score >= cut[:, None]).sum(dim=1)

        lo, hi = cutoff, max_score
        done = ~(count_ge(cutoff) > w)
        for _ in range(9):
            cnt = count_ge(cutoff)
            too_many = cnt > w
            need = (too_many | (cnt < min_width)) & ~done
            mid = torch.where(too_many, (cutoff + hi) / 2.0, (cutoff + lo) / 2.0)
            lo = torch.where(too_many & need, cutoff, lo)
            hi = torch.where(~too_many & need, cutoff, hi)
            cutoff = torch.where(need, mid, cutoff)
            done = done | ~need
        cutoff = torch.where(done, cutoff, hi)

        # the first W candidates at or above the cutoff, in candidate order
        keep = cand_score >= cutoff[:, None]
        order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :w]
        alive = elem < keep.sum(dim=1).clamp(max=w)[:, None]
        cand_state = torch.cat([step_state.reshape(n, -1), state], dim=1)
        cand_hash = torch.cat([step_h, hashes], dim=1)
        cand_back = torch.cat([back_step, stay_back], dim=1)
        state = torch.where(alive, cand_state.gather(1, order), 0)
        hashes = torch.where(alive, cand_hash.gather(1, order), 0)
        raw = torch.where(alive, cand_score.gather(1, order), NEG)
        score = torch.where(alive, raw - cand_back.gather(1, order), NEG)
        parent = torch.where(alive, cand_parent.gather(1, order), 0)
        stayed = alive & cand_stay.gather(1, order)
        hist_state[t] = state.to(torch.int32)
        hist_ps[t] = (parent | (stayed.to(torch.int64) << 7)).to(torch.uint8)
    return hist_state, hist_ps, raw


def beam_forward(
    scores: torch.Tensor,
    back_guide: torch.Tensor,
    beam_width: int = 32,
    beam_cut: float = 100.0,
    fixed_stay_score: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward beam over all time steps: (hist_state [T, N, W] int32,
    hist_ps [T, N, W] uint8 = parent | stay << 7, final raw scores [N, W]).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (float32, beam width 32, 64, 256 or 1024 states); the initial beam's
    states are picked in PyTorch, with nothing copied from the host, so the
    call does not wait for the stream."""
    if scores.device.type == "cpu":
        return beam_forward_plain(scores, back_guide, beam_width, beam_cut, fixed_stay_score)
    w = int(beam_width)
    t_len, n, s = _check_inputs(scores, back_guide, w)
    if w != KERNEL_BEAM_WIDTH or s not in KERNEL_STATES:
        raise ValueError(f"beam_forward: the kernel takes beam width 32 and {KERNEL_STATES} "
                         f"states, not width {w} and {s} states")
    _cuda.check_tensor(scores, "scores", torch.float32, (t_len, n, 4 * s))
    _cuda.check_tensor(back_guide, "back_guide", torch.float32, (t_len + 1, n, s))
    if back_guide.device != scores.device:
        raise ValueError("beam_forward: inputs are on different devices")
    dev = scores.device
    init_state = beam_init(back_guide[0], w).to(torch.int32).contiguous()
    hist_state = torch.empty(t_len, n, w, dtype=torch.int32, device=dev)
    hist_ps = torch.empty(t_len, n, w, dtype=torch.uint8, device=dev)
    final = torch.empty(n, w, dtype=torch.float32, device=dev)
    _cuda.launch(
        "beam_search", "beam_forward_f32",
        [_cuda.VOIDP] * 6 + [_cuda.INT] * 3 + [_cuda.FLOAT] * 2, dev,
        scores.data_ptr(), back_guide.data_ptr(), init_state.data_ptr(),
        hist_state.data_ptr(), hist_ps.data_ptr(), final.data_ptr(),
        t_len, n, s, _log_beam_cut(beam_cut), float(fixed_stay_score),
    )
    beam_forward.launches += 1
    return hist_state, hist_ps, final


beam_forward.launches = 0


def beam_traceback_plain(
    hist_state: torch.Tensor, hist_ps: torch.Tensor, final_score: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(states [N, T] int32, moves [N, T] uint8, moves[:, 0] = 1): the
    history followed backwards from the best final element."""
    t_len, n, _ = hist_state.shape
    dev = hist_state.device
    elem = torch.argmax(final_score, dim=1)[:, None]
    states = torch.empty(n, t_len, dtype=torch.int32, device=dev)
    moves = torch.empty(n, t_len, dtype=torch.uint8, device=dev)
    for t in range(t_len - 1, -1, -1):
        ps = hist_ps[t].gather(1, elem).to(torch.int64)
        states[:, t] = hist_state[t].gather(1, elem)[:, 0]
        moves[:, t] = ((ps & 0x80) == 0)[:, 0]
        elem = ps & 0x7F
    moves[:, 0] = 1
    return states, moves


def beam_traceback(
    hist_state: torch.Tensor, hist_ps: torch.Tensor, final_score: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Traceback of ``beam_forward``'s history: (states [N, T] int32, moves
    [N, T] uint8). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (beam width 32)."""
    if hist_state.device.type == "cpu":
        return beam_traceback_plain(hist_state, hist_ps, final_score)
    if hist_state.dim() != 3 or 0 in hist_state.shape or hist_state.shape[2] != KERNEL_BEAM_WIDTH:
        raise ValueError(f"hist_state: unsupported shape {tuple(hist_state.shape)}")
    t_len, n, _ = hist_state.shape
    states = torch.empty(n, t_len, dtype=torch.int32, device=hist_state.device)
    moves = torch.empty(n, t_len, dtype=torch.uint8, device=hist_state.device)
    _launch_traceback(hist_state, hist_ps, final_score, states, moves)
    return states, moves


def _launch_traceback(
    hist_state: torch.Tensor,
    hist_ps: torch.Tensor,
    final_score: torch.Tensor,
    states: torch.Tensor,
    moves: torch.Tensor,
) -> None:
    """The beam traceback kernel on CUDA tensors into states [N, T] int32 and
    moves [N, T] uint8."""
    t_len, n, w = hist_state.shape
    _cuda.check_tensor(hist_state, "hist_state", torch.int32, (t_len, n, w))
    _cuda.check_tensor(hist_ps, "hist_ps", torch.uint8, (t_len, n, w))
    _cuda.check_tensor(final_score, "final_score", torch.float32, (n, w))
    _cuda.check_tensor(states, "states", torch.int32, (n, t_len))
    _cuda.check_tensor(moves, "moves", torch.uint8, (n, t_len))
    dev = hist_state.device
    if not (hist_ps.device == final_score.device == states.device == moves.device == dev):
        raise ValueError("beam_traceback: inputs are on different devices")
    _cuda.launch(
        "beam_search", "beam_traceback", [_cuda.VOIDP] * 5 + [_cuda.INT] * 2, dev,
        hist_state.data_ptr(), hist_ps.data_ptr(), final_score.data_ptr(),
        states.data_ptr(), moves.data_ptr(), t_len, n,
    )
    beam_traceback.launches += 1


beam_traceback.launches = 0


def beam_search_plain(
    scores: torch.Tensor,
    back_guide: torch.Tensor,
    beam_width: int = 32,
    beam_cut: float = 100.0,
    fixed_stay_score: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search in plain PyTorch: (states [N, T] int32, moves [N, T] uint8)."""
    return beam_traceback_plain(
        *beam_forward_plain(scores, back_guide, beam_width, beam_cut, fixed_stay_score)
    )


def beam_search_device(
    scores: torch.Tensor,
    back_guide: torch.Tensor,
    beam_width: int = 32,
    beam_cut: float = 100.0,
    fixed_stay_score: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search over scores [T, N, C] float32 guided by the backward
    scores [T+1, N, S]: (states [N, T] int32, moves [N, T] uint8). The
    forward beam and the traceback are kernels on CUDA tensors."""
    return beam_traceback(
        *beam_forward(scores, back_guide, beam_width, beam_cut, fixed_stay_score)
    )
