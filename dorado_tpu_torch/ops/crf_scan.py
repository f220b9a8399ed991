"""CRF lattice scans in plain PyTorch: forward/backward log-sum-exp and
Viterbi over the 4^state_len k-mer states.

Port of ``dorado_tpu/ops/crf_scan.py``. Lattice semantics (parity with
dorado/basecall/decode/CPUDecoder.cpp:17-99):
  - state s encodes the most recent ``state_len`` bases, newest base in the
    low two bits;
  - a *step* transition p -> s exists iff s == ((p << 2) | b) & mask; its
    score lives at flat index s*4 + r where r = p >> 2*(state_len-1) is the
    dropped oldest base of p;
  - every state also has a *stay* with a fixed score (the model's
    blank_score).

The LSE runs in exp space with a per-row max shift: states more than ~87
nats below their row's best underflow to -inf, which is harmless downstream.
These loops are the plain versions the CUDA kernels of ``crf_cuda.py`` are
held against, and what those kernels' wrappers run on CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def predecessor_index(num_states: int) -> np.ndarray:
    """idx[s, r] = r*(num_states//4) + s//4: the 4 states that can step into s."""
    s = np.arange(num_states)
    r = np.arange(4)
    return (r[None, :] * (num_states // 4) + (s[:, None] >> 2)).astype(np.int64)


def successor_index(num_states: int) -> np.ndarray:
    """succ[s, b] = ((s << 2) | b) & mask: the 4 states reachable from s."""
    s = np.arange(num_states)
    b = np.arange(4)
    return (((s[:, None] << 2) | b[None, :]) & (num_states - 1)).astype(np.int64)


def _backward_gather(num_states: int) -> tuple[np.ndarray, np.ndarray]:
    """(succ [S, 4], flat score index [S, 4]) of each state's 4 outgoing
    transitions: the score of s -> succ[s, b] is at succ[s, b]*4 + oldest(s)."""
    succ = successor_index(num_states)
    state_len = int(round(math.log(num_states, 4)))
    oldest = np.arange(num_states) >> (2 * (state_len - 1))
    return succ, succ * 4 + oldest[:, None]


def lse_step(
    carry: torch.Tensor, es_t: torch.Tensor, idx: torch.Tensor, flat: torch.Tensor,
    stay_factor: float,
) -> torch.Tensor:
    """One exp-space LSE step: carry [N, S] (log domain), es_t [N, C] =
    exp(scores at t), idx/flat [S, 4] source states and score indices."""
    m = carry.amax(dim=-1, keepdim=True)
    ea = torch.exp(carry - m)
    stepped = (ea[:, idx] * es_t[:, flat]).sum(dim=-1)
    return m + torch.log(stepped + ea * stay_factor)


def viterbi_step(
    carry: torch.Tensor, ms_t: torch.Tensor, idx: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """One max-plus step: carry [N, S], ms_t [N, S, 4] step scores. Returns
    (new carry, choices int8: 0..3 = predecessor slot, lowest on ties;
    4 = stay, taken when stay >= best step)."""
    s0, s1, s2, s3 = (carry[:, idx] + ms_t).unbind(dim=-1)
    m01, m23 = torch.maximum(s0, s1), torch.maximum(s2, s3)
    best = torch.maximum(m01, m23)
    best_r = torch.where(
        m01 >= m23, torch.where(s0 >= s1, 0, 1), torch.where(s2 >= s3, 2, 3)
    )
    stay = carry + stay_score
    is_stay = stay >= best
    return (
        torch.where(is_stay, stay, best),
        torch.where(is_stay, 4, best_r).to(torch.int8),
    )


def _scan(scores_tnc: torch.Tensor, stay_score: float, reverse: bool) -> torch.Tensor:
    """The full-history LSE scan: each step's log-sum-exp in float64 from the
    float32 carry, rounded to the float32 carry and history. So any two
    implementations that do the same (K6 does) agree bit for bit but in the
    rare case of a float64 result within a few float64 rounding errors of a
    float32 rounding boundary; in float32 throughout, their different exp,
    log and summation orders leave one float32 step between them at values of
    thousands, which the beam search amplifies."""
    t_len, n, c = scores_tnc.shape
    num_states = c // 4
    dev = scores_tnc.device
    if reverse:
        idx, flat = _backward_gather(num_states)
    else:
        idx, flat = predecessor_index(num_states), np.arange(c).reshape(num_states, 4)
    idx = torch.as_tensor(idx, device=dev)
    flat = torch.as_tensor(flat, device=dev)
    stay_factor = math.exp(stay_score)
    es = torch.exp(scores_tnc.float().double())
    hist = torch.zeros(t_len + 1, n, num_states, dtype=torch.float32, device=dev)
    carry = hist[0 if not reverse else t_len]
    for i in range(t_len):
        t = t_len - 1 - i if reverse else i
        carry = lse_step(carry.double(), es[t], idx, flat, stay_factor).float()
        hist[t if reverse else t + 1] = carry
    return hist


def forward_scores(scores_tnc: torch.Tensor, fixed_stay_score: float) -> torch.Tensor:
    """alpha over time: [T, N, C] transition scores -> [T+1, N, S] float32."""
    return _scan(scores_tnc, fixed_stay_score, reverse=False)


def backward_scores(scores_tnc: torch.Tensor, fixed_stay_score: float) -> torch.Tensor:
    """beta over time: [T, N, C] transition scores -> [T+1, N, S] float32."""
    return _scan(scores_tnc, fixed_stay_score, reverse=True)


def viterbi_path(
    scores_tnc: torch.Tensor, fixed_stay_score: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact max-scoring path: (states [T, N] int32, moves [T, N] uint8),
    moves[t] = 0 marks a stay and moves[0] = 1."""
    t_len, n, c = scores_tnc.shape
    num_states = c // 4
    dev = scores_tnc.device
    ms = scores_tnc.float().reshape(t_len, n, num_states, 4)
    idx = torch.as_tensor(predecessor_index(num_states), device=dev)
    carry = torch.zeros(n, num_states, dtype=torch.float32, device=dev)
    choices = torch.empty(t_len, n, num_states, dtype=torch.int8, device=dev)
    for t in range(t_len):
        carry, choices[t] = viterbi_step(carry, ms[t], idx, fixed_stay_score)
    last_state = torch.argmax(carry, dim=-1).to(torch.int32)
    return viterbi_traceback(choices, last_state)


def viterbi_traceback(
    choices: torch.Tensor, last_state: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reverse traceback over a per-step choice table [T, N, S] (4 = stay,
    0..3 = predecessor slot) from last_state [N]: (states [T, N] int32,
    moves [T, N] uint8) with moves[0] = 1."""
    t_len, n, num_states = choices.shape
    dev = choices.device
    rows = torch.arange(n, device=dev)
    state = last_state.to(torch.int64)
    states = torch.empty(t_len, n, dtype=torch.int32, device=dev)
    moves = torch.empty(t_len, n, dtype=torch.uint8, device=dev)
    for t in range(t_len - 1, -1, -1):
        ch = choices[t, rows, state].to(torch.int64)
        stayed = ch == 4
        states[t] = state.to(torch.int32)
        moves[t] = (~stayed).to(torch.uint8)
        state = torch.where(
            stayed, state, ch.clamp(0, 3) * (num_states // 4) + (state >> 2)
        )
    moves[0] = 1
    return states, moves
