"""The decoders' lattice kernels: the Viterbi path's backward LSE scan,
fused forward pass and traceback, the full-history LSE scans that the
beam path's posteriors and backward scores come from, and the standalone
Viterbi forward pass and float32 fused forward pass.

Port of the decode kernels of ``dorado_tpu/ops/crf_pallas.py``
(``fused_viterbi_decode`` -> ``_lse_scan_pallas_blk`` +
``_fused_forward_decode_blk``, then ``viterbi_traceback_pallas``;
``forward_scores_pallas``/``backward_scores_pallas`` -> ``_lse_scan_pallas``,
or ``_lse_scan_pallas_blk`` at 1024 states; ``viterbi_path_pallas`` ->
``_viterbi_fwd_pallas`` or ``_viterbi_fwd_pallas_blk``, then the traceback;
``fused_forward_decode_pallas``). Scores stay in the raw layout
c = s*4 + r; the TPU's block permutation is not used, so one kernel serves
where the JAX package has a dense and a block-layout one.

Each wrapper launches its CUDA kernel (``csrc/crf_*.cu``) on CUDA tensors
and runs its plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from dorado_tpu_torch.ops import _cuda
from dorado_tpu_torch.ops.crf_scan import (
    backward_scores as backward_scores_plain,
    forward_scores as forward_scores_plain,
    lse_step,
    predecessor_index,
    viterbi_step,
    viterbi_traceback as viterbi_traceback_plain,
)


def _stream_dtype(scores: torch.Tensor) -> torch.dtype:
    # a bf16 score stream gets bf16 beta and posterior streams, as on the TPU
    return torch.bfloat16 if scores.dtype == torch.bfloat16 else torch.float32


# the state counts every kernel of this module is built for
KERNEL_STATES = (64, 256, 1024)


def _check_scores(
    scores: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> tuple[int, int, int]:
    """(T, N, S) of a score tensor the kernels take."""
    if scores.dim() != 3:
        raise ValueError(f"scores: expected [T, N, C], got {tuple(scores.shape)}")
    t_len, n, c = scores.shape
    if c // 4 not in KERNEL_STATES or c % 4 or t_len == 0 or n == 0:
        raise ValueError(
            f"scores: unsupported shape {tuple(scores.shape)} (states {KERNEL_STATES})"
        )
    _cuda.check_tensor(scores, "scores", dtype, (t_len, n, c))
    return t_len, n, c // 4


# ---------------------------------------------------------------------------
# K3: backward LSE scan, shifted stream
# ---------------------------------------------------------------------------


def backward_scores_shifted_plain(scores: torch.Tensor, stay_score: float) -> torch.Tensor:
    """[T, N, C] scores -> [T, N, S] with row j = beta[j+1] - max(beta[j+1]),
    in the stream dtype."""
    beta = backward_scores_plain(scores, stay_score)[1:]
    return (beta - beta.amax(dim=-1, keepdim=True)).to(_stream_dtype(scores))


def backward_scores_shifted(scores: torch.Tensor, stay_score: float) -> torch.Tensor:
    """Backward LSE scan emitting the shifted, max-normalised beta stream
    the fused forward pass consumes (row j = beta[j+1] - its row max)."""
    if scores.device.type == "cpu":
        return backward_scores_shifted_plain(scores, stay_score)
    t_len, n, s = _check_scores(scores)
    out = torch.empty(t_len, n, s, dtype=torch.bfloat16, device=scores.device)
    _cuda.launch(
        "crf_lse_backward", "crf_lse_backward_bf16",
        [_cuda.VOIDP, _cuda.VOIDP, _cuda.INT, _cuda.INT, _cuda.INT, _cuda.FLOAT], scores.device,
        scores.data_ptr(), out.data_ptr(), t_len, n, s, math.exp(stay_score),
    )
    backward_scores_shifted.launches += 1
    return out


backward_scores_shifted.launches = 0


# ---------------------------------------------------------------------------
# K6 (and K3's full-history outputs at 1024 states): LSE scans on the raw
# layout, forward and backward in one launch
# ---------------------------------------------------------------------------


def _lse_scans(scores: torch.Tensor, stay_score: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The histories (alpha, beta) [T+1, N, S] of float32 scores on a CUDA
    tensor, both directions in one launch."""
    t_len, n, s = _check_scores(scores, torch.float32)
    alpha, beta = (
        torch.empty(t_len + 1, n, s, dtype=torch.float32, device=scores.device)
        for _ in range(2)
    )
    _cuda.launch(
        "crf_lse_scan", "crf_lse_scans_f32", [_cuda.VOIDP] * 3 + [_cuda.INT] * 3 + [_cuda.DOUBLE],
        scores.device,
        scores.data_ptr(), alpha.data_ptr(), beta.data_ptr(), t_len, n, s, math.exp(stay_score),
    )
    return alpha, beta


def forward_scores(scores: torch.Tensor, stay_score: float) -> torch.Tensor:
    """alpha over time: float32 [T, N, C] scores -> float32 [T+1, N, S],
    row 0 the zero init row (``crf_scan.forward_scores``'s convention). On a
    CUDA tensor it is the forward half of the one-launch pair."""
    if scores.device.type == "cpu":
        return forward_scores_plain(scores, stay_score)
    alpha, _ = _lse_scans(scores, stay_score)
    forward_scores.launches += 1
    return alpha


forward_scores.launches = 0


def backward_scores(scores: torch.Tensor, stay_score: float) -> torch.Tensor:
    """beta over time: float32 [T, N, C] scores -> float32 [T+1, N, S],
    row T the zero init row (``crf_scan.backward_scores``'s convention). On
    a CUDA tensor it is the backward half of the one-launch pair."""
    if scores.device.type == "cpu":
        return backward_scores_plain(scores, stay_score)
    _, beta = _lse_scans(scores, stay_score)
    backward_scores.launches += 1
    return beta


backward_scores.launches = 0


def forward_backward_scores(
    scores: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha, beta): ``forward_scores`` and ``backward_scores`` of float32
    scores [T, N, C], both directions in one launch on a CUDA tensor."""
    if scores.device.type == "cpu":
        return forward_scores_plain(scores, stay_score), backward_scores_plain(scores, stay_score)
    out = _lse_scans(scores, stay_score)
    forward_backward_scores.launches += 1
    return out


forward_backward_scores.launches = 0


# ---------------------------------------------------------------------------
# K4: fused forward pass (alpha, posteriors, Viterbi choices)
# ---------------------------------------------------------------------------


def viterbi_forward_plain(
    scores: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(choices [T, N, S] int8, final carry [N, S] float32): the max-plus
    forward pass with the carry normalised by its row max before each step."""
    t_len, n, c = scores.shape
    s = c // 4
    dev = scores.device
    ms = scores.float().reshape(t_len, n, s, 4)
    idx = torch.as_tensor(predecessor_index(s), device=dev)
    vit = torch.zeros(n, s, dtype=torch.float32, device=dev)
    choices = torch.empty(t_len, n, s, dtype=torch.int8, device=dev)
    for t in range(t_len):
        vit = vit - vit.amax(dim=-1, keepdim=True)
        vit, choices[t] = viterbi_step(vit, ms[t], idx, stay_score)
    return choices, vit


def fused_forward_decode_plain(
    scores: torch.Tensor, beta_shift: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(posts [T, N, S] softmax(alpha[t+1] + beta_shift[t]) in the stream
    dtype, choices [T, N, S] int8, final Viterbi carry [N, S] float32)."""
    t_len, n, c = scores.shape
    s = c // 4
    dev = scores.device
    es = torch.exp(scores.float())
    idx = torch.as_tensor(predecessor_index(s), device=dev)
    flat = torch.arange(c, device=dev).reshape(s, 4)
    stay_factor = math.exp(stay_score)
    alpha = torch.zeros(n, s, dtype=torch.float32, device=dev)
    posts = torch.empty(t_len, n, s, dtype=_stream_dtype(scores), device=dev)
    for t in range(t_len):
        alpha = lse_step(alpha, es[t], idx, flat, stay_factor)
        posts[t] = torch.softmax(alpha + beta_shift[t].float(), dim=-1).to(posts.dtype)
    return (posts, *viterbi_forward_plain(scores, stay_score))


def _fused_forward_cuda(
    scores: torch.Tensor, beta: torch.Tensor, stay_score: float, full: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's launch (``full`` False: bf16 scores and the shifted beta stream)
    or K8's (float32 scores and the beta history [T+1, N, S]) on CUDA
    tensors."""
    dtype = torch.float32 if full else torch.bfloat16
    t_len, n, s = _check_scores(scores, dtype)
    _cuda.check_tensor(
        beta, "beta_full" if full else "beta_shift", dtype, (t_len + int(full), n, s)
    )
    if beta.device != scores.device:
        name = "fused_forward_decode_full" if full else "fused_forward_decode"
        raise ValueError(f"{name}: inputs are on different devices")
    posts = torch.empty(t_len, n, s, dtype=dtype, device=scores.device)
    choices = torch.empty(t_len, n, s, dtype=torch.int8, device=scores.device)
    final = torch.empty(n, s, dtype=torch.float32, device=scores.device)
    _cuda.launch(
        "crf_fused_forward", "crf_fused_forward_f32" if full else "crf_fused_forward_bf16",
        [_cuda.VOIDP] * 5 + [_cuda.INT] * 3 + [_cuda.FLOAT], scores.device,
        scores.data_ptr(), beta.data_ptr(), posts.data_ptr(), choices.data_ptr(),
        final.data_ptr(), t_len, n, s, float(stay_score),
    )
    return posts, choices, final


def fused_forward_decode(
    scores: torch.Tensor, beta_shift: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over the scores: alpha LSE, posterior rows and Viterbi
    choices (4 = stay). Returns (posts, choices, final carry)."""
    if scores.device.type == "cpu":
        return fused_forward_decode_plain(scores, beta_shift, stay_score)
    out = _fused_forward_cuda(scores, beta_shift, stay_score, full=False)
    fused_forward_decode.launches += 1
    return out


fused_forward_decode.launches = 0


def fused_viterbi_decode(
    scores: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(posts rows 1..T, choices, final) for the Viterbi path: the backward
    LSE scan, then the fused forward pass."""
    beta_shift = backward_scores_shifted(scores, stay_score)
    return fused_forward_decode(scores, beta_shift, stay_score)


# ---------------------------------------------------------------------------
# K8: the fused forward pass on float32 streams and the unshifted beta
# ---------------------------------------------------------------------------


def fused_forward_decode_full_plain(
    scores: torch.Tensor, beta_full: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's plain version: K4's on the beta history's rows 1..T."""
    return fused_forward_decode_plain(scores.float(), beta_full[1:].float(), stay_score)


def fused_forward_decode_full(
    scores: torch.Tensor, beta_full: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over float32 scores [T, N, C] and the float32 beta history
    [T+1, N, S] (``backward_scores``): (posts [T, N, S] float32 with
    posts[t] = softmax(alpha[t+1] + beta_full[t+1]), choices [T, N, S] int8,
    final Viterbi carry [N, S] float32). The choices and final carry are
    ``viterbi_forward``'s."""
    if scores.device.type == "cpu":
        return fused_forward_decode_full_plain(scores, beta_full, stay_score)
    out = _fused_forward_cuda(scores, beta_full, stay_score, full=True)
    fused_forward_decode_full.launches += 1
    return out


fused_forward_decode_full.launches = 0


# ---------------------------------------------------------------------------
# K7a, K7b: the Viterbi forward pass alone
# ---------------------------------------------------------------------------


def viterbi_forward(
    scores: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-plus forward pass over float32 scores [T, N, C]: (choices
    [T, N, S] int8, 0..3 the predecessor slot and 4 a stay; final carry
    [N, S] float32), the carry normalised by its row max before each step.
    On the card it is K4's kernel with alpha and the posteriors compiled
    out."""
    if scores.device.type == "cpu":
        return viterbi_forward_plain(scores, stay_score)
    t_len, n, s = _check_scores(scores, torch.float32)
    choices = torch.empty(t_len, n, s, dtype=torch.int8, device=scores.device)
    final = torch.empty(n, s, dtype=torch.float32, device=scores.device)
    _launch_viterbi_forward(scores, stay_score, choices, final)
    return choices, final


def _launch_viterbi_forward(
    scores: torch.Tensor, stay_score: float, choices: torch.Tensor, final: torch.Tensor
) -> None:
    """K7 on CUDA tensors into choices [T, N, S] int8 and final [N, S]
    float32."""
    t_len, n, s = _check_scores(scores, torch.float32)
    _cuda.check_tensor(choices, "choices", torch.int8, (t_len, n, s))
    _cuda.check_tensor(final, "final", torch.float32, (n, s))
    if not scores.device == choices.device == final.device:
        raise ValueError("viterbi_forward: inputs are on different devices")
    _cuda.launch(
        "crf_viterbi_forward", "crf_viterbi_forward_f32",
        [_cuda.VOIDP] * 3 + [_cuda.INT] * 3 + [_cuda.FLOAT], scores.device,
        scores.data_ptr(), choices.data_ptr(), final.data_ptr(), t_len, n, s, float(stay_score),
    )
    viterbi_forward.launches += 1


viterbi_forward.launches = 0


def viterbi_path(
    scores: torch.Tensor, stay_score: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact Viterbi path of float32 scores [T, N, C]: (states [T, N]
    int32, moves [T, N] uint8, moves[0] = 1), by the Viterbi forward pass
    and the traceback from each row's best final state."""
    choices, final = viterbi_forward(scores, stay_score)
    return viterbi_traceback(choices, torch.argmax(final, dim=-1).to(torch.int32))


# ---------------------------------------------------------------------------
# K5: traceback
# ---------------------------------------------------------------------------


def viterbi_traceback(
    choices: torch.Tensor, last_state: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(states [T, N] int32, moves [T, N] uint8, moves[0] = 1) from the
    choices [T, N, S] and the final states [N]. On the card the kernel
    writes each row's steps contiguously: the two are [T, N] views of
    [N, T] tensors."""
    if choices.device.type == "cpu":
        return viterbi_traceback_plain(choices, last_state)
    if choices.dim() != 3 or 0 in choices.shape or choices.shape[2] not in KERNEL_STATES:
        raise ValueError(
            f"choices: unsupported shape {tuple(choices.shape)} (states {KERNEL_STATES})"
        )
    t_len, n, _ = choices.shape
    states = torch.empty(n, t_len, dtype=torch.int32, device=choices.device)
    moves = torch.empty(n, t_len, dtype=torch.uint8, device=choices.device)
    _launch_traceback(choices, last_state, states, moves)
    return states.t(), moves.t()


def _launch_traceback(
    choices: torch.Tensor, last_state: torch.Tensor, states: torch.Tensor, moves: torch.Tensor
) -> None:
    """K5 on CUDA tensors into states [N, T] int32 and moves [N, T] uint8."""
    t_len, n, s = choices.shape
    _cuda.check_tensor(choices, "choices", torch.int8, (t_len, n, s))
    _cuda.check_tensor(last_state, "last_state", torch.int32, (n,))
    _cuda.check_tensor(states, "states", torch.int32, (n, t_len))
    _cuda.check_tensor(moves, "moves", torch.uint8, (n, t_len))
    if not (last_state.device == states.device == moves.device == choices.device):
        raise ValueError("viterbi_traceback: inputs are on different devices")
    _cuda.launch(
        "crf_traceback", "crf_traceback", [_cuda.VOIDP] * 4 + [_cuda.INT] * 3, choices.device,
        choices.data_ptr(), last_state.data_ptr(), states.data_ptr(), moves.data_ptr(),
        t_len, n, s,
    )
    viterbi_traceback.launches += 1


viterbi_traceback.launches = 0

