"""LSTM recurrence over pre-projected gates (the serial part of a layer).

Port of ``dorado_tpu/ops/lstm.py::lstm_scan_time_major``. The input
projection ``x @ W_ih^T + b`` is not here: the caller runs it as one large
time-parallel matmul. Each step computes ``gates = xproj[t] + h @ W_hh^T``
(gate order i, f, g, o), keeps ``c`` in float32 and ``h`` in the input dtype;
``reverse=True`` walks time backwards without flipping any data.

On a CUDA tensor the wrapper launches ``csrc/lstm_scan.cu`` (bf16); on a CPU
tensor it runs the plain version below.
"""

from __future__ import annotations

import torch

from dorado_tpu_torch.ops import _cuda


def lstm_scan_plain(xproj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """[T, N, 4H] gates + [H, 4H] recurrent weights -> [T, N, H], one step
    at a time in plain PyTorch (float32 sums, float32 cell state)."""
    t_len, n, g4 = xproj.shape
    hidden = g4 // 4
    w = w_hh_t.float()
    h = torch.zeros(n, hidden, dtype=xproj.dtype, device=xproj.device)
    c = torch.zeros(n, hidden, dtype=torch.float32, device=xproj.device)
    out = torch.empty(t_len, n, hidden, dtype=xproj.dtype, device=xproj.device)
    for step in range(t_len):
        t = t_len - 1 - step if reverse else step
        gates = xproj[t].float() + h.float() @ w
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(xproj.dtype)
        out[t] = h
    return out


def _rows_per_block(n: int, device: torch.device) -> int:
    """Batch rows per block. Every block re-reads W_hh from L2 each step,
    and with one row per block the step is bound by that L2 traffic; so take
    the fewest rows per block that still fit the batch in one wave of blocks
    (one per SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fitting = [r for r in (1, 2, 4) if n % r == 0 and n // r <= sms]
    return fitting[0] if fitting else max(r for r in (1, 2, 4) if n % r == 0)


def lstm_scan_time_major(
    xproj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """[T, N, 4H] pre-projected gates + [H, 4H] recurrent weights -> [T, N, H].

    A CPU tensor takes the plain version; a CUDA tensor (bf16, H a multiple
    of 4 up to 512, the kernel's four slices of k) launches the kernel."""
    if xproj.device.type == "cpu":
        return lstm_scan_plain(xproj, w_hh_t, reverse)
    t_len, n, g4 = xproj.shape
    hidden = g4 // 4
    if g4 != 4 * hidden or hidden % 4 or not 0 < hidden <= 512 or t_len == 0 or n == 0:
        raise ValueError(f"lstm_scan: unsupported gate shape {tuple(xproj.shape)}")
    _cuda.check_tensor(xproj, "xproj", torch.bfloat16, (t_len, n, g4))
    _cuda.check_tensor(w_hh_t, "w_hh_t", torch.bfloat16, (hidden, g4))
    if w_hh_t.device != xproj.device:
        raise ValueError("lstm_scan: xproj and w_hh_t are on different devices")
    out = torch.empty(t_len, n, hidden, dtype=xproj.dtype, device=xproj.device)
    fn = _cuda.kernel_function(
        "lstm_scan", "lstm_scan_bf16", [_cuda.VOIDP] * 3 + [_cuda.INT] * 5 + [_cuda.VOIDP]
    )
    with torch.cuda.device(xproj.device):
        code = fn(
            xproj.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(),
            t_len, n, hidden, int(reverse), _rows_per_block(n, xproj.device),
            _cuda.stream_ptr(xproj.device),
        )
    _cuda.check_launch("lstm_scan", code)
    lstm_scan_time_major.launches += 1
    return out


lstm_scan_time_major.launches = 0
