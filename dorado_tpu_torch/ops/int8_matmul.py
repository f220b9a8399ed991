"""W8A8 matmul for the LSTM input projections: int8 weights, activations
quantised to int8 per row inside the kernel.

Port of ``dorado_tpu/ops/int8_matmul.py``: ``quantize_weight_rows`` and
``w8a8_matmul_fq`` (Pallas body ``_fq_kernel``). Weights are symmetric int8
per output channel, activations symmetric int8 per row, the product sums in
int32 and is rescaled in float32 with the bias added there.

On a CUDA tensor the wrapper launches ``csrc/w8a8_matmul_fq.cu`` (bf16 in and
out); on a CPU tensor it runs the plain version below. The two agree bit for
bit: the int32 sums are exact and every float step is one rounded operation
in both.
"""

from __future__ import annotations

import torch

from dorado_tpu_torch.ops import _cuda


def quantize_weight_rows(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[O, K] float weight -> ([O, K] int8, [O] float32 scale): symmetric
    per-output-channel amax/127 quantisation."""
    wf = w.float()
    scale = wf.abs().amax(dim=-1).clamp(min=1e-12) / 127.0
    wq = torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return wq, scale


def w8a8_matmul_fq_plain(
    x: torch.Tensor,
    wq_t: torch.Tensor,
    ws: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[..., K] activations @ [K, O] int8 weights -> [..., O] in plain
    PyTorch, in the kernel's arithmetic: the row scale and its reciprocal
    are multiplied in, not divided by."""
    k, o = wq_t.shape
    xf = x.reshape(-1, k).float()
    s = xf.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) * (1.0 / 127.0)
    xq = torch.round(xf * torch.reciprocal(s))
    # int8 x int8 products summed in a float type that holds them exactly
    # (|sum| <= K * 127^2 < 2^24 up to K = 1040): integer matmuls are not
    # available on every device
    exact = torch.float32 if k * 127 * 127 < 2**24 else torch.float64
    acc = torch.matmul(xq.to(exact), wq_t.to(exact)).float()
    out = acc * s * ws.float().reshape(1, o)
    if bias is not None:
        out = out + bias.float().reshape(1, o)
    return out.to(out_dtype).reshape(*x.shape[:-1], o)


def w8a8_matmul_fq(
    x: torch.Tensor,
    wq_t: torch.Tensor,
    ws: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[..., K] activations @ [K, O] int8 weights (``ws`` [O] float32 scales,
    ``bias`` [O] float32 added in the epilogue) -> [..., O].

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel:
    bf16 in and out, K a multiple of 128 up to 768, O a multiple of 128, any
    number of rows. The kernel reads the weights one output channel a row, so
    ``wq_t`` given as the transposed view of a contiguous [O, K] tensor (as
    the model holds it) is used as it is; any other layout is copied."""
    if x.device.type == "cpu":
        return w8a8_matmul_fq_plain(x, wq_t, ws, bias, out_dtype)
    if wq_t.dim() != 2:
        raise ValueError(f"wq_t: expected [K, O], got {tuple(wq_t.shape)}")
    k, o = wq_t.shape
    if k % 128 or not 0 < k <= 768 or o % 128 or o == 0:
        raise ValueError(f"w8a8_matmul_fq: unsupported weight shape {(k, o)}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"w8a8_matmul_fq: the kernel writes bf16, not {out_dtype}")
    if x.dim() < 1 or x.shape[-1] != k or x.numel() == 0:
        raise ValueError(f"x: expected [..., {k}], got {tuple(x.shape)}")
    lead = x.shape[:-1]
    m = x.numel() // k
    _cuda.check_tensor(x, "x", torch.bfloat16, (*lead, k))
    wq = wq_t.t().contiguous()
    _cuda.check_tensor(wq, "wq_t", torch.int8, (o, k))
    ws = ws.reshape(o)
    _cuda.check_tensor(ws, "ws", torch.float32, (o,))
    if bias is None:
        bias = torch.zeros(o, dtype=torch.float32, device=x.device)
    _cuda.check_tensor(bias, "bias", torch.float32, (o,))
    if not (wq.device == ws.device == bias.device == x.device):
        raise ValueError("w8a8_matmul_fq: inputs are on different devices")
    out = torch.empty(*lead, o, dtype=torch.bfloat16, device=x.device)
    fn = _cuda.kernel_function(
        "w8a8_matmul_fq", "w8a8_matmul_fq_bf16",
        [_cuda.VOIDP] * 5 + [_cuda.INT] * 3 + [_cuda.VOIDP],
    )
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), out.data_ptr(),
            m, k, o, _cuda.stream_ptr(x.device),
        )
    _cuda.check_launch("w8a8_matmul_fq", code)
    w8a8_matmul_fq.launches += 1
    return out


w8a8_matmul_fq.launches = 0
