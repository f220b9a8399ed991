"""W8A8 matmuls: int8 weights, activations quantised to int8 per row.

Port of ``dorado_tpu/ops/int8_matmul.py``. Weights are symmetric int8 per
output channel, activations symmetric int8 per row, the products sum in
int32 and are rescaled in float32.

- ``w8a8_matmul_fq`` (Pallas body ``_fq_kernel``): bf16 rows quantised inside
  the kernel, the bias added in its epilogue: the LSTM input projections and
  the transformer's qkv projection. ``csrc/w8a8_matmul_fq.cu``.
- ``swiglu_w8a8`` (``_swiglu_kernel``): the transformer's fc1 on quantised
  rows, both SwiGLU halves, ``y * silu(g)`` and the per-row requantisation of
  the result in one kernel. ``csrc/w8a8_matmul.cu``.
- ``w8a8_matmul`` (``_a8_kernel``): quantised rows times int8 weights, the
  transformer's fc2. ``csrc/w8a8_matmul.cu``.
- ``quantize_rows`` is plain PyTorch, as it is plain XLA there.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version beside it. The int32 sums are exact and every float step
is one rounded operation in both, so ``w8a8_matmul_fq`` and ``w8a8_matmul``
agree with their plain versions bit for bit, and ``swiglu_w8a8`` up to the
last bit of ``exp``.
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


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K] activations -> (int8 [..., K], float32 scale [..., 1]):
    symmetric per-row amax/127 quantisation, with the divides of the JAX
    function. The row maximum is taken in x's dtype (exact) and x meets the
    float32 scale in the divide, so no float32 copy of x is made."""
    scale = x.abs().amax(dim=-1, keepdim=True).float().clamp(min=1e-12) / 127.0
    return torch.round(x / scale).to(torch.int8), scale


def _int_product(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, O] of int8-valued tensors as float32, exactly: summed in
    a float type that holds the sums (|sum| <= K * 127^2 < 2^24 up to
    K = 1040), since integer matmuls are not available on every device."""
    exact = torch.float32 if wq_t.shape[0] * 127 * 127 < 2**24 else torch.float64
    return torch.matmul(xq.to(exact), wq_t.to(exact)).float()


def _weight_rows(
    wq_t: torch.Tensor, ws: torch.Tensor, what: str, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """A [K, O] int8 weight as the kernels read it, one output channel a
    row ([O, K] contiguous: no copy when ``wq_t`` is the transposed view of
    such a tensor), and its [O] float32 scales, both checked."""
    k, o = wq_t.shape
    wq = wq_t.t().contiguous()
    _cuda.check_tensor(wq, what, torch.int8, (o, k))
    ws = ws.reshape(o)
    _cuda.check_tensor(ws, what + " scales", torch.float32, (o,))
    if not (wq.device == ws.device == device):
        raise ValueError(f"{what}: inputs are on different devices")
    return wq, ws


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
    out = _int_product(xq, wq_t) * s * ws.float().reshape(1, o)
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
    number of rows. The kernels read the weights one output channel a row, so
    ``wq_t`` given as the transposed view of a contiguous [O, K] tensor (as
    the models hold it) is used as it is; any other layout is copied."""
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
    wq, ws = _weight_rows(wq_t, ws, "wq_t", x.device)
    if bias is None:
        bias = torch.zeros(o, dtype=torch.float32, device=x.device)
    _cuda.check_tensor(bias, "bias", torch.float32, (o,))
    if bias.device != x.device:
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


# ---------------------------------------------------------------------------
# K12: fc1 + SwiGLU + per-row requantisation
# ---------------------------------------------------------------------------


def swiglu_w8a8_plain(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wy_t: torch.Tensor,
    wys: torch.Tensor,
    wg_t: torch.Tensor,
    wgs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """In plain PyTorch, in the kernel's arithmetic: the sigmoid written out,
    the new row scale and its reciprocal multiplied in."""
    k, f = wy_t.shape
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, k)
    row = xs.reshape(-1, 1).float()
    y = _int_product(x2, wy_t) * row * wys.float().reshape(1, f)
    g = _int_product(x2, wg_t) * row * wgs.float().reshape(1, f)
    t = y * (g * torch.reciprocal(1.0 + torch.exp(-g)))
    s = t.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) * (1.0 / 127.0)
    tq = torch.round(t * torch.reciprocal(s)).to(torch.int8)
    return tq.reshape(*lead, f), s.reshape(*lead, 1)


def swiglu_w8a8(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wy_t: torch.Tensor,
    wys: torch.Tensor,
    wg_t: torch.Tensor,
    wgs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 rows [..., K] with scales ``xs`` [..., 1], the value and gate
    halves of fc1 as [K, F] int8 with [F] float32 scales -> (int8
    ``(x @ Wy) * silu(x @ Wg)`` [..., F], its float32 row scales [..., 1]).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel:
    K a multiple of 128 up to 512, F a multiple of 64, any number of rows."""
    if xq.device.type == "cpu":
        return swiglu_w8a8_plain(xq, xs, wy_t, wys, wg_t, wgs)
    if wy_t.dim() != 2 or wy_t.shape != wg_t.shape:
        raise ValueError(
            f"wy_t, wg_t: expected two [K, F], got {tuple(wy_t.shape)}, {tuple(wg_t.shape)}"
        )
    k, f = wy_t.shape
    if k % 128 or not 0 < k <= 512 or f % 64 or f == 0:
        raise ValueError(f"swiglu_w8a8: unsupported weight shape {(k, f)}")
    if xq.dim() < 1 or xq.shape[-1] != k or xq.numel() == 0:
        raise ValueError(f"xq: expected [..., {k}], got {tuple(xq.shape)}")
    lead = xq.shape[:-1]
    m = xq.numel() // k
    _cuda.check_tensor(xq, "xq", torch.int8, (*lead, k))
    _cuda.check_tensor(xs, "xs", torch.float32, (*lead, 1))
    wy, wys = _weight_rows(wy_t, wys, "wy_t", xq.device)
    wg, wgs = _weight_rows(wg_t, wgs, "wg_t", xq.device)
    if xs.device != xq.device:
        raise ValueError("swiglu_w8a8: inputs are on different devices")
    tq = torch.empty(*lead, f, dtype=torch.int8, device=xq.device)
    ts = torch.empty(*lead, 1, dtype=torch.float32, device=xq.device)
    fn = _cuda.kernel_function(
        "w8a8_matmul", "swiglu_w8a8_i8", [_cuda.VOIDP] * 8 + [_cuda.INT] * 3 + [_cuda.VOIDP]
    )
    with torch.cuda.device(xq.device):
        code = fn(
            xq.data_ptr(), xs.data_ptr(), wy.data_ptr(), wys.data_ptr(), wg.data_ptr(),
            wgs.data_ptr(), tq.data_ptr(), ts.data_ptr(), m, k, f,
            _cuda.stream_ptr(xq.device),
        )
    _cuda.check_launch("w8a8_matmul", code)
    swiglu_w8a8.launches += 1
    return tq, ts


swiglu_w8a8.launches = 0


# ---------------------------------------------------------------------------
# K13: int8 matmul of quantised rows
# ---------------------------------------------------------------------------


def w8a8_matmul_plain(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wq_t: torch.Tensor,
    ws: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """In plain PyTorch: the exact integer product, times the row scale,
    times the channel scale, rounded to ``out_dtype``."""
    k, o = wq_t.shape
    acc = _int_product(xq.reshape(-1, k), wq_t)
    out = acc * xs.reshape(-1, 1).float() * ws.float().reshape(1, o)
    return out.to(out_dtype).reshape(*xq.shape[:-1], o)


def w8a8_matmul(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wq_t: torch.Tensor,
    ws: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """int8 rows [..., K] with scales ``xs`` [..., 1] @ [K, O] int8 weights
    (``ws`` [O] float32 scales) -> [..., O].

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel:
    bf16 out, K and O multiples of 128, any number of rows."""
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, xs, wq_t, ws, out_dtype)
    if wq_t.dim() != 2:
        raise ValueError(f"wq_t: expected [K, O], got {tuple(wq_t.shape)}")
    k, o = wq_t.shape
    if k % 128 or k == 0 or o % 128 or o == 0:
        raise ValueError(f"w8a8_matmul: unsupported weight shape {(k, o)}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"w8a8_matmul: the kernel writes bf16, not {out_dtype}")
    if xq.dim() < 1 or xq.shape[-1] != k or xq.numel() == 0:
        raise ValueError(f"xq: expected [..., {k}], got {tuple(xq.shape)}")
    lead = xq.shape[:-1]
    m = xq.numel() // k
    _cuda.check_tensor(xq, "xq", torch.int8, (*lead, k))
    _cuda.check_tensor(xs, "xs", torch.float32, (*lead, 1))
    wq, ws = _weight_rows(wq_t, ws, "wq_t", xq.device)
    if xs.device != xq.device:
        raise ValueError("w8a8_matmul: inputs are on different devices")
    out = torch.empty(*lead, o, dtype=torch.bfloat16, device=xq.device)
    fn = _cuda.kernel_function(
        "w8a8_matmul", "w8a8_matmul_bf16", [_cuda.VOIDP] * 5 + [_cuda.INT] * 3 + [_cuda.VOIDP]
    )
    with torch.cuda.device(xq.device):
        code = fn(
            xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
            m, k, o, _cuda.stream_ptr(xq.device),
        )
    _cuda.check_launch("w8a8_matmul", code)
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
