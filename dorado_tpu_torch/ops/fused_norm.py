"""The sup encoder's matmul + bias + scaled residual + RMSNorm in one pass.

Port of ``dorado_tpu/ops/fused_norm.py::matmul_residual_rmsnorm`` (K14, Pallas
body ``_kernel``). Every encoder sub-block ends with
``rms_norm(matmul_out [+ bias] + alpha * residual)``; the kernel keeps the
product's rows on chip through the norm, so neither the product nor the
residual sum goes to device memory.

The numerics are the JAX kernel's, step by step: the product sums in float32
and the bias is added to that sum; the result is rounded to the stream dtype
before the residual; ``residual * alpha`` is computed and rounded in the
stream dtype and added in it; the norm statistics are float32; the
normalised row is rounded, then multiplied by the weight in the stream dtype.

On a CUDA tensor the wrapper launches ``csrc/fused_norm.cu`` (bf16, 512
output channels: sup's d_model), or its float32 form on float32 tensors
(``matmul_residual_rmsnorm_f32``, the JAX package's float32 stream: float32
products in 3xTF32, every rounding a float32 one); on a CPU tensor it runs
the plain version.
"""

from __future__ import annotations

import torch

from dorado_tpu_torch.ops import _cuda


def matmul_residual_rmsnorm_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None,
    residual: torch.Tensor,
    norm_w: torch.Tensor,
    alpha: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order of
    roundings; the product in float32."""
    dtype = residual.dtype
    acc = torch.matmul(x.float(), w.float().t())
    if bias is not None:
        acc = acc + bias.float()
    a = torch.tensor(alpha, dtype=dtype).item()
    h = (acc.to(dtype) + residual * a).float()
    rstd = torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * rstd).to(dtype) * norm_w.to(dtype)


def matmul_residual_rmsnorm(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None,
    residual: torch.Tensor,
    norm_w: torch.Tensor,
    alpha: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``rms_norm((x @ w.T + bias).to(dtype) + alpha * residual) * norm_w``
    for x [..., K], w [O, K], bias [O] or None, residual [..., O], norm_w
    [O] -> [..., O] in the residual's dtype; ``alpha`` is rounded to that
    dtype first, as the JAX kernel takes it.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel:
    bf16 x, w, residual and norm weight here, float32 ones through
    ``matmul_residual_rmsnorm_f32``; O = 512, K a multiple of 32, any number
    of rows; the bias in any float dtype (it is taken as float32)."""
    if x.device.type == "cpu":
        return matmul_residual_rmsnorm_plain(x, w, bias, residual, norm_w, alpha, eps)
    if residual.dtype == torch.float32:
        return matmul_residual_rmsnorm_f32(x, w, bias, residual, norm_w, alpha, eps)
    out = _launch(x, w, bias, residual, norm_w, alpha, eps)
    matmul_residual_rmsnorm.launches += 1
    return out


def matmul_residual_rmsnorm_f32(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None,
    residual: torch.Tensor,
    norm_w: torch.Tensor,
    alpha: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K14 at float32: ``matmul_residual_rmsnorm`` on float32 tensors, on
    its own launch counter. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return matmul_residual_rmsnorm_plain(x, w, bias, residual, norm_w, alpha, eps)
    out = _launch(x, w, bias, residual, norm_w, alpha, eps)
    matmul_residual_rmsnorm_f32.launches += 1
    return out


def _launch(x, w, bias, residual, norm_w, alpha, eps, out=None) -> torch.Tensor:
    """K14's launch on CUDA tensors, bf16 or float32 (the residual's dtype);
    into ``out`` where given (a check fills it with NaN first)."""
    what = "matmul_residual_rmsnorm"
    dtype = residual.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: the kernel takes bf16 or float32, not {dtype}")
    if w.dim() != 2:
        raise ValueError(f"{what}: w: expected [O, K], got {tuple(w.shape)}")
    o, k = w.shape
    if o != 512 or k % 32 or k == 0:
        raise ValueError(f"{what}: the kernel takes O = 512 and K a multiple of 32, not {(o, k)}")
    if x.dim() < 1 or x.shape[-1] != k or x.numel() == 0:
        raise ValueError(f"{what}: x: expected [..., {k}], got {tuple(x.shape)}")
    lead = x.shape[:-1]
    m = x.numel() // k
    _cuda.check_tensor(x, "x", dtype, (*lead, k))
    _cuda.check_tensor(w, "w", dtype, (o, k))
    _cuda.check_tensor(residual, "residual", dtype, (*lead, o))
    _cuda.check_tensor(norm_w, "norm_w", dtype, (o,))
    others = [w, residual, norm_w]
    if bias is not None:
        bias = bias.float()
        _cuda.check_tensor(bias, "bias", torch.float32, (o,))
        others.append(bias)
    if not all(t.device == x.device for t in others):
        raise ValueError(f"{what}: inputs are on different devices")
    if out is None:
        out = torch.empty(*lead, o, dtype=dtype, device=x.device)
    _cuda.check_tensor(out, "out", dtype, (*lead, o))
    f32 = dtype == torch.float32
    _cuda.launch(
        "fused_norm", "matmul_residual_rmsnorm_f32" if f32 else "matmul_residual_rmsnorm_bf16",
        [_cuda.VOIDP] * 6 + [_cuda.INT] * 3 + [_cuda.FLOAT] * 2, x.device,
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        residual.data_ptr(), norm_w.data_ptr(), out.data_ptr(), m, k, o,
        torch.tensor(alpha, dtype=dtype).item(), eps,
    )
    return out


matmul_residual_rmsnorm.launches = 0
matmul_residual_rmsnorm_f32.launches = 0
