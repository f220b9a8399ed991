"""W8A8 matmuls: int8 weights, activations quantised to int8 per row.

Port of ``dorado_tpu/ops/int8_matmul.py``. Weights are symmetric int8 per
output channel, activations symmetric int8 per row, the products sum in
int32 and are rescaled in float32.

- ``w8a8_matmul_fq`` (Pallas body ``_fq_kernel``): rows quantised inside
  the kernel, the bias added in its epilogue: the LSTM input projections,
  the transformer's qkv projection and its quantised head.
  ``csrc/w8a8_matmul_fq.cu``, launched as ``w8a8_fq_plan`` says; bf16 in
  and out, and its float32 form (``w8a8_matmul_fq_f32``: float32 in and
  out) for ``compute_dtype=float32``.
- ``swiglu_w8a8`` (``_swiglu_kernel``): the transformer's fc1 on quantised
  rows, both SwiGLU halves, ``y * silu(g)`` and the per-row requantisation of
  the result in one kernel. ``csrc/w8a8_matmul.cu``, launched as
  ``swiglu_plan`` says.
- ``w8a8_matmul`` (``_a8_kernel``): quantised rows times int8 weights, the
  transformer's fc2. ``csrc/w8a8_matmul.cu``, launched as ``w8a8_plan``
  says; a bf16 output, and its float32 form (``w8a8_matmul_f32``).
- ``quantize_rows`` is plain PyTorch, as it is plain XLA there.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version beside it. The int32 sums are exact and every float step
is one rounded operation in both, so ``w8a8_matmul_fq`` and ``w8a8_matmul``
agree with their plain versions bit for bit, and ``swiglu_w8a8`` up to the
last bit of ``exp``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dorado_tpu_torch.ops import _cuda

# shared memory a block may use on the H100 (232,448 bytes of the SM's 256 KB)
SMEM_LIMIT = 232_448
ROWS_A_BLOCK = 128  # the rows a CTA (or, for K12, a cluster) takes at a time


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


@dataclass(frozen=True)
class FqPlan:
    """How K2 launches at one weight shape [K, O]: its quantised rows in one
    or two A buffers (two, so that the next block's rows are quantised while
    this block's products run, where they fit: K <= 512), weight slabs of 128
    output channels by 128 bytes of K in a ring of ``stages`` (at least one
    output tile's K / 128), and clusters of two CTAs on neighbouring row
    blocks that share each slab."""

    k: int
    o: int
    a_buffers: int
    stages: int
    cluster = 2  # CTAs a cluster (not a field: every shape takes two)

    @property
    def smem(self) -> int:
        """Dynamic shared memory a CTA, as ``csrc/w8a8_matmul_fq.cu::smem_bytes``:
        the 1024-byte alignment, the A buffers, the ring, the two bf16 output
        tiles, the rows' scales and the mbarriers."""
        return _fq_smem(self.k, self.a_buffers, self.stages)

    def grid(self, m: int, active_clusters: int) -> int:
        """CTAs of a launch over m rows when the card runs ``active_clusters``
        clusters at once: persistent clusters over pairs of row blocks."""
        pairs = _cdiv(_cdiv(m, ROWS_A_BLOCK), self.cluster)
        return self.cluster * min(pairs, active_clusters)


_FQ_SLAB = 128 * 128  # bytes of a weight slab
_FQ_MAX_STAGES = 8


def _fq_smem(k: int, a_buffers: int, stages: int) -> int:
    return 1024 + a_buffers * 128 * k + stages * _FQ_SLAB + 2 * 64 * 128 * 2 + 2 * 128 * 4 + 8 * (
        2 * _FQ_MAX_STAGES + 4
    )


def w8a8_fq_plan(k: int, o: int) -> FqPlan:
    """K2's launch for a [K, O] weight (K a multiple of 128 up to 768, O a
    multiple of 128); raises ValueError on any other shape."""
    if k % 128 or not 0 < k <= 768 or o % 128 or o <= 0:
        raise ValueError(f"w8a8_matmul_fq: unsupported weight shape {(k, o)}")
    tile = k // 128
    a_buffers = 2 if _fq_smem(k, 2, tile) <= SMEM_LIMIT else 1
    stages = tile
    while stages < _FQ_MAX_STAGES and _fq_smem(k, a_buffers, stages + 1) <= SMEM_LIMIT:
        stages += 1
    return FqPlan(k, o, a_buffers, stages)


def w8a8_matmul_fq(
    x: torch.Tensor,
    wq_t: torch.Tensor,
    ws: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[..., K] activations @ [K, O] int8 weights (``ws`` [O] float32 scales,
    ``bias`` [O] float32 added in the epilogue) -> [..., O].

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    as ``w8a8_fq_plan(K, O)`` says: bf16 in and out here, float32 in and out
    through ``w8a8_matmul_fq_f32``; K a multiple of 128 up to 768, O a
    multiple of 128, any number of rows. The kernels read the
    weights one output channel a row, so ``wq_t`` given as the transposed
    view of a contiguous [O, K] tensor (as the models hold it) is used as it
    is; any other layout is copied."""
    if x.device.type == "cpu":
        return w8a8_matmul_fq_plain(x, wq_t, ws, bias, out_dtype)
    if x.dtype == torch.float32:
        return w8a8_matmul_fq_f32(x, wq_t, ws, bias, out_dtype)
    out = _fq_launch(x, wq_t, ws, bias, out_dtype)
    w8a8_matmul_fq.launches += 1
    return out


def w8a8_matmul_fq_f32(
    x: torch.Tensor,
    wq_t: torch.Tensor,
    ws: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K2's float32 form: ``w8a8_matmul_fq`` on float32 rows writing float32
    (the JAX package's ``compute_dtype=float32`` path), on its own launch
    counter. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return w8a8_matmul_fq_plain(x, wq_t, ws, bias, out_dtype)
    out = _fq_launch(x, wq_t, ws, bias, out_dtype)
    w8a8_matmul_fq_f32.launches += 1
    return out


_KERNEL_TYPES = (torch.bfloat16, torch.float32)


def _fq_launch(x, wq_t, ws, bias, out_dtype, out=None) -> torch.Tensor:
    """K2's launch on CUDA tensors: x and the output both bf16 or both
    float32; into ``out`` where given (a check fills it with NaN first)."""
    if wq_t.dim() != 2:
        raise ValueError(f"wq_t: expected [K, O], got {tuple(wq_t.shape)}")
    k, o = wq_t.shape
    plan = w8a8_fq_plan(k, o)
    if x.dtype not in _KERNEL_TYPES or out_dtype != x.dtype:
        raise ValueError(
            f"w8a8_matmul_fq: the kernel writes x's type, bf16 or float32, not {x.dtype} -> "
            f"{out_dtype}"
        )
    if x.dim() < 1 or x.shape[-1] != k or x.numel() == 0:
        raise ValueError(f"x: expected [..., {k}], got {tuple(x.shape)}")
    lead = x.shape[:-1]
    m = x.numel() // k
    _cuda.check_tensor(x, "x", x.dtype, (*lead, k))
    wq, ws = _weight_rows(wq_t, ws, "wq_t", x.device)
    if bias is None:
        bias = torch.zeros(o, dtype=torch.float32, device=x.device)
    _cuda.check_tensor(bias, "bias", torch.float32, (o,))
    if bias.device != x.device:
        raise ValueError("w8a8_matmul_fq: inputs are on different devices")
    if out is None:
        out = torch.empty(*lead, o, dtype=out_dtype, device=x.device)
    _cuda.check_tensor(out, "out", out_dtype, (*lead, o))
    _cuda.launch(
        "w8a8_matmul_fq", "w8a8_matmul_fq", [_cuda.VOIDP] * 5 + [_cuda.INT] * 6, x.device,
        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), out.data_ptr(),
        m, k, o, plan.a_buffers, plan.stages, x.element_size(),
    )
    return out


w8a8_matmul_fq_f32.launches = 0
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


@dataclass(frozen=True)
class SwigluPlan:
    """How K12 launches at one weight shape [K, F].

    One pass (``one_pass``): a cluster of ``cluster`` CTAs shares a 128-row
    block, CTA r owning features [r * features, (r + 1) * features), at most
    256 (four tiles of 64: their float32 t, 128 KB, stays in shared memory
    until the cluster has the rows' maxima). The two-pass form (one CTA a
    block, all F, t computed twice) where F / 64 has no divisor C <= 8 with
    F / C <= 256. Weight slabs of 8 KB in a ring of ``stages``."""

    k: int
    f: int
    one_pass: bool
    cluster: int
    stages: int

    @property
    def features(self) -> int:
        """The features a CTA owns: F / cluster (all F in the two-pass form)."""
        return self.f // self.cluster

    @property
    def smem(self) -> int:
        """Dynamic shared memory a CTA, as ``csrc/w8a8_matmul.cu::smem_bytes``."""
        return _swiglu_smem(self.k, self.one_pass, self.features, self.stages)

    def grid(self, m: int, active_clusters: int) -> int:
        """CTAs of a launch over m rows when the card runs ``active_clusters``
        such clusters at once: persistent clusters over the row blocks."""
        return self.cluster * min(_cdiv(m, ROWS_A_BLOCK), active_clusters)


_SWIGLU_SLAB = 2 * 64 * 64  # 64 features of each half by 64 bytes of K
_SWIGLU_MAX_STAGES = 8
_SWIGLU_MAX_CLUSTER = 8
_SWIGLU_MAX_TILES = 4  # 64-feature tiles a CTA holds t for


def _swiglu_smem(k: int, one_pass: bool, features: int, stages: int) -> int:
    t = 128 * features * 4 if one_pass else 0
    return 1024 + 128 * k + t + stages * _SWIGLU_SLAB + 3 * 128 * 4 + 8 * (
        2 * _SWIGLU_MAX_STAGES + 5 + _SWIGLU_MAX_TILES
    )


def swiglu_plan(k: int, f: int, two_pass: bool = False) -> SwigluPlan:
    """K12's launch for [K, F] halves of fc1 (K a multiple of 128 up to 512,
    F a multiple of 64); raises ValueError on any other shape. One pass with
    the largest cluster C <= 8 that divides F / 64 into at most four tiles a
    CTA (deeper rings), else the two-pass form; ``two_pass`` asks for that
    form at any shape (to time the two against each other)."""
    if k % 128 or not 0 < k <= 512 or f % 64 or f <= 0:
        raise ValueError(f"swiglu_w8a8: unsupported weight shape {(k, f)}")
    tiles = f // 64
    fits = [c for c in range(1, _SWIGLU_MAX_CLUSTER + 1)
            if tiles % c == 0 and tiles // c <= _SWIGLU_MAX_TILES]
    one_pass = bool(fits) and not two_pass
    cluster = max(fits) if one_pass else 1
    features = f // cluster
    stages = 2
    while stages < _SWIGLU_MAX_STAGES and _swiglu_smem(k, one_pass, features, stages + 1) <= SMEM_LIMIT:
        stages += 1
    return SwigluPlan(k, f, one_pass, cluster, stages)


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

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    as ``swiglu_plan(K, F)`` says: K a multiple of 128 up to 512, F a
    multiple of 64, any number of rows."""
    if xq.device.type == "cpu":
        return swiglu_w8a8_plain(xq, xs, wy_t, wys, wg_t, wgs)
    return _swiglu_cuda(xq, xs, wy_t, wys, wg_t, wgs)


def _swiglu_cuda(xq, xs, wy_t, wys, wg_t, wgs, two_pass: bool = False):
    """K12's launch on a CUDA tensor; ``two_pass`` asks for the two-pass form
    at any shape (to time the two forms against each other)."""
    if wy_t.dim() != 2 or wy_t.shape != wg_t.shape:
        raise ValueError(
            f"wy_t, wg_t: expected two [K, F], got {tuple(wy_t.shape)}, {tuple(wg_t.shape)}"
        )
    k, f = wy_t.shape
    plan = swiglu_plan(k, f, two_pass)
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
    _cuda.launch(
        "w8a8_matmul", "swiglu_w8a8_i8", [_cuda.VOIDP] * 8 + [_cuda.INT] * 6, xq.device,
        xq.data_ptr(), xs.data_ptr(), wy.data_ptr(), wys.data_ptr(), wg.data_ptr(),
        wgs.data_ptr(), tq.data_ptr(), ts.data_ptr(), m, k, f, int(plan.one_pass),
        plan.cluster, plan.stages,
    )
    swiglu_w8a8.launches += 1
    return tq, ts


swiglu_w8a8.launches = 0


def rcp_near_mismatches(device: torch.device) -> int:
    """How many floats x in [1, 2^126) K12's branch-free reciprocal gets
    wrong against the correctly rounded ``__frcp_rn``, counted on the card
    (K12 takes it for 1 + exp(-g) in that range and ``__frcp_rn`` outside)."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    _cuda.launch("w8a8_matmul", "rcp_near_mismatches", [_cuda.VOIDP], device, bad.data_ptr())
    return int(bad.item())


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


@dataclass(frozen=True)
class W8a8Plan:
    """How K13 launches at one weight shape [K, O]: 128 x 128 output tiles, a
    CTA each, in persistent clusters of ``cluster`` CTAs on neighbouring
    column tiles of one row block, which share each x slab by multicast; K
    streams through a ring of ``stages`` 32 KB stages."""

    k: int
    o: int
    cluster: int
    stages: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory a CTA, as ``csrc/w8a8_matmul.cu::k13::smem_bytes``:
        the 1024-byte alignment, the ring, the two bf16 output tiles and the
        mbarriers."""
        return _w8a8_smem(self.stages)

    def grid(self, m: int, active_clusters: int) -> int:
        """CTAs of a launch over m rows when the card runs ``active_clusters``
        clusters at once: persistent clusters over the work units (a row
        block by the cluster's column tiles)."""
        units = _cdiv(m, ROWS_A_BLOCK) * (self.o // 128 // self.cluster)
        return self.cluster * min(units, active_clusters)


_W8A8_STAGE = 2 * 128 * 128  # 128 rows of x and 128 channels of w by 128 bytes of K
_W8A8_MAX_STAGES = 8


def _w8a8_smem(stages: int) -> int:
    return 1024 + stages * _W8A8_STAGE + 2 * 64 * 128 * 2 + 8 * 2 * _W8A8_MAX_STAGES


def w8a8_plan(k: int, o: int) -> W8a8Plan:
    """K13's launch for a [K, O] weight (K and O multiples of 128); raises
    ValueError on any other shape. The cluster is the largest of 4, 2 and 1
    that divides O / 128; the ring the deepest that fits."""
    if k % 128 or k <= 0 or o % 128 or o <= 0:
        raise ValueError(f"w8a8_matmul: unsupported weight shape {(k, o)}")
    cluster = next(c for c in (4, 2, 1) if (o // 128) % c == 0)
    stages = 2
    while stages < _W8A8_MAX_STAGES and _w8a8_smem(stages + 1) <= SMEM_LIMIT:
        stages += 1
    return W8a8Plan(k, o, cluster, stages)


def w8a8_matmul(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wq_t: torch.Tensor,
    ws: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """int8 rows [..., K] with scales ``xs`` [..., 1] @ [K, O] int8 weights
    (``ws`` [O] float32 scales) -> [..., O].

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    as ``w8a8_plan(K, O)`` says: a bf16 output here, a float32 one through
    ``w8a8_matmul_f32``; K and O multiples of 128, any number of rows."""
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, xs, wq_t, ws, out_dtype)
    if out_dtype == torch.float32:
        return w8a8_matmul_f32(xq, xs, wq_t, ws, out_dtype)
    out = _w8a8_launch(xq, xs, wq_t, ws, out_dtype)
    w8a8_matmul.launches += 1
    return out


def w8a8_matmul_f32(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wq_t: torch.Tensor,
    ws: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K13's float32 form: ``w8a8_matmul`` writing float32 (the JAX
    package's ``compute_dtype=float32`` path), on its own launch counter.
    A CPU tensor takes the plain version."""
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, xs, wq_t, ws, out_dtype)
    if out_dtype != torch.float32:
        raise ValueError(f"w8a8_matmul_f32: writes float32, not {out_dtype}")
    out = _w8a8_launch(xq, xs, wq_t, ws, out_dtype)
    w8a8_matmul_f32.launches += 1
    return out


def _w8a8_launch(xq, xs, wq_t, ws, out_dtype, out=None) -> torch.Tensor:
    """K13's launch on CUDA tensors: the output bf16 or float32; into ``out``
    where given."""
    if wq_t.dim() != 2:
        raise ValueError(f"wq_t: expected [K, O], got {tuple(wq_t.shape)}")
    k, o = wq_t.shape
    plan = w8a8_plan(k, o)
    if out_dtype not in _KERNEL_TYPES:
        raise ValueError(f"w8a8_matmul: the kernel writes bf16 or float32, not {out_dtype}")
    if xq.dim() < 1 or xq.shape[-1] != k or xq.numel() == 0:
        raise ValueError(f"xq: expected [..., {k}], got {tuple(xq.shape)}")
    lead = xq.shape[:-1]
    m = xq.numel() // k
    _cuda.check_tensor(xq, "xq", torch.int8, (*lead, k))
    _cuda.check_tensor(xs, "xs", torch.float32, (*lead, 1))
    wq, ws = _weight_rows(wq_t, ws, "wq_t", xq.device)
    if xs.device != xq.device:
        raise ValueError("w8a8_matmul: inputs are on different devices")
    if out is None:
        out = torch.empty(*lead, o, dtype=out_dtype, device=xq.device)
    _cuda.check_tensor(out, "out", out_dtype, (*lead, o))
    _cuda.launch(
        "w8a8_matmul", "w8a8_matmul", [_cuda.VOIDP] * 5 + [_cuda.INT] * 6, xq.device,
        xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
        m, k, o, plan.cluster, plan.stages, out.element_size(),
    )
    return out


w8a8_matmul_f32.launches = 0
w8a8_matmul.launches = 0
