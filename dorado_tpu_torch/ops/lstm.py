"""LSTM recurrence over pre-projected gates (the serial part of a layer).

Port of ``dorado_tpu/ops/lstm.py::lstm_scan_time_major``. The input
projection ``x @ W_ih^T + b`` is not here: the caller runs it as one large
time-parallel matmul. Each step computes ``gates = xproj[t] + h @ W_hh^T``
(gate order i, f, g, o), keeps ``c`` in float32 and ``h`` in the input dtype;
``reverse=True`` walks time backwards without flipping any data.

Two variants of it, each a kernel of ``csrc/lstm_scan.cu`` too, are on no
pipeline path (the JAX package calls neither from its model):

  - ``lstm_scan_time_major_int8`` (``lstm_scan_time_major_int8`` there): the
    recurrent product in int8, ``h`` quantised as ``round(h * 127)``, with
    ``quantize_lstm_weights`` making the int8 weights and their scale;
  - ``lstm_fused_time_major`` (``lstm_fused_time_major`` there): the whole
    layer, the input projection ``x[t] @ W_ih^T + bias`` inside the
    recurrence.

On a CUDA tensor each wrapper launches its kernel (bf16; K1 also float32,
as the modified-base models run it, through ``lstm_scan_time_major_f32``);
on a CPU tensor it runs its plain version below. K1 keeps W_hh in the
shared memory of a thread-block cluster, each CTA a slice of the gate
columns (``slice_w_hh``), and exchanges h between the CTAs every step;
``k1_cluster_shape`` and ``k1_plan`` choose the cluster, the units a CTA
and the batch rows a cluster. K16 runs on K1's kernel and plan (``fused=True``) with x[t] in
place of xproj[t]: each CTA computes its gate rows' input product of the
next step while the h slices of this one are exchanged, reading its slice
of W_ih from L2 every step in the order of the mma fragments
(``w_ih_fragments``). K15 runs on K1's kernel with int8 elements
(``elem_bytes=1``): its W_i8 slices resident, int8 products on the tensor
cores, h exchanged as int8. K1 float32 runs on K1's kernel with float
elements (``elem_bytes=4``): its products in 3xTF32, h exchanged in float32.

Where no cluster of 16 CTAs holds W_hh (bf16 above H = 512, float32 above
384: the LSTM-sup class's H = 768), ``lstm_scan_time_major`` and
``lstm_scan_time_major_f32`` launch the wide form of K1's kernel through
``lstm_scan_time_major_wide`` and ``lstm_scan_time_major_wide_f32``, each on
its own launch counter: clusters of 16, each CTA's W_hh slice split into
pairs of k-tiles held in registers, resident in shared memory and streamed
from L2 every step (``k1_wide_plan``, ``wide_w_hh``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


# K1's limits: dynamic shared memory a block can have on Hopper, warps a
# CTA, m-tiles (16 gate columns) a warp, batch rows a cluster
_K1_SMEM_MAX = 232448
_K1_MAX_WARPS = 12
_K1_MAX_TILES_A_WARP = 2
_K1_MAX_ROWS = 48

class ClusterPlan(NamedTuple):
    """How K1's kernel splits a launch: ``cluster`` CTAs a cluster, each
    owning ``units`` hidden units (all four gate columns) with ``warps``
    warps; ``rows`` batch rows a cluster, ``clusters`` clusters."""

    cluster: int
    units: int
    warps: int
    rows: int
    clusters: int


def _k1_smem(
    units: int, cluster: int, rows: int, fused: bool = False, elem_bytes: int = 2
) -> int:
    """Shared memory of one CTA of K1's kernel in bytes (``smem_bytes`` in
    the source): its W slice, two h buffers and two h stagings, with K16
    (``fused``) two x buffers, in elements of ``elem_bytes`` (2: bf16, K1 and
    K16; 1: int8, K15; 4: K1 float32), and two 8-byte mbarriers."""
    kp = _k1_depth(cluster, units, elem_bytes)
    pad = 16 // elem_bytes  # a W or x row's 16 bytes of padding
    blocks = -(-kp // units)  # h held as blocks of one CTA's units
    x_bufs = 2 * rows * (kp + pad) if fused else 0
    h_rows = 2 * (blocks + 1) * rows * _k1_h_stride(units, elem_bytes)
    return elem_bytes * (4 * units * (kp + pad) + h_rows + x_bufs) + 16


def _k1_depth(cluster: int, units: int, elem_bytes: int = 2) -> int:
    """The products' depth: the cluster's units rounded up to a pair of
    k-tiles, 64 bytes (32 bf16, 64 int8, 16 float32)."""
    pair = 64 // elem_bytes
    return -(-cluster * units // pair) * pair


def _k1_h_stride(units: int, elem_bytes: int = 2) -> int:
    """The row stride of h's blocks in elements: the units and 16 bytes, or
    the units alone where their 16-byte chunks are odd in number (ldmatrix's
    rows in distinct banks)."""
    return (units * elem_bytes // 16 | 1) * 16 // elem_bytes


def k1_cluster_shape(
    hidden: int, fused: bool = False, elem_bytes: int = 2
) -> tuple[int, int, int]:
    """(cluster, units, warps) for hidden width H (K16's launch: ``fused``;
    K1 float32's: ``elem_bytes=4``): the smallest cluster (1 to 16 CTAs)
    whose CTAs' W slices fit shared memory at 8 rows and whose m-tiles (four
    units each) split over at most 12 warps, one or two a warp; each CTA's
    unit count rounded up to whole k-tiles of h (32 bytes: 16 bf16, 8
    float32), and the most warps that split them. K15 (``elem_bytes=1``)
    takes bf16's shape: its int8 slices would fit in half the cluster at
    some widths (clusters of 4 at hac's H), but on the card the two were
    within 4% of each other, either way by the batch (PERF.md, K15's row), and
    one rule serves K1, K15 and K16."""
    es = 4 if elem_bytes == 4 else 2
    for cluster in (1, 2, 4, 8, 16):
        units = -(-hidden // cluster)
        units += -units % (32 // es)
        tiles = units // 4
        warps = [
            w for w in range(1, _K1_MAX_WARPS + 1)
            if tiles % w == 0 and tiles // w <= _K1_MAX_TILES_A_WARP
        ]
        if warps and _k1_smem(units, cluster, 8, fused, es) <= _K1_SMEM_MAX:
            break
    else:
        raise ValueError(f"lstm_scan: no cluster of up to 16 CTAs holds W_hh at H = {hidden}"
                         + (" in float32" if es == 4 else ""))
    return cluster, units, max(warps)


def k1_plan(
    hidden: int, n: int, active_clusters: int, fused: bool = False, elem_bytes: int = 2
) -> ClusterPlan:
    """The split of a batch of ``n`` rows, given how many clusters of the
    shape the card runs at once: rows a cluster spread the batch over those
    clusters (a multiple of 8, the mma's n-tile), at most 48 and what shared
    memory holds (in elements of ``elem_bytes``: 1 for K15's int8, 4 for K1
    float32); a batch beyond that takes more clusters than run at once."""
    cluster, units, warps = k1_cluster_shape(hidden, fused, elem_bytes)
    fit = [
        r for r in range(8, _K1_MAX_ROWS + 1, 8)
        if _k1_smem(units, cluster, r, fused, elem_bytes) <= _K1_SMEM_MAX
    ]
    per_cluster = -(-n // max(active_clusters, 1))
    rows = min(max(8, per_cluster + -per_cluster % 8), fit[-1])
    return ClusterPlan(cluster, units, warps, rows, -(-n // rows))


def slice_w_hh(w_hh_t: torch.Tensor, cluster: int, units: int) -> torch.Tensor:
    """[H, 4H] recurrent weights -> [cluster, 4 * units, Kp] (Kp = cluster *
    units rounded up to 64 bytes of the weights' type: 32 bf16, 64 int8, 16
    float32): CTA c's row 4 j + gate holds the weights of gate column gate *
    H + c * units + j over k, zero where the unit or k is past H. K1 (K15:
    int8 weights; K1 float32: float32) copies slice c into CTA c's shared
    memory."""
    hidden = w_hh_t.shape[0]
    hp, kp = cluster * units, _k1_depth(cluster, units, w_hh_t.element_size())
    w = w_hh_t.new_zeros(kp, 4, hp)  # [k, gate, unit]
    w[:hidden, :, :hidden] = w_hh_t.reshape(hidden, 4, hidden)
    return w.reshape(kp, 4, cluster, units).permute(2, 3, 1, 0).reshape(cluster, 4 * units, kp)


def w_ih_fragments(w_ih_t: torch.Tensor, cluster: int, units: int) -> torch.Tensor:
    """[H, 4H] input weights -> [cluster, units // 4, Kp // 16, 32, 8]: W_ih
    sliced over the cluster as ``slice_w_hh`` slices W_hh (K16's input is H
    wide too), then cut into the mma A fragments K16 reads from L2: those of
    CTA c's m-tile mt (16 rows) and k-tile kt (16 k) that lane l holds, rows
    l // 4 and l // 4 + 8 at k 2 (l % 4) + (0, 1) and + 8. A lane reads its
    16 bytes, a warp 512 contiguous bytes."""
    return _fragments(slice_w_hh(w_ih_t, cluster, units))


# K1's register pairs (``reg_pairs`` in the source): pairs of k-tiles of W a
# warp holds in registers, by m-tiles a warp and n-tiles (K1 float32 counts
# two more n-tiles)
def _k1_reg_pairs(mtw: int, nt: int) -> int:
    if mtw == 1:
        return {1: 12, 2: 8, 3: 4, 4: 2}.get(nt, 0)
    return {1: 4, 2: 2}.get(nt, 0)


class WidePlan(NamedTuple):
    """How K1's wide form splits a launch: ``ClusterPlan``'s fields, and each
    CTA's pairs of k-tiles of W (64 bytes of depth each): [0, ``reg``) held
    in registers, [``reg``, ``resident``) in shared memory, [``resident``,
    ``pairs``) streamed from L2 every step."""

    cluster: int
    units: int
    warps: int
    rows: int
    clusters: int
    reg: int
    resident: int
    pairs: int


_K1_WIDE_CLUSTER = 16


def k1_needs_wide(hidden: int, elem_bytes: int = 2) -> bool:
    """True where no cluster of up to 16 CTAs holds W_hh at width H in
    elements of ``elem_bytes`` (2: bf16, 4: float32): K1's wide form."""
    try:
        k1_cluster_shape(hidden, elem_bytes=elem_bytes)
    except ValueError:
        return True
    return False


def _k1_wide_smem(units: int, cluster: int, rows: int, resident: int, elem_bytes: int) -> int:
    """Shared memory of one CTA of the wide form in bytes
    (``smem_bytes_wide`` in the source): ``resident`` pairs of k-tiles of its
    4U rows (and 16 bytes a row), and K1's h buffers, stagings and
    mbarriers."""
    pad = 16 // elem_bytes
    blocks = -(-_k1_depth(cluster, units, elem_bytes) // units)
    h_rows = 2 * (blocks + 1) * rows * _k1_h_stride(units, elem_bytes)
    return elem_bytes * (4 * units * (resident * 64 // elem_bytes + pad) + h_rows) + 16


def k1_wide_plan(hidden: int, n: int, active_clusters: int, elem_bytes: int = 2) -> WidePlan:
    """The wide form's split for width H and ``n`` rows: clusters of 16
    CTAs, each CTA's units rounded up to whole k-tiles of h (16 bf16, 8
    float32), the most warps that split their m-tiles one or two a warp;
    rows a cluster by ``k1_plan``'s rule (a multiple of 8 that spreads the
    batch over the clusters the card runs at once, at most 48 and what h's
    buffers leave room for); the register pairs of the instantiation (K1's,
    less the ring of streamed pairs: ``wide_reg_pairs`` in the source); as
    many pairs resident as shared memory holds after h's buffers; the rest
    streamed."""
    cluster = _K1_WIDE_CLUSTER
    units = -(-hidden // cluster)
    units += -units % (32 // elem_bytes)
    tiles = units // 4
    warps = [w for w in range(1, _K1_MAX_WARPS + 1)
             if tiles % w == 0 and tiles // w <= _K1_MAX_TILES_A_WARP]
    fit = [r for r in range(8, _K1_MAX_ROWS + 1, 8)
           if _k1_wide_smem(units, cluster, r, 0, elem_bytes) <= _K1_SMEM_MAX]
    if not warps or not fit:
        raise ValueError(f"lstm_scan: the wide form takes no H = {hidden}")
    per_cluster = -(-n // max(active_clusters, 1))
    rows = min(max(8, per_cluster + -per_cluster % 8), fit[-1])
    pairs = _k1_depth(cluster, units, elem_bytes) * elem_bytes // 64
    mtw, nt = tiles // max(warps), rows // 8
    rp = _k1_reg_pairs(mtw, nt + 2 if elem_bytes == 4 else nt)
    reg = min(rp - (2 if mtw == 1 and rp >= 2 else 0), pairs)
    room = _K1_SMEM_MAX - _k1_wide_smem(units, cluster, rows, 0, elem_bytes)
    resident = reg + min(room // (4 * units * 64), pairs - reg)
    return WidePlan(cluster, units, max(warps), rows, -(-n // rows), reg, resident, pairs)


def _fragments(sl: torch.Tensor) -> torch.Tensor:
    """[C, 4U, Kp] slices (any element type) -> [C, U / 4, Kp / KT, 32, 16
    bytes' elements]: the mma A fragments of each m-tile (16 rows) and k-tile
    (32 bytes, KT elements) that lane l holds, as ldmatrix_x4 gives them
    from a row-major tile: in 32-bit words, rows l // 4 and l // 4 + 8 at
    word l % 4, then the same rows at word 4 + l % 4. A lane reads its 16
    bytes, a warp 512 contiguous bytes."""
    c, rows, kp = sl.shape
    words = sl.contiguous().view(torch.int32)  # [C, 4U, Kp * es / 4]
    kw = words.shape[2]
    tiles = words.reshape(c, rows // 16, 16, kw // 8, 8).permute(0, 1, 3, 2, 4)
    lane = torch.arange(32, device=sl.device)  # made there: no copy from the host
    r, w = lane // 4, lane % 4
    frag = torch.stack([tiles[..., r, w], tiles[..., r + 8, w],
                        tiles[..., r, w + 4], tiles[..., r + 8, w + 4]], -1)
    return frag.contiguous().view(sl.dtype)


def wide_w_hh(w_hh_t: torch.Tensor, plan: WidePlan) -> tuple[torch.Tensor, torch.Tensor]:
    """[H, 4H] recurrent weights -> (resident [C, 4U, (resident - reg) * 64
    bytes' elements], fragments [C, U / 4, k-tiles, 32, 16 bytes' elements]):
    ``slice_w_hh``'s slices at the plan's cluster, cut at pairs of k-tiles
    (64 bytes of depth): the columns of the resident pairs [reg, resident),
    which the kernel copies into shared memory, and the mma A fragments
    (``_fragments``) of the k-tiles of the other pairs, [0, reg) then
    [resident, pairs), in order, which it reads from L2."""
    sl = slice_w_hh(w_hh_t, plan.cluster, plan.units)
    pair = 64 // w_hh_t.element_size()
    res = sl[:, :, plan.reg * pair:plan.resident * pair].contiguous()
    frag = _fragments(sl)
    return res, torch.cat([frag[:, :, :2 * plan.reg], frag[:, :, 2 * plan.resident:]], dim=2)


_active: dict[tuple, int] = {}


def _active_clusters(
    device: torch.device, hidden: int, fused: bool = False, elem_bytes: int = 2
) -> int:
    """Clusters of K1's (K16's, K15's, K1 float32's) shape at 8 rows the
    card runs at once (``cudaOccupancyMaxActiveClusters``), once per device
    and width."""
    key = (device, hidden, fused, elem_bytes)
    if key not in _active:
        # the source's KIND_K15, KIND_K1F, KIND_K16, KIND_K1; the wide forms'
        # KIND_K1W, KIND_K1FW, at their resident pairs at 8 rows
        wide = not fused and elem_bytes != 1 and k1_needs_wide(hidden, elem_bytes)
        if wide:
            p = k1_wide_plan(hidden, 8, 1, elem_bytes)
            cluster, units, warps, ks = p.cluster, p.units, p.warps, p.resident
            kind = 5 if elem_bytes == 4 else 4
        else:
            cluster, units, warps = k1_cluster_shape(hidden, fused, elem_bytes)
            ks = 0
            kind = {1: 2, 4: 3}.get(elem_bytes, int(fused))
        count = ctypes.c_int(0)
        _cuda.launch(
            "lstm_scan", "lstm_scan_active_clusters", [_cuda.INT] * 7 + [_cuda.VOIDP], device,
            hidden, kind, cluster, units, 8, warps, ks, ctypes.addressof(count), stream=False,
        )
        if count.value < 1:
            raise RuntimeError(f"lstm_scan: the card runs no cluster of {cluster} CTAs at H = {hidden}")
        _active[key] = count.value
    return _active[key]


def k1_launch_plan(
    hidden: int, n: int, device: torch.device, fused: bool = False, elem_bytes: int = 2
) -> ClusterPlan:
    """The split K1 (K16: ``fused``; K15: ``elem_bytes=1``; K1 float32:
    ``elem_bytes=4``) launches with on ``device`` for width H and N rows."""
    return k1_plan(
        hidden, n, _active_clusters(device, hidden, fused, elem_bytes), fused, elem_bytes
    )


def k1_wide_launch_plan(
    hidden: int, n: int, device: torch.device, elem_bytes: int = 2
) -> WidePlan:
    """The split K1's wide form (bf16, or float32: ``elem_bytes=4``)
    launches with on ``device`` for width H and N rows."""
    return k1_wide_plan(hidden, n, _active_clusters(device, hidden, False, elem_bytes), elem_bytes)


# K1's element types on CUDA, by C entry: the activations' and W's dtypes,
# W's element size (``elem_bytes``), the widest H and what H is a multiple of
_K1_KINDS = {
    "lstm_scan_bf16": (torch.bfloat16, torch.bfloat16, 2, 512, 4),  # K1
    "lstm_scan_f32": (torch.float32, torch.float32, 4, 384, 4),  # K1 float32
    "lstm_scan_int8": (torch.bfloat16, torch.int8, 1, 512, 16),  # K15
    # K1's wide form, where no cluster holds W_hh (see k1_needs_wide)
    "lstm_scan_wide_bf16": (torch.bfloat16, torch.bfloat16, 2, 1024, 4),
    "lstm_scan_wide_f32": (torch.float32, torch.float32, 4, 1024, 4),
}


def _scan(
    symbol: str, xproj: torch.Tensor, w_t: torch.Tensor, reverse: bool,
    scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1, K1 float32, K15 or K1's wide forms (``symbol``, a key of
    ``_K1_KINDS``) on CUDA tensors: [T, N, 4H] gates + [H, 4H] W (K15: int8,
    with its scale) -> [T, N, H], split by ``k1_launch_plan`` (the wide
    forms: ``k1_wide_launch_plan``)."""
    _, w_dtype, elem_bytes, max_h, multiple = _K1_KINDS[symbol]
    t_len, n, g4 = xproj.shape
    hidden = g4 // 4
    if g4 != 4 * hidden or hidden % multiple or not 0 < hidden <= max_h or t_len == 0 or n == 0:
        raise ValueError(f"{symbol}: unsupported gate shape {tuple(xproj.shape)}")
    _cuda.check_tensor(w_t, "w_hh_t", w_dtype, (hidden, g4))
    out = torch.empty(t_len, n, hidden, dtype=xproj.dtype, device=xproj.device)
    if symbol.startswith("lstm_scan_wide"):
        if not k1_needs_wide(hidden, elem_bytes):
            raise ValueError(f"{symbol}: a cluster holds W_hh at H = {hidden} (K1's resident "
                             f"form takes it)")
        wide = k1_wide_launch_plan(hidden, n, xproj.device, elem_bytes)
        _launch_wide(symbol, xproj, *wide_w_hh(w_t, wide), out, reverse, wide)
        return out
    plan = k1_launch_plan(hidden, n, xproj.device, elem_bytes=elem_bytes)
    _launch(symbol, xproj, slice_w_hh(w_t, plan.cluster, plan.units), out, reverse, plan, scale)
    return out


def _launch_wide(
    symbol: str,
    xproj: torch.Tensor,
    w_res: torch.Tensor,
    w_frag: torch.Tensor,
    out: torch.Tensor,
    reverse: bool,
    plan: WidePlan,
) -> None:
    """K1's wide form (``symbol``: ``lstm_scan_wide_bf16`` or
    ``lstm_scan_wide_f32``) on CUDA tensors: ``wide_w_hh(w, plan)``'s
    resident columns and fragments into ``out`` [T, N, H], split by
    ``plan``; one launch on the wrapper's counter."""
    dtype = torch.float32 if symbol == "lstm_scan_wide_f32" else torch.bfloat16
    es = 4 if dtype == torch.float32 else 2
    t_len, n, g4 = xproj.shape
    hidden = g4 // 4
    pair = 64 // es
    _cuda.check_tensor(xproj, "xproj", dtype, (t_len, n, g4))
    _cuda.check_tensor(w_res, "w_res", dtype,
                       (plan.cluster, 4 * plan.units, (plan.resident - plan.reg) * pair))
    _cuda.check_tensor(w_frag, "w_frag", dtype, (
        plan.cluster, plan.units // 4, 2 * (plan.pairs - plan.resident + plan.reg), 32, 16 // es))
    _cuda.check_tensor(out, "out", dtype, (t_len, n, hidden))
    if any(t.device != xproj.device for t in (w_res, w_frag, out)):
        raise ValueError(f"{symbol}: inputs are on different devices")
    _cuda.launch(
        "lstm_scan", symbol, [_cuda.VOIDP] * 4 + [_cuda.INT] * 9, xproj.device,
        xproj.data_ptr(), w_res.data_ptr(), w_frag.data_ptr(), out.data_ptr(), t_len, n,
        hidden, int(reverse), plan.cluster, plan.units, plan.rows, plan.warps, plan.resident,
    )
    counter = (lstm_scan_time_major_wide_f32 if dtype == torch.float32
               else lstm_scan_time_major_wide)
    counter.launches += 1


def _launch(
    symbol: str,
    xproj: torch.Tensor,
    w_sl: torch.Tensor,
    out: torch.Tensor,
    reverse: bool,
    plan: ClusterPlan,
    scale: torch.Tensor | None = None,
) -> None:
    """K1, K1 float32 or K15 (``symbol``) on CUDA tensors: W's slices
    ``slice_w_hh(w, plan.cluster, plan.units)`` (K15: and W_i8's [4H] scale)
    into ``out`` [T, N, H], split by ``plan``; one launch on the wrapper's
    counter."""
    act, w_dtype, elem_bytes, _, _ = _K1_KINDS[symbol]
    t_len, n, g4 = xproj.shape
    hidden = g4 // 4
    _cuda.check_tensor(xproj, "xproj", act, (t_len, n, g4))
    _cuda.check_tensor(
        w_sl, "w_sl", w_dtype,
        (plan.cluster, 4 * plan.units, _k1_depth(plan.cluster, plan.units, elem_bytes)),
    )
    _cuda.check_tensor(out, "out", act, (t_len, n, hidden))
    tensors = [xproj, w_sl, out]
    if symbol == "lstm_scan_int8":
        _cuda.check_tensor(scale, "scale", torch.float32, (g4,))
        tensors.insert(2, scale)
    if any(t.device != xproj.device for t in tensors):
        raise ValueError(f"{symbol}: inputs are on different devices")
    _cuda.launch(
        "lstm_scan", symbol, [_cuda.VOIDP] * len(tensors) + [_cuda.INT] * 8, xproj.device,
        *(t.data_ptr() for t in tensors), t_len, n, hidden, int(reverse),
        plan.cluster, plan.units, plan.rows, plan.warps,
    )
    counter = {"lstm_scan_bf16": lstm_scan_time_major, "lstm_scan_f32": lstm_scan_time_major_f32,
               "lstm_scan_int8": lstm_scan_time_major_int8}[symbol]
    counter.launches += 1


def lstm_scan_time_major(
    xproj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """[T, N, 4H] pre-projected gates + [H, 4H] recurrent weights -> [T, N, H].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    split by ``k1_launch_plan``: bf16 (H a multiple of 4 up to 512) K1 here,
    wider (up to 1024) its wide form through ``lstm_scan_time_major_wide``,
    float32 through ``lstm_scan_time_major_f32``."""
    if xproj.device.type == "cpu":
        return lstm_scan_plain(xproj, w_hh_t, reverse)
    if xproj.dtype == torch.float32:
        return lstm_scan_time_major_f32(xproj, w_hh_t, reverse)
    if k1_needs_wide(xproj.shape[-1] // 4):
        return lstm_scan_time_major_wide(xproj, w_hh_t, reverse)
    return _scan("lstm_scan_bf16", xproj, w_hh_t, reverse)


lstm_scan_time_major.launches = 0


def lstm_scan_time_major_wide(
    xproj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """K1's wide form in bf16: ``lstm_scan_time_major`` at widths no
    cluster holds (H above 512, a multiple of 4 up to 1024), on its own
    launch counter. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel, split by ``k1_wide_launch_plan``."""
    if xproj.device.type == "cpu":
        return lstm_scan_plain(xproj, w_hh_t, reverse)
    return _scan("lstm_scan_wide_bf16", xproj, w_hh_t, reverse)


lstm_scan_time_major_wide.launches = 0


def lstm_scan_time_major_f32(
    xproj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """K1 float32: ``lstm_scan_time_major`` on float32 [T, N, 4H] gates and
    [H, 4H] weights, h and the output in float32. A CPU tensor takes the
    plain version; a CUDA tensor (H a multiple of 4 up to 384) launches the
    kernel, split by ``k1_launch_plan(..., elem_bytes=4)``; wider (up to
    1024) its wide form through ``lstm_scan_time_major_wide_f32``."""
    if xproj.device.type == "cpu":
        return lstm_scan_plain(xproj, w_hh_t, reverse)
    if k1_needs_wide(xproj.shape[-1] // 4, elem_bytes=4):
        return lstm_scan_time_major_wide_f32(xproj, w_hh_t, reverse)
    return _scan("lstm_scan_f32", xproj, w_hh_t, reverse)


lstm_scan_time_major_f32.launches = 0


def lstm_scan_time_major_wide_f32(
    xproj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """K1's wide form in float32 (3xTF32 products): ``lstm_scan_time_major``
    on float32 tensors at widths no cluster holds (H above 384, a multiple
    of 4 up to 1024), on its own launch counter. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, split by
    ``k1_wide_launch_plan(..., elem_bytes=4)``."""
    if xproj.device.type == "cpu":
        return lstm_scan_plain(xproj, w_hh_t, reverse)
    return _scan("lstm_scan_wide_f32", xproj, w_hh_t, reverse)


lstm_scan_time_major_wide_f32.launches = 0


def quantize_lstm_weights(w_hh_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8 quantisation of the recurrent weights
    [H, 4H]: (w_i8 [H, 4H], scale [4H] float32) with
    ``round(h * 127) @ w_i8 * scale ~= h @ w_hh_t`` for h in [-1, 1]. Bit
    for bit the JAX ``quantize_lstm_weights``."""
    w = w_hh_t.float()
    col_max = torch.clamp(w.abs().amax(dim=0), min=1e-8)
    w_i8 = torch.round(w / col_max * 127.0).to(torch.int8)
    return w_i8, (col_max / 127.0) / 127.0


def lstm_scan_int8_plain(
    xproj: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """[T, N, 4H] gates + int8 [H, 4H] weights + [4H] scale -> [T, N, H], one
    step at a time: the product of the int8 h and W summed exactly (float64
    holds every partial sum of at most H * 127 * 127), then
    ``gates = xproj[t] + acc * scale`` in float32."""
    t_len, n, g4 = xproj.shape
    hidden = g4 // 4
    w = w_i8.double()
    s = scale.float()
    h_i8 = torch.zeros(n, hidden, dtype=torch.float64, device=xproj.device)
    c = torch.zeros(n, hidden, dtype=torch.float32, device=xproj.device)
    out = torch.empty(t_len, n, hidden, dtype=xproj.dtype, device=xproj.device)
    for step in range(t_len):
        t = t_len - 1 - step if reverse else step
        gates = xproj[t].float() + (h_i8 @ w).float() * s
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        h_i8 = torch.round(h * 127.0).double()
        out[t] = h.to(xproj.dtype)
    return out


def lstm_scan_time_major_int8(
    xproj: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """[T, N, 4H] pre-projected gates + int8 [H, 4H] recurrent weights + [4H]
    float32 scale (``quantize_lstm_weights``) -> [T, N, H].

    A CPU tensor takes the plain version; a CUDA tensor (bf16, H a multiple
    of 16 up to 512) launches the kernel, split by ``k1_launch_plan(...,
    elem_bytes=1)``."""
    if xproj.device.type == "cpu":
        return lstm_scan_int8_plain(xproj, w_i8, scale, reverse)
    return _scan("lstm_scan_int8", xproj, w_i8, reverse, scale)


lstm_scan_time_major_int8.launches = 0


def lstm_fused_plain(
    x: torch.Tensor,
    w_ih_t: torch.Tensor,
    w_hh_t: torch.Tensor,
    bias: torch.Tensor,
    reverse: bool = False,
) -> torch.Tensor:
    """[T, N, H] inputs + [H, 4H] input and recurrent weights + [4H] bias ->
    [T, N, H], one step at a time: ``gates = x[t] @ W_ih^T + h @ W_hh^T +
    bias`` in float32, ``c`` in float32, ``h`` in the input dtype."""
    t_len, n, hidden = x.shape
    wi, wh, b = w_ih_t.float(), w_hh_t.float(), bias.float()
    h = torch.zeros(n, hidden, dtype=x.dtype, device=x.device)
    c = torch.zeros(n, hidden, dtype=torch.float32, device=x.device)
    out = torch.empty(t_len, n, hidden, dtype=x.dtype, device=x.device)
    for step in range(t_len):
        t = t_len - 1 - step if reverse else step
        gates = x[t].float() @ wi + h.float() @ wh + b
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
        out[t] = h
    return out


def lstm_fused_time_major(
    x: torch.Tensor,
    w_ih_t: torch.Tensor,
    w_hh_t: torch.Tensor,
    bias: torch.Tensor,
    reverse: bool = False,
) -> torch.Tensor:
    """[T, N, H] activations + [H, 4H] weights + [4H] bias -> [T, N, H]: a
    whole LSTM layer whose input width is H.

    A CPU tensor takes the plain version; a CUDA tensor (bf16 x and weights,
    H a multiple of 4 up to 512) launches the kernel, with the bias in
    float32, split by ``k1_launch_plan(..., fused=True)``."""
    if x.device.type == "cpu":
        return lstm_fused_plain(x, w_ih_t, w_hh_t, bias, reverse)
    t_len, n, hidden = x.shape
    g4 = 4 * hidden
    if hidden % 4 or not 0 < hidden <= 512 or t_len == 0 or n == 0:
        raise ValueError(f"lstm_fused: unsupported input shape {tuple(x.shape)}")
    bias = bias.to(torch.float32).contiguous()
    _cuda.check_tensor(x, "x", torch.bfloat16, (t_len, n, hidden))
    _cuda.check_tensor(w_ih_t, "w_ih_t", torch.bfloat16, (hidden, g4))
    _cuda.check_tensor(w_hh_t, "w_hh_t", torch.bfloat16, (hidden, g4))
    _cuda.check_tensor(bias, "bias", torch.float32, (g4,))
    if any(t.device != x.device for t in (w_ih_t, w_hh_t, bias)):
        raise ValueError("lstm_fused: x, the weights and the bias are on different devices")
    plan = k1_launch_plan(hidden, n, x.device, fused=True)
    w_hh = slice_w_hh(w_hh_t, plan.cluster, plan.units)
    w_ih = w_ih_fragments(w_ih_t, plan.cluster, plan.units)
    out = torch.empty(t_len, n, hidden, dtype=x.dtype, device=x.device)
    _cuda.launch(
        "lstm_scan", "lstm_fused_bf16", [_cuda.VOIDP] * 5 + [_cuda.INT] * 8, x.device,
        x.data_ptr(), w_hh.data_ptr(), w_ih.data_ptr(), bias.data_ptr(), out.data_ptr(),
        t_len, n, hidden, int(reverse), plan.cluster, plan.units, plan.rows, plan.warps,
    )
    lstm_fused_time_major.launches += 1
    return out


lstm_fused_time_major.launches = 0
