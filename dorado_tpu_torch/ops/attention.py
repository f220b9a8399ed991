"""Banded (windowed) attention of the sup transformer, on each layout of q,
k and v that the JAX package's kernels take.

Ports of ``dorado_tpu/ops/attention.py``:

- ``windowed_attention_rope`` (K9, ``windowed_attention_ext_fused``): the raw
  ``[q|k|v]`` projection with RoPE of q and k inside. The TPU kernel takes an
  extended projection ``[q|k|v|q_swap|k_swap]`` whose swap columns are copies
  of q and k columns, there only to spare its rotation a lane shuffle; here
  the plain projection and the ``[T, D/2]`` cos and sin tables are enough.
- ``windowed_attention_prerotated`` (K10, ``_banded_attention_call``, the
  kernel behind ``windowed_attention_qkv_rope`` and
  ``windowed_attention_ext``): q and k rotated beforehand by ``rope_qk``, a
  plain PyTorch pass (the JAX package rotates in XLA outside the kernel too),
  and v taken from the projection.
- ``windowed_attention_halfperm`` (K11a): the projection with its q and k
  rows halves-major (``rope_halfperm``), RoPE inside; at float32 through
  ``windowed_attention_halfperm_f32``.
- ``windowed_attention_fused`` (K11b): separate q, k, v ``[N, T, H, D]``, no
  rotation, windows up to 256 keys a side.

Query i attends keys j with ``-win_upper <= j - i <= win_lower``, cut to the
key range of the reference's own query strip (it splits the queries into 12
strips and clips each strip's keys to ``[strip start - win_lower, strip end +
win_upper)``, which drops one key of each strip's last query at sup's
window): ``band_mask``, the JAX package's ``_band_bias_at``.

On a CUDA tensor each wrapper launches ``csrc/attention_banded.cu`` (bf16,
heads of 64 channels): blocks of 128 queries over a ring of 64-key tiles,
one pass with a running max. K10 and K11a also run on float32 q, k and v
(``windowed_attention_prerotated_f32``, ``windowed_attention_halfperm_f32``:
the JAX package's float32 stream), with float32 products (3xTF32) and no
rounding of the output. On a CPU
tensor each runs its plain version below, which follows the same arithmetic
but for the order of the sums:
rotation in float32 rounded to the stream dtype, float32 logits, softmax
(the max first) and p @ v, one rounding of the output.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dorado_tpu_torch.ops import _cuda

_PLAIN_BLOCK = 256  # queries the plain version takes at a time
_MASKED = -1e30


def rope_tables(
    t_len: int, head_dim: int, theta: float, device: torch.device | str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [T, D/2] in float32, from float64 angles
    (RotaryEmbeddingImpl's constructor, TxModules.cpp:184-197)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.arange(t_len, dtype=np.float64)[:, None] * inv_freq[None, :]
    cos = torch.from_numpy(np.cos(freqs).astype(np.float32))
    sin = torch.from_numpy(np.sin(freqs).astype(np.float32))
    return cos.to(device), sin.to(device)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """[N, T, H, D] -> rotated, non-interleaved halves: computed in float32 as
    ``cos * x + (-sin | sin) * swap_halves(x)`` and rounded to x's dtype."""
    d2 = x.shape[-1] // 2
    xf = x.float()
    lo, hi = xf[..., :d2], xf[..., d2:]
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    return torch.cat([c * lo + (-s) * hi, c * hi + s * lo], dim=-1).to(x.dtype)


def ref_strip_elems(t_len: int, num_splits: int = 12) -> int:
    """Queries in one strip of the reference's split loop: ceil(T / splits)
    rounded up to a multiple of 4."""
    elems = -(-t_len // num_splits)
    return elems + (-elems) % 4


def band_mask(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    t_len: int,
    win_upper: int,
    win_lower: int,
    ref_elems: int,
) -> torch.Tensor:
    """Which keys each query attends (broadcasts q_pos against k_pos): the
    band, the reference strip's key range, and 0 <= key < T."""
    diff = k_pos - q_pos
    ref_qb = torch.div(q_pos, ref_elems, rounding_mode="floor") * ref_elems
    ref_qe = torch.clamp(ref_qb + ref_elems, max=t_len)
    return (
        (diff >= -win_upper)
        & (diff <= win_lower)
        & (k_pos >= ref_qb - win_lower)
        & (k_pos < ref_qe + win_upper)
        & (k_pos >= 0)
        & (k_pos < t_len)
    )


def _banded_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    win_upper: int,
    win_lower: int,
    num_splits: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Rotated (or unrotated) q, k and v [N, T, H, D] -> [N, T, H, D] in
    plain PyTorch, a block of queries at a time over the keys its bands
    reach: the plain version of every kernel of this module."""
    n, t_len, nhead, d = q.shape
    q, k, v = q.float(), k.float(), v.float()
    ref_elems = ref_strip_elems(t_len, num_splits)
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(t_len, device=q.device)
    out = torch.empty(n, t_len, nhead, d, dtype=out_dtype, device=q.device)
    for qb in range(0, t_len, _PLAIN_BLOCK):
        qe = min(t_len, qb + _PLAIN_BLOCK)
        kb, ke = max(0, qb - win_upper), min(t_len, qe + win_lower)
        logits = torch.einsum("nqhd,nkhd->nhqk", q[:, qb:qe], k[:, kb:ke]) * scale
        valid = band_mask(
            pos[qb:qe, None], pos[None, kb:ke], t_len, win_upper, win_lower, ref_elems
        )
        logits = torch.where(valid, logits, _MASKED)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        pv = torch.einsum("nhqk,nkhd->nqhd", p, v[:, kb:ke])
        out[:, qb:qe] = (pv / p.sum(dim=-1).transpose(1, 2)[..., None]).to(out_dtype)
    return out


def windowed_attention_rope_plain(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    nhead: int,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """[N, T, 3*H*D] projection -> [N, T, H*D] attention output in plain
    PyTorch."""
    n, t_len, width = qkv.shape
    hd = width // 3
    q, k, v = (
        qkv[..., i * hd : (i + 1) * hd].reshape(n, t_len, nhead, hd // nhead) for i in range(3)
    )
    out = _banded_attention_plain(
        rope_rotate(q, cos, sin), rope_rotate(k, cos, sin), v, win_upper, win_lower,
        num_splits, qkv.dtype,
    )
    return out.reshape(n, t_len, hd)


def _check_heads(what: str, d: int, win_upper: int, win_lower: int, max_window: int) -> None:
    if d != 64 or not 0 <= win_upper <= max_window or not 0 <= win_lower <= max_window:
        raise ValueError(
            f"{what}: the kernel takes heads of 64 channels and windows up to {max_window} keys "
            f"a side, not D = {d}, window ({win_upper}, {win_lower})"
        )


def _check_tables(what: str, cos: torch.Tensor, sin: torch.Tensor, t_len: int, d: int,
                  device: torch.device) -> None:
    _cuda.check_tensor(cos, "cos", torch.float32, (t_len, d // 2))
    _cuda.check_tensor(sin, "sin", torch.float32, (t_len, d // 2))
    if not (cos.device == sin.device == device):
        raise ValueError(f"{what}: inputs are on different devices")


def _launch(symbol: str, tensors: list, ints: list, device: torch.device) -> None:
    """Call entry point ``symbol`` of ``csrc/attention_banded.cu`` with the
    tensors' pointers, then the ints, then the stream."""
    _cuda.launch(
        "attention_banded", symbol, [_cuda.VOIDP] * len(tensors) + [_cuda.INT] * len(ints),
        device, *(t.data_ptr() for t in tensors), *ints,
    )


def _check_projection(
    what: str, qkv: torch.Tensor, nhead: int, dtype: torch.dtype = torch.bfloat16
) -> tuple[int, int, int, int]:
    """(N, T, H*D, D) of a [N, T, 3*H*D] projection in ``dtype`` on the card."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * nhead) or 0 in qkv.shape:
        raise ValueError(f"{what}: qkv: expected [N, T, 3*H*D], got {tuple(qkv.shape)}")
    n, t_len, width = qkv.shape
    _cuda.check_tensor(qkv, "qkv", dtype, (n, t_len, width))
    return n, t_len, width // 3, width // 3 // nhead


# ---------------------------------------------------------------------------
# K9: the raw projection, RoPE inside
# ---------------------------------------------------------------------------


def windowed_attention_rope(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    nhead: int,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """Banded softmax attention over the raw qkv projection [N, T, 3*H*D]
    with RoPE applied to q and k inside -> [N, T, H*D].

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel:
    bf16, D = 64, windows of at most 128 keys a side, float32 tables."""
    if qkv.device.type == "cpu":
        return windowed_attention_rope_plain(
            qkv, cos, sin, nhead, win_upper, win_lower, num_splits
        )
    what = "windowed_attention_rope"
    n, t_len, hd, d = _check_projection(what, qkv, nhead)
    _check_heads(what, d, win_upper, win_lower, 128)
    _check_tables(what, cos, sin, t_len, d, qkv.device)
    out = torch.empty(n, t_len, hd, dtype=torch.bfloat16, device=qkv.device)
    _launch(
        "attention_banded_bf16", [qkv, cos, sin, out],
        [n, t_len, nhead, d, win_upper, win_lower, ref_strip_elems(t_len, num_splits)],
        qkv.device,
    )
    windowed_attention_rope.launches += 1
    return out


windowed_attention_rope.launches = 0


# ---------------------------------------------------------------------------
# K10: q and k rotated beforehand
# ---------------------------------------------------------------------------


def rope_qk(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, nhead: int) -> torch.Tensor:
    """The rotated q and k of a [N, T, 3*H*D] projection as [N, T, 2*H*D]:
    ``rope_rotate`` over both thirds at once (treating q | k as 2H heads with
    shared tables), as the JAX package's XLA pass in front of
    ``_banded_attention_call`` does."""
    n, t_len, width = qkv.shape
    hd = width // 3
    qk = qkv[..., : 2 * hd].reshape(n, t_len, 2 * nhead, hd // nhead)
    return rope_rotate(qk, cos, sin).reshape(n, t_len, 2 * hd)


def windowed_attention_prerotated_plain(
    qk_rot: torch.Tensor,
    qkv: torch.Tensor,
    nhead: int,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """K10's function in plain PyTorch."""
    n, t_len, width = qk_rot.shape
    hd = width // 2
    shape = (n, t_len, nhead, hd // nhead)
    out = _banded_attention_plain(
        qk_rot[..., :hd].reshape(shape), qk_rot[..., hd:].reshape(shape),
        qkv[..., 2 * hd :].reshape(shape), win_upper, win_lower, num_splits,
        qk_rot.dtype,
    )
    return out.reshape(n, t_len, hd)


def windowed_attention_prerotated(
    qk_rot: torch.Tensor,
    qkv: torch.Tensor,
    nhead: int,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """Banded softmax attention over q and k rotated already (``qk_rot``
    [N, T, 2*H*D], q | k, from ``rope_qk``) and v, the last third of the
    projection ``qkv`` [N, T, 3*H*D] -> [N, T, H*D]: the JAX package's
    ``_banded_attention_call``.

    It stands for both of the JAX package's routes into that kernel,
    ``windowed_attention_qkv_rope`` (q and k rotated from the plain
    projection) and ``windowed_attention_ext`` (rotated from an extended
    projection whose swap columns are copies of q and k columns): the two
    compute the same function, so the port keeps the first.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel:
    bf16 here, float32 through ``windowed_attention_prerotated_f32``; D = 64,
    windows of at most 128 keys a side."""
    if qk_rot.device.type == "cpu":
        return windowed_attention_prerotated_plain(
            qk_rot, qkv, nhead, win_upper, win_lower, num_splits
        )
    if qk_rot.dtype == torch.float32:
        return windowed_attention_prerotated_f32(
            qk_rot, qkv, nhead, win_upper, win_lower, num_splits
        )
    out = _prerotated_launch(qk_rot, qkv, nhead, win_upper, win_lower, num_splits)
    windowed_attention_prerotated.launches += 1
    return out


def windowed_attention_prerotated_f32(
    qk_rot: torch.Tensor,
    qkv: torch.Tensor,
    nhead: int,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """K10 at float32: ``windowed_attention_prerotated`` on float32 q, k
    and v (the JAX package's float32 stream, which takes this kernel where
    the bf16 one takes the fused-RoPE route), float32 products and output, on
    its own launch counter. A CPU tensor takes the plain version."""
    if qk_rot.device.type == "cpu":
        return windowed_attention_prerotated_plain(
            qk_rot, qkv, nhead, win_upper, win_lower, num_splits
        )
    out = _prerotated_launch(qk_rot, qkv, nhead, win_upper, win_lower, num_splits)
    windowed_attention_prerotated_f32.launches += 1
    return out


def _prerotated_launch(
    qk_rot, qkv, nhead, win_upper, win_lower, num_splits, out=None
) -> torch.Tensor:
    """K10's launch on CUDA tensors, bf16 or float32 (qk_rot's dtype); into
    ``out`` where given (a check fills it with NaN first)."""
    what = "windowed_attention_prerotated"
    dtype = qk_rot.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: the kernel takes bf16 or float32, not {dtype}")
    n, t_len, hd, d = _check_projection(what, qkv, nhead, dtype)
    _check_heads(what, d, win_upper, win_lower, 128)
    _cuda.check_tensor(qk_rot, "qk_rot", dtype, (n, t_len, 2 * hd))
    if qk_rot.device != qkv.device:
        raise ValueError(f"{what}: inputs are on different devices")
    if out is None:
        out = torch.empty(n, t_len, hd, dtype=dtype, device=qkv.device)
    _cuda.check_tensor(out, "out", dtype, (n, t_len, hd))
    symbol = "attention_prerotated_f32" if dtype == torch.float32 else "attention_prerotated_bf16"
    _launch(
        symbol, [qk_rot, qkv, out],
        [n, t_len, nhead, d, win_upper, win_lower, ref_strip_elems(t_len, num_splits)],
        qkv.device,
    )
    return out


windowed_attention_prerotated.launches = 0
windowed_attention_prerotated_f32.launches = 0


# ---------------------------------------------------------------------------
# K11a: halves-major q and k rows, RoPE inside
# ---------------------------------------------------------------------------


def rope_halfperm(nhead: int, head_dim: int) -> np.ndarray:
    """Row permutation taking a natural [H*D] q (or k) projection to
    halves-major order: the first halves of all heads, then the second
    halves (the JAX package's ``rope_halfperm``)."""
    d2 = head_dim // 2
    return np.asarray(
        [h * head_dim + half * d2 + i for half in (0, 1) for h in range(nhead) for i in range(d2)],
        np.int64,
    )


def wqkv_halfperm_rows(nhead: int, d_model: int) -> np.ndarray:
    """The row order of a halves-major [3*H*D, d_model] qkv weight: the q and
    k rows permuted by ``rope_halfperm``, the v rows as they are."""
    hp = rope_halfperm(nhead, d_model // nhead)
    return np.concatenate([hp, d_model + hp, 2 * d_model + np.arange(d_model)])


def windowed_attention_halfperm_plain(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    nhead: int,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """K11a's function in plain PyTorch: the q and k thirds back to natural
    order (an exact gather), then K9's arithmetic."""
    n, t_len, width = qkv.shape
    hd = width // 3
    d = hd // nhead
    q, k = (
        qkv[..., i * hd : (i + 1) * hd]
        .reshape(n, t_len, 2, nhead, d // 2)
        .transpose(2, 3)
        .reshape(n, t_len, nhead, d)
        for i in range(2)
    )
    v = qkv[..., 2 * hd :].reshape(n, t_len, nhead, d)
    out = _banded_attention_plain(
        rope_rotate(q, cos, sin), rope_rotate(k, cos, sin), v, win_upper, win_lower,
        num_splits, qkv.dtype,
    )
    return out.reshape(n, t_len, hd)


def windowed_attention_halfperm(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    nhead: int,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """Banded softmax attention over a [N, T, 3*H*D] projection whose q and
    k rows are halves-major (``wqkv_halfperm_rows``), with RoPE inside ->
    [N, T, H*D] in natural head order. The JAX kernel takes [2, T, H*D]
    tables (``rope_half_tables``); their entries are the [T, D/2] tables'
    ``cos`` and ``-sin | sin``, so this takes those, and the rotated values
    are the same float32 arithmetic as K9's.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel:
    bf16 here, float32 through ``windowed_attention_halfperm_f32``; D = 64,
    windows of at most 128 keys a side, float32 tables."""
    if qkv.device.type == "cpu":
        return windowed_attention_halfperm_plain(
            qkv, cos, sin, nhead, win_upper, win_lower, num_splits
        )
    if qkv.dtype == torch.float32:
        return windowed_attention_halfperm_f32(
            qkv, cos, sin, nhead, win_upper, win_lower, num_splits
        )
    out = _halfperm_launch(qkv, cos, sin, nhead, win_upper, win_lower, num_splits)
    windowed_attention_halfperm.launches += 1
    return out


def windowed_attention_halfperm_f32(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    nhead: int,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """K11a at float32: ``windowed_attention_halfperm`` on a float32
    projection (the JAX package's float32 stream on the ``"hp"`` route),
    float32 rotation, products (3xTF32) and output, on its own launch
    counter. A CPU tensor takes the plain version."""
    if qkv.device.type == "cpu":
        return windowed_attention_halfperm_plain(
            qkv, cos, sin, nhead, win_upper, win_lower, num_splits
        )
    out = _halfperm_launch(qkv, cos, sin, nhead, win_upper, win_lower, num_splits)
    windowed_attention_halfperm_f32.launches += 1
    return out


def _halfperm_launch(
    qkv, cos, sin, nhead, win_upper, win_lower, num_splits, out=None
) -> torch.Tensor:
    """K11a's launch on CUDA tensors, bf16 or float32 (qkv's dtype); into
    ``out`` where given (a check fills it with NaN first)."""
    what = "windowed_attention_halfperm"
    dtype = qkv.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: the kernel takes bf16 or float32, not {dtype}")
    n, t_len, hd, d = _check_projection(what, qkv, nhead, dtype)
    _check_heads(what, d, win_upper, win_lower, 128)
    _check_tables(what, cos, sin, t_len, d, qkv.device)
    if out is None:
        out = torch.empty(n, t_len, hd, dtype=dtype, device=qkv.device)
    _cuda.check_tensor(out, "out", dtype, (n, t_len, hd))
    symbol = "attention_halfperm_f32" if dtype == torch.float32 else "attention_halfperm_bf16"
    _launch(
        symbol, [qkv, cos, sin, out],
        [n, t_len, nhead, d, win_upper, win_lower, ref_strip_elems(t_len, num_splits)],
        qkv.device,
    )
    return out


windowed_attention_halfperm.launches = 0
windowed_attention_halfperm_f32.launches = 0


# ---------------------------------------------------------------------------
# K11b: separate q, k, v
# ---------------------------------------------------------------------------


def windowed_attention_fused_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """K11b's function in plain PyTorch."""
    return _banded_attention_plain(q, k, v, win_upper, win_lower, num_splits, q.dtype)


def windowed_attention_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    win_upper: int,
    win_lower: int,
    num_splits: int = 12,
) -> torch.Tensor:
    """Banded softmax attention over separate q, k, v [N, T, H, D] (no
    rotation) -> [N, T, H, D], windows of up to 256 keys a side: the JAX
    package's ``windowed_attention_fused``. No pipeline path calls it.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel:
    bf16, D = 64."""
    if q.device.type == "cpu":
        return windowed_attention_fused_plain(q, k, v, win_upper, win_lower, num_splits)
    what = "windowed_attention_fused"
    if q.dim() != 4 or 0 in q.shape:
        raise ValueError(f"{what}: q: expected [N, T, H, D], got {tuple(q.shape)}")
    n, t_len, nhead, d = q.shape
    _check_heads(what, d, win_upper, win_lower, 256)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _cuda.check_tensor(t, name, torch.bfloat16, (n, t_len, nhead, d))
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: inputs are on different devices")
    out = torch.empty(n, t_len, nhead, d, dtype=torch.bfloat16, device=q.device)
    _launch(
        "attention_separate_bf16", [q, k, v, out],
        [n, t_len, nhead, d, win_upper, win_lower, ref_strip_elems(t_len, num_splits)],
        q.device,
    )
    windowed_attention_fused.launches += 1
    return out


windowed_attention_fused.launches = 0
