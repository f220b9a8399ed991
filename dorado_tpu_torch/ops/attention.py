"""Banded (windowed) attention of the sup transformer, with the rotary
embedding of q and k inside.

Port of ``dorado_tpu/ops/attention.py::windowed_attention_ext_fused`` (Pallas
body ``_attn_ext_fused_kernel``) and of the band mask ``_band_bias_at``.
Query i attends keys j with ``-win_upper <= j - i <= win_lower``, cut to the
key range of the reference's own query strip (it splits the queries into 12
strips and clips each strip's keys to ``[strip start - win_lower, strip end +
win_upper)``, which drops one key of each strip's last query at sup's
window).

The TPU kernel takes an extended projection ``[q|k|v|q_swap|k_swap]`` whose
swap columns are copies of q and k columns, there only to spare its rotation
a lane shuffle; here the plain projection ``[q|k|v]`` and the ``[T, D/2]``
cos and sin tables are enough.

On a CUDA tensor the wrapper launches ``csrc/attention_banded.cu`` (bf16,
heads of 64 channels, windows up to 128 keys a side); on a CPU tensor it runs
the plain version below, which follows the same arithmetic: rotation in
float32 rounded to the stream dtype, float32 logits, softmax and p @ v, one
rounding of the output.
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
    PyTorch, a block of queries at a time over the keys its bands reach."""
    n, t_len, width = qkv.shape
    hd = width // 3
    d = hd // nhead
    q, k, v = (qkv[..., i * hd : (i + 1) * hd].reshape(n, t_len, nhead, d) for i in range(3))
    q = rope_rotate(q, cos, sin).float()
    k = rope_rotate(k, cos, sin).float()
    v = v.float()
    ref_elems = ref_strip_elems(t_len, num_splits)
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(t_len, device=qkv.device)
    out = torch.empty(n, t_len, nhead, d, dtype=qkv.dtype, device=qkv.device)
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
        out[:, qb:qe] = (pv / p.sum(dim=-1).transpose(1, 2)[..., None]).to(qkv.dtype)
    return out.reshape(n, t_len, hd)


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
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * nhead) or 0 in qkv.shape:
        raise ValueError(f"qkv: expected [N, T, 3*H*D], got {tuple(qkv.shape)}")
    n, t_len, width = qkv.shape
    hd = width // 3
    d = hd // nhead
    if d != 64 or not 0 <= win_upper <= 128 or not 0 <= win_lower <= 128:
        raise ValueError(
            f"windowed_attention_rope: the kernel takes heads of 64 channels and windows up "
            f"to 128 keys a side, not D = {d}, window ({win_upper}, {win_lower})"
        )
    _cuda.check_tensor(qkv, "qkv", torch.bfloat16, (n, t_len, width))
    _cuda.check_tensor(cos, "cos", torch.float32, (t_len, d // 2))
    _cuda.check_tensor(sin, "sin", torch.float32, (t_len, d // 2))
    if not (cos.device == sin.device == qkv.device):
        raise ValueError("windowed_attention_rope: inputs are on different devices")
    out = torch.empty(n, t_len, hd, dtype=torch.bfloat16, device=qkv.device)
    fn = _cuda.kernel_function(
        "attention_banded", "attention_banded_bf16",
        [_cuda.VOIDP] * 4 + [_cuda.INT] * 7 + [_cuda.VOIDP],
    )
    with torch.cuda.device(qkv.device):
        code = fn(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            n, t_len, nhead, d, win_upper, win_lower, ref_strip_elems(t_len, num_splits),
            _cuda.stream_ptr(qkv.device),
        )
    _cuda.check_launch("attention_banded", code)
    windowed_attention_rope.launches += 1
    return out


windowed_attention_rope.launches = 0
