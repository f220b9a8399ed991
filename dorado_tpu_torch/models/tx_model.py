"""Transformer (sup) basecalling model.

Port of ``dorado_tpu/models/tx_model.py`` (architecture parity with the
reference TxModel, dorado/basecall/model/TxModel.cpp:10-42,
dorado/nn/TxModules.cpp):

  signal [N, T] -> conv stack (stride 12) -> [N, T', d_model]
  -> depth x TxEncoder (post-norm deepnorm):
       attn = WindowedMHA(x)          # RoPE on q and k, banded window
       x = RMSNorm1(out_proj(attn) + alpha * x)
       f = SwiGLU-MLP(x)              # fc1 -> y * silu(gate) -> fc2
       x = RMSNorm2(f + alpha * x)
  -> LinearUpsample (T' -> scale * T')
  -> LinearScaledCRF (weights scaled by crf.scale)
  -> time-major scores [scale * T', N, outsize]

Each layer's attention takes one of three routes (``attention``), which
compute one function: ``"extf"`` (the default) through
``ops.attention.windowed_attention_rope`` (K9, RoPE inside); ``"ext"``
through ``rope_qk`` (a plain PyTorch rotation pass) and
``windowed_attention_prerotated`` (K10), which stands for both of the JAX
package's ``ext`` and ``qkv_rope`` routes; ``"hp"`` through
``windowed_attention_halfperm`` (K11a) over q and k rows held halves-major.
With ``fused_norm`` the output projection, the bias, the scaled residual and
the first RMS norm run as one kernel (``ops.fused_norm``, K14), and so do fc2
and the second norm when the encoder matmuls are unquantised. The JAX package
picks these routes with environment variables; here they are arguments. A
float32 stream leaves ``"extf"`` for ``"ext"`` (K10 at float32), as the JAX
layer falls back to its plain ext kernel at float32; ``"hp"`` runs K11a at
float32 (``windowed_attention_halfperm_f32``).

``quantize_tx_w8a8`` turns the encoder's three fat matmuls into W8A8:
``wqkv`` through ``ops.int8_matmul.w8a8_matmul_fq``, fc1 with the SwiGLU
product and the requantisation through ``swiglu_w8a8``, fc2 through
``w8a8_matmul`` (CUDA kernels on the GPU); in a float32 model they write
float32. ``quantize_tx_head_w8a8`` also takes the upsample and the CRF head
through ``w8a8_matmul_fq``, with the bias fused and ``crf.scale`` folded into
the scales (the JAX package's ``quantize_tx_head_w8a8``, which no runner path
of either package calls). ``quantize_tx_int8`` holds the
same three as int8 weights whose products take per-token quantised
activations and an int32 dot (``torch._int_mm`` on the GPU, the exact
float64 product on the CPU), as the JAX package's ``quantize_tx_params``
path does through XLA. The residual stream, norms, attention, output
projection, upsample and CRF head keep the module's dtype. Matmuls take the
module's dtype and sum in float32 where PyTorch does; a bias is added inside
the product, before its one rounding, as the JAX model adds it.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dorado_tpu_torch.config import BasecallModelConfig
from dorado_tpu_torch.models.crf_model import conv_stack
from dorado_tpu_torch.ops.attention import (
    rope_qk,
    rope_tables,
    windowed_attention_halfperm,
    windowed_attention_prerotated,
    windowed_attention_rope,
    wqkv_halfperm_rows,
)
from dorado_tpu_torch.ops.fused_norm import matmul_residual_rmsnorm
from dorado_tpu_torch.ops.int8_matmul import (
    _int_product,
    quantize_rows,
    quantize_weight_rows,
    swiglu_w8a8,
    w8a8_matmul,
    w8a8_matmul_fq,
)

ATTENTION_ROUTES = ("extf", "ext", "hp")
# the quantised matrices of each precision: W8A8 holds fc1 as its value and
# gate halves, int8 whole
_QUANTISED_NAMES = {
    "float": (),
    "w8a8": ("wqkv", "fc1_y", "fc1_g", "fc2"),
    "int8": ("wqkv", "fc1", "fc2"),
}


def check_attention_route(attention: str) -> str:
    if attention not in ATTENTION_ROUTES:
        raise ValueError(
            f"unknown attention route {attention!r}: expected one of {ATTENTION_ROUTES}"
        )
    return attention


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight (nn/RMSNorm.cpp:11-15): the
    statistics and the normalisation in float32, rounded to x's dtype, then
    the weight multiplied in that dtype, as the JAX function does. PyTorch's
    own RMS norm does the first part in one pass over x."""
    return F.rms_norm(x, x.shape[-1:], None, eps) * weight.to(x.dtype)


class TxModel(nn.Module):
    """Parameters use the JAX model's names and layouts (linear weights
    [out, in]) but for the convolutions, which take torch's [C_out, C_in, K].

    ``precision`` says what the encoder layers hold: ``"float"`` (``wqkv``,
    ``fc1``, ``fc2`` in the module's dtype), ``"w8a8"`` or ``"int8"``
    (``<name>_q`` int8 and ``<name>_s`` float32 scales in their place, for
    each name of ``_QUANTISED_NAMES[precision]``). Every model starts on
    the ``"extf"`` route without fused norms; ``set_routes`` moves it to
    another, and on ``"hp"`` the rows of ``wqkv`` (and of its quantised
    weights and scales) are held halves-major
    (``ops.attention.wqkv_halfperm_rows``)."""

    def __init__(
        self,
        config: BasecallModelConfig,
        device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if not config.is_tx_model:
            raise ValueError("TxModel supports transformer models only")
        self.config = config
        self.attention = "extf"
        self.fused_norm = False
        self.precision = "float"
        tx = config.tx.tx
        d, ff = tx.d_model, tx.dim_feedforward
        kw = {"device": device, "dtype": dtype}
        self.conv_w = nn.ParameterList(
            nn.Parameter(torch.zeros(cv.size, cv.insize, cv.winlen, **kw))
            for cv in config.convs
        )
        self.conv_b = nn.ParameterList(
            nn.Parameter(torch.zeros(cv.size, **kw)) for cv in config.convs
        )
        self.layers = nn.ModuleList()
        for _ in range(tx.depth):
            layer = nn.Module()
            layer.wqkv = nn.Parameter(torch.zeros(3 * d, d, **kw))
            layer.out_proj_w = nn.Parameter(torch.zeros(d, d, **kw))
            layer.out_proj_b = nn.Parameter(torch.zeros(d, **kw))
            layer.fc1 = nn.Parameter(torch.zeros(2 * ff, d, **kw))
            layer.fc2 = nn.Parameter(torch.zeros(d, ff, **kw))
            layer.norm1 = nn.Parameter(torch.ones(d, **kw))
            layer.norm2 = nn.Parameter(torch.ones(d, **kw))
            self.layers.append(layer)
        scale_factor = config.tx.upsample.scale_factor
        self.upsample_w = nn.Parameter(torch.zeros(scale_factor * d, d, **kw))
        self.upsample_b = nn.Parameter(torch.zeros(scale_factor * d, **kw))
        self.crf_w = nn.Parameter(torch.zeros(config.tx.crf.outsize, d, **kw))
        self.head_quantised = False
        self._frozen_scales: list[dict[str, torch.Tensor]] | None = None
        self._frozen_head: dict[str, torch.Tensor] | None = None
        self._rope: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def freeze_constants(self) -> None:
        """Keep each quantised layer's weight scales in float32, on the
        module's current device, and a quantised head's scales (the CRF's
        with ``crf.scale`` folded in) and upsample bias. Called before the
        module is cast to a narrower dtype, which would round the scale
        buffers; the weights must not change afterwards."""
        self._frozen_scales = [
            {
                name: getattr(layer, name + "_s").float().clone()
                for name in _QUANTISED_NAMES[self.precision]
            }
            for layer in self.layers
        ]
        self._frozen_head = self._head_constants() if self.head_quantised else None

    def _head_constants(self) -> dict[str, torch.Tensor]:
        """A quantised head's float32 constants: the upsample's scales and
        bias, and the CRF's scales times ``crf.scale`` (the JAX head's fold)."""
        return {
            "upsample_s": self.upsample_w_s.float().clone(),
            "upsample_b": self.upsample_b.float().clone(),
            "crf_s": self.crf_w_s.float() * self.config.tx.crf.scale,
        }

    def rope(self, t_len: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """The float32 cos and sin tables [T', D/2] for ``t_len`` tokens on
        ``device``, made once per length (a copy from the host waits for
        the stream, so a step must not make them anew)."""
        key = (t_len, str(device))
        if key not in self._rope:
            tx = self.config.tx.tx
            self._rope[key] = rope_tables(t_len, tx.d_model // tx.nhead, tx.theta, device)
        return self._rope[key]

    def encoder_layer(
        self, index: int, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
    ) -> torch.Tensor:
        """[N, T', d_model] -> [N, T', d_model] through encoder layer ``index``
        (``tx_encoder_layer`` of the JAX package)."""
        tx = self.config.tx.tx
        p = self.layers[index]
        dtype = x.dtype
        # alpha rounded to the stream dtype, as the JAX layer multiplies
        alpha = torch.tensor(tx.deepnorm_alpha, dtype=dtype).item()
        names = _QUANTISED_NAMES[self.precision]
        scales = (
            self._frozen_scales[index]
            if self._frozen_scales
            else {name: getattr(p, name + "_s").float() for name in names}
        )
        if self.precision == "w8a8":
            qkv = w8a8_matmul_fq(x, p.wqkv_q.t(), scales["wqkv"], out_dtype=dtype)
        elif self.precision == "int8":
            qkv = _int8_linear(x, p.wqkv_q, scales["wqkv"])
        else:
            qkv = F.linear(x, p.wqkv)
        win = tx.attn_window
        if self.attention == "extf" and dtype != torch.float32:
            attn = windowed_attention_rope(qkv, cos, sin, tx.nhead, *win)
        elif self.attention in ("extf", "ext"):
            # a float32 stream takes the pre-rotated kernel on "extf" too, as
            # the JAX layer falls back to its ext kernel at float32
            qk_rot = rope_qk(qkv, cos, sin, tx.nhead)
            attn = windowed_attention_prerotated(qk_rot, qkv, tx.nhead, *win)
        else:
            attn = windowed_attention_halfperm(qkv, cos, sin, tx.nhead, *win)
        if self.fused_norm:
            x = matmul_residual_rmsnorm(attn, p.out_proj_w, p.out_proj_b, x, p.norm1, alpha)
        else:
            attn = F.linear(attn, p.out_proj_w, p.out_proj_b)
            x = rms_norm(attn + x * alpha, p.norm1)

        if self.precision == "w8a8":
            xq, xs = quantize_rows(x)
            tq, ts = swiglu_w8a8(
                xq, xs, p.fc1_y_q.t(), scales["fc1_y"], p.fc1_g_q.t(), scales["fc1_g"]
            )
            f = w8a8_matmul(tq, ts, p.fc2_q.t(), scales["fc2"], out_dtype=dtype)
            return rms_norm(f + x * alpha, p.norm2)
        if self.precision == "int8":
            y, gate = _int8_linear(x, p.fc1_q, scales["fc1"]).chunk(2, dim=-1)
        else:
            y, gate = F.linear(x, p.fc1).chunk(2, dim=-1)
        t_act = F.silu(gate.float()).to(dtype) * y
        if self.precision == "int8":
            f = _int8_linear(t_act, p.fc2_q, scales["fc2"])
        elif self.fused_norm:
            return matmul_residual_rmsnorm(t_act, p.fc2, None, x, p.norm2, alpha)
        else:
            f = F.linear(t_act, p.fc2)
        return rms_norm(f + x * alpha, p.norm2)

    def forward(
        self, signal: torch.Tensor, score_dtype: torch.dtype = torch.float32
    ) -> torch.Tensor:
        """[N, T] (or [N, T, F]) normalised signal -> time-major scores
        [T/stride, N, outsize] in ``score_dtype``, computed in the module's
        dtype. (The JAX ``tx_forward`` returns them batch-major and its
        runner swaps the axes; here the head writes them time-major.) A
        bf16 module on the card asked for float32 scores writes them from
        the head's float32 sums, as the JAX head does
        (``preferred_element_type``), with no bf16 rounding or copy between."""
        if signal.dim() == 2:
            signal = signal[..., None]
        dtype = self.conv_w[0].dtype
        x = conv_stack(
            signal.to(dtype).transpose(1, 2), self.config.convs, self.conv_w, self.conv_b
        )
        x = x.transpose(1, 2).contiguous()  # [N, T', d_model]
        n, t_len, d = x.shape
        cos, sin = self.rope(t_len, x.device)
        for i in range(len(self.layers)):
            x = self.encoder_layer(i, x, cos, sin)

        # LinearUpsample: [N, T', d] -> [N, scale * T', d] (nn/LinearUpsample.cpp)
        scale_factor = self.config.tx.upsample.scale_factor
        head = self._frozen_head or (self._head_constants() if self.head_quantised else None)
        if head is not None:
            # the quantised head: the bias fused, the compute dtype out
            x = w8a8_matmul_fq(
                x, self.upsample_w_q.t(), head["upsample_s"], head["upsample_b"], out_dtype=dtype
            )
        else:
            x = F.linear(x, self.upsample_w, self.upsample_b)
        x = x.reshape(n, scale_factor * t_len, d)

        # LinearScaledCRF: weights scaled by crf.scale (TxModules.cpp:330-339)
        x = x.transpose(0, 1).contiguous()  # [T, N, d]
        if head is not None:
            # crf.scale folded into the scales; the scores leave in the
            # compute dtype, as the JAX head's do
            return w8a8_matmul_fq(x, self.crf_w_q.t(), head["crf_s"], out_dtype=dtype).to(
                score_dtype)
        w = (self.crf_w.float() * self.config.tx.crf.scale).to(dtype)
        if dtype == score_dtype:
            return F.linear(x, w)
        if x.device.type == "cuda" and dtype == torch.bfloat16:
            scores = torch.mm(x.reshape(-1, d), w.t(), out_dtype=score_dtype)
            return scores.reshape(*x.shape[:2], -1)
        # the compute-type operands' float32 sums, rounded once to the score
        # dtype
        return F.linear(x.float(), w.float()).to(score_dtype)


def init_tx_params(
    config: BasecallModelConfig,
    generator: torch.Generator,
    device: torch.device | str | None = None,
) -> TxModel:
    """A model with random weights of the reference shapes, drawn from
    ``generator`` with the JAX package's distributions (the numbers differ:
    the two frameworks' generators differ)."""
    model = TxModel(config, device="cpu")
    tx = config.tx.tx
    d, ff = tx.d_model, tx.dim_feedforward

    def normal(param, fan_in):
        param.copy_(torch.randn(param.shape, generator=generator) / math.sqrt(fan_in))

    with torch.no_grad():
        for cv, w in zip(config.convs, model.conv_w):
            normal(w, cv.insize * cv.winlen)
        for p in model.layers:
            normal(p.wqkv, d)
            normal(p.out_proj_w, d)
            normal(p.fc1, d)
            normal(p.fc2, ff)
        normal(model.upsample_w, d)
        normal(model.crf_w, d)
    return model.to(device) if device is not None else model


def _int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ int8 wq [O, K].T with float32 row scales ``ws`` -> [..., O]
    in x's dtype: x quantised per token (``quantize_rows``, the JAX package's
    ``_q8_act``), the int32 product dequantised as ``(acc * x_scale) *
    w_scale`` (its ``_mm_q8``). The product is ``torch._int_mm`` on the GPU
    and the exact float64 one on the CPU."""
    k = x.shape[-1]
    xq, xs = quantize_rows(x)
    xq = xq.reshape(-1, k)
    if x.device.type == "cuda":
        acc = torch._int_mm(xq, wq.t()).float()
    else:
        acc = _int_product(xq, wq.t())
    out = acc * xs.reshape(-1, 1) * ws.reshape(1, -1)
    return out.to(x.dtype).reshape(*x.shape[:-1], wq.shape[0])


def _set_quantised(layer: nn.Module, quantised: dict[str, tuple]) -> None:
    """Replace a layer's wqkv, fc1 and fc2 by the int8 weights and float32
    scales of ``quantised`` (a pair for each name of the precision)."""
    for name in ("wqkv", "fc1", "fc2"):
        delattr(layer, name)
    for name, (wq, ws) in quantised.items():
        layer.register_buffer(name + "_q", wq.contiguous())
        layer.register_buffer(name + "_s", ws.contiguous())


def _quantised_copy(model: TxModel, precision: str) -> tuple[TxModel, bool]:
    """A copy of ``model`` for quantising to ``precision``, and whether its
    layers still need it (a model of that precision stays as it is)."""
    if model.precision not in ("float", precision):
        raise ValueError(f"the model holds {model.precision} weights, not float ones")
    out = copy.deepcopy(model)
    out._frozen_scales = None
    todo = out.precision == "float"
    out.precision = precision
    return out, todo


@torch.no_grad()
def quantize_tx_w8a8(model: TxModel) -> TxModel:
    """A copy of ``model`` with each encoder layer's ``wqkv``, ``fc1`` (split
    into its value rows and gate rows) and ``fc2`` as symmetric int8 per
    output channel with float32 scales (``quantize_tx_params_w8a8`` of the
    JAX package). The output projection, norms, upsample and CRF head keep
    their precision; a W8A8 model stays as it is. Quantise the float32
    model, before any cast to a narrower type."""
    out, todo = _quantised_copy(model, "w8a8")
    for layer in out.layers if todo else ():
        ffn = layer.fc1.shape[0] // 2
        _set_quantised(layer, {
            "wqkv": quantize_weight_rows(layer.wqkv),
            "fc1_y": quantize_weight_rows(layer.fc1[:ffn]),
            "fc1_g": quantize_weight_rows(layer.fc1[ffn:]),
            "fc2": quantize_weight_rows(layer.fc2),
        })
    return out


@torch.no_grad()
def quantize_tx_int8(model: TxModel) -> TxModel:
    """A copy of ``model`` with each encoder layer's ``wqkv``, ``fc1`` and
    ``fc2`` as symmetric int8 per output channel with float32 scales, for
    products with per-token quantised activations (``quantize_tx_params`` of
    the JAX package, its ``tx_precision="int8"``). The rest keeps its
    precision; an int8 model stays as it is. Quantise the float32 model."""
    out, todo = _quantised_copy(model, "int8")
    for layer in out.layers if todo else ():
        _set_quantised(layer, {
            name: quantize_weight_rows(getattr(layer, name)) for name in ("wqkv", "fc1", "fc2")
        })
    return out


@torch.no_grad()
def quantize_tx_head_w8a8(model: TxModel) -> TxModel:
    """A copy of ``model`` whose upsample and CRF head weights are symmetric
    int8 per output channel with float32 scales (``upsample_w_q``/``_s``,
    ``crf_w_q``/``_s``; the upsample bias stays), run through
    ``w8a8_matmul_fq``: the JAX package's ``quantize_tx_head_w8a8``. Its
    scores leave the kernel in the compute dtype, as the JAX head's do, and
    are cast to the score dtype asked for. A model whose head is quantised
    stays as it is. Quantise the float32 model."""
    out = copy.deepcopy(model)
    out._frozen_head = None
    if not out.head_quantised:
        _set_head_quantised(
            out, quantize_weight_rows(out.upsample_w), quantize_weight_rows(out.crf_w)
        )
    return out


def _set_head_quantised(model: TxModel, upsample: tuple, crf: tuple) -> None:
    """Replace the upsample and CRF weights by int8 ones and float32 scales."""
    del model.upsample_w, model.crf_w
    for name, (wq, ws) in (("upsample_w", upsample), ("crf_w", crf)):
        model.register_buffer(name + "_q", wq.contiguous())
        model.register_buffer(name + "_s", ws.contiguous())
    model.head_quantised = True


@torch.no_grad()
def set_routes(
    model: TxModel, attention: str | None = None, fused_norm: bool | None = None
) -> TxModel:
    """Move ``model``, in place, to another attention route or norm route
    (None: as it is), and return it. The rows of ``wqkv``, or of its int8
    weights and their scales (the permutation commutes with row-wise
    quantisation), are re-ordered once, here, for the halves-major layout
    of ``"hp"`` or back from it."""
    attention = check_attention_route(attention or model.attention)
    if fused_norm is not None:
        model.fused_norm = bool(fused_norm)
    if (attention == "hp") != (model.attention == "hp"):
        tx = model.config.tx.tx
        rows = torch.from_numpy(wqkv_halfperm_rows(tx.nhead, tx.d_model))
        if model.attention == "hp":
            rows = torch.argsort(rows)  # back to natural order
        quantised = model.precision != "float"
        for i, layer in enumerate(model.layers):
            for name in ("wqkv_q", "wqkv_s") if quantised else ("wqkv",):
                t = getattr(layer, name)
                t.copy_(t[rows.to(t.device)])
            if quantised and model._frozen_scales:
                scales = model._frozen_scales[i]
                scales["wqkv"] = scales["wqkv"][rows.to(scales["wqkv"].device)]
    model.attention = attention
    return model


def with_routes(
    model: TxModel, attention: str | None = None, fused_norm: bool | None = None
) -> TxModel:
    """A copy of ``model`` moved to another route (``set_routes``)."""
    return set_routes(copy.deepcopy(model), attention, fused_norm)


def tx_params_from_jax(params, config: BasecallModelConfig) -> TxModel:
    """A float32 CPU model on the ``"extf"`` route holding the weights of a
    JAX parameter pytree (``dorado_tpu.models.tx_model.init_tx_params``
    layout, as numpy arrays or anything ``np.asarray`` takes), so both
    packages compute the same function. Layers that hold
    ``<name>_w8``/``<name>_w8s`` in place of ``wqkv``, ``fc1`` and ``fc2``
    (``quantize_tx_params_w8a8`` there) make a W8A8 model, layers that hold
    ``<name>_q``/``<name>_s`` (``quantize_tx_params``) an int8 one, and an
    upsample and CRF head that hold ``w8``/``w8s`` (``quantize_tx_head_w8a8``)
    a quantised head."""
    model = TxModel(config, device="cpu")
    first = params["layers"][0]
    if "wqkv_w8" in first:
        model.precision, suffixes = "w8a8", ("_w8", "_w8s")
    elif "wqkv_q" in first:
        model.precision, suffixes = "int8", ("_q", "_s")

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    with torch.no_grad():
        for p, w, b in zip(params["convs"], model.conv_w, model.conv_b):
            w.copy_(t(p["w"]).permute(2, 1, 0))  # HIO [K, C_in, C_out] -> [C_out, C_in, K]
            b.copy_(t(p["b"]))
        for p, layer in zip(params["layers"], model.layers):
            for name in ("out_proj_w", "out_proj_b", "norm1", "norm2"):
                getattr(layer, name).copy_(t(p[name]))
            if model.precision == "float":
                for name in ("wqkv", "fc1", "fc2"):
                    getattr(layer, name).copy_(t(p[name]))
            else:
                _set_quantised(layer, {
                    name: (
                        torch.from_numpy(np.array(p[name + suffixes[0]], dtype=np.int8)),
                        t(p[name + suffixes[1]]),
                    )
                    for name in _QUANTISED_NAMES[model.precision]
                })
        model.upsample_b.copy_(t(params["upsample"]["b"]))
        if "w8" in params["upsample"]:
            _set_head_quantised(model, *(
                (torch.from_numpy(np.array(params[k]["w8"], dtype=np.int8)),
                 t(params[k]["w8s"]).reshape(-1))
                for k in ("upsample", "crf")
            ))
        else:
            model.upsample_w.copy_(t(params["upsample"]["w"]))
            model.crf_w.copy_(t(params["crf"]["w"]))
    return model
