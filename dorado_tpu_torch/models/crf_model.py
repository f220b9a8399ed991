"""Conv + LSTM + LinearCRF basecalling model (fast/hac families).

Port of ``dorado_tpu/models/crf_model.py`` (architecture parity with the
reference CRF models, dorado/basecall/model/CRFModel.cpp:29-62):

  normalised signal [N, T] -> conv stack (stride product) -> time-major
  [T/stride, N, H] -> 5 alternating-direction LSTM layers (first reversed)
  -> LinearCRF (optional decomposition, tanh*5, clamp +-5) -> transition
  scores [T/stride, N, 4^(state_len+1)] float32

Each LSTM layer runs its input projection ``x @ W_ih^T + (b_ih + b_hh)`` as
one time-parallel matmul and hands the serial recurrence to
``ops.lstm.lstm_scan_time_major`` (a CUDA kernel on the GPU). Convolutions
and matmuls take the module's dtype, sum in float32 where PyTorch does, add
their biases in float32 and cast back, as the JAX model does.

``quantize_lstm_crf_w8a8`` turns the input projections into W8A8: a
quantised layer holds ``w_ih_q`` (int8) and ``w_ih_s`` (float32 scales) in
place of ``w_ih`` and projects through ``ops.int8_matmul.w8a8_matmul_fq``
(a CUDA kernel on the GPU) with the bias added inside it.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dorado_tpu_torch.config import Activation, BasecallModelConfig
from dorado_tpu_torch.ops.int8_matmul import quantize_weight_rows, w8a8_matmul_fq
from dorado_tpu_torch.ops.lstm import lstm_scan_time_major


def _activation(x: torch.Tensor, act: Activation) -> torch.Tensor:
    if act is Activation.SWISH:
        return F.silu(x)
    if act is Activation.SWISH_CLAMP:
        # silu clamped from above at 3.5 (reference: nn/ConvStack.cpp:154)
        return torch.clamp(F.silu(x), max=3.5)
    if act is Activation.TANH:
        return torch.tanh(x)
    raise ValueError(f"unknown activation {act}")


def _lstm_constants(
    layer: nn.Module, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """A layer's bias b_ih + b_hh summed in float32, W_hh^T in dtype,
    contiguous, and a quantised layer's float32 weight scales (else None)."""
    scales = getattr(layer, "w_ih_s", None)
    return (
        layer.b_ih.float() + layer.b_hh.float(),
        layer.w_hh.t().to(dtype).contiguous(),
        None if scales is None else scales.float(),
    )


def conv_stack(x: torch.Tensor, convs, weights, biases) -> torch.Tensor:
    """[N, C_in, T] -> [N, C_out, T/stride] through the conv layers ``convs``
    (``ConvParams``) with ``weights`` [C_out, C_in, K] and ``biases``: the
    stack both model families start with."""
    for cv, w, b in zip(convs, weights, biases):
        y = F.conv1d(x, w, stride=cv.stride, padding=cv.padding)
        x = _activation((y.float() + b.float()[:, None]).to(x.dtype), cv.activation)
    return x


def _linear_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """x @ w^T in x's dtype, returned in float32 with the bias added there."""
    out = torch.matmul(x, w.t()).float()
    return out if b is None else out + b.float()


class LSTMCRFModel(nn.Module):
    """Parameters use the JAX model's names and the torch layouts: conv
    weights [C_out, C_in, K], LSTM weights [4H, C] (gate order i, f, g, o),
    linear weights [out, in]."""

    def __init__(
        self,
        config: BasecallModelConfig,
        device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if not config.is_lstm_model or config.is_flstm_model:
            raise ValueError("LSTMCRFModel supports conv + LSTM CRF models only")
        self.config = config
        kw = {"device": device, "dtype": dtype}
        self.conv_w = nn.ParameterList(
            nn.Parameter(torch.zeros(cv.size, cv.insize, cv.winlen, **kw))
            for cv in config.convs
        )
        self.conv_b = nn.ParameterList(
            nn.Parameter(torch.zeros(cv.size, **kw)) for cv in config.convs
        )
        h = config.lstm_size
        self.lstms = nn.ModuleList()
        for _ in range(config.lstm_layers):
            layer = nn.Module()
            layer.w_ih = nn.Parameter(torch.zeros(4 * h, h, **kw))
            layer.w_hh = nn.Parameter(torch.zeros(4 * h, h, **kw))
            layer.b_ih = nn.Parameter(torch.zeros(4 * h, **kw))
            layer.b_hh = nn.Parameter(torch.zeros(4 * h, **kw))
            self.lstms.append(layer)
        self.pre_v4 = config.has_pre_v4_head
        if config.out_features is not None:
            self.linear1_w = nn.Parameter(torch.zeros(config.out_features, h, **kw))
            self.linear1_b = (
                nn.Parameter(torch.zeros(config.out_features, **kw)) if config.bias else None
            )
            self.linear2_w = nn.Parameter(
                torch.zeros(config.outsize, config.out_features, **kw)
            )
        else:
            self.linear1_w = nn.Parameter(torch.zeros(config.outsize, h, **kw))
            self.linear1_b = (
                nn.Parameter(torch.zeros(config.outsize, **kw))
                if config.bias or self.pre_v4
                else None
            )
            self.linear2_w = None
        self._frozen_lstm: list[tuple] | None = None

    @torch.no_grad()
    def freeze_lstm_constants(self, dtype: torch.dtype) -> None:
        """Make each layer's float32 bias sum, its W_hh^T in ``dtype`` and a
        quantised layer's float32 weight scales once, on the module's
        current device, instead of on every forward pass. Called before the
        module is cast to ``dtype``, it sums the float32 biases and keeps
        the scales in float32, as the JAX model does. The weights must not
        change afterwards."""
        self._frozen_lstm = [_lstm_constants(p, dtype) for p in self.lstms]

    def conv_stack(self, x: torch.Tensor) -> torch.Tensor:
        """[N, C_in, T] -> [N, C_out, T/stride]."""
        return conv_stack(x, self.config.convs, self.conv_w, self.conv_b)

    def lstm_stack(self, x: torch.Tensor) -> torch.Tensor:
        """[T, N, H] -> [T, N, H]; layer i runs reversed when i is even."""
        for i, p in enumerate(self.lstms):
            bias, w_hh_t, scales = (
                self._frozen_lstm[i] if self._frozen_lstm else _lstm_constants(p, x.dtype)
            )
            if scales is not None:
                xproj = w8a8_matmul_fq(x, p.w_ih_q.t(), scales, bias, out_dtype=x.dtype)
            else:
                xproj = _linear_f32(x, p.w_ih, bias).to(x.dtype)
            x = lstm_scan_time_major(xproj, w_hh_t, reverse=i % 2 == 0)
        return x

    def linear_crf_head(self, x: torch.Tensor) -> torch.Tensor:
        """[T, N, H] -> [T, N, outsize] float32 scores."""
        if self.linear2_w is not None:
            y = _linear_f32(x, self.linear1_w, self.linear1_b).to(x.dtype)
            scores = _linear_f32(y, self.linear2_w, None)
        else:
            scores = _linear_f32(x, self.linear1_w, self.linear1_b)
        return self.head_activation(scores)

    def head_activation(self, scores: torch.Tensor) -> torch.Tensor:
        """The head's output activation on its float32 matmul output."""
        if self.pre_v4:
            return 5.0 * torch.tanh(scores)
        if self.config.scale == 5.0:
            scores = 5.0 * torch.tanh(scores)
        if self.config.clamp:
            scores = torch.clamp(scores, -5.0, 5.0)
        return scores

    def features(self, signal: torch.Tensor) -> torch.Tensor:
        """[N, T] (or [N, T, F]) normalised signal -> time-major features
        [T/stride, N, H] in the module's dtype: the convolutions and LSTMs in
        front of the CRF head."""
        if signal.dim() == 2:
            signal = signal[..., None]
        dtype = self.conv_w[0].dtype
        x = self.conv_stack(signal.to(dtype).transpose(1, 2))
        return self.lstm_stack(x.permute(2, 0, 1).contiguous())  # [T, N, H]

    def forward(self, signal: torch.Tensor) -> torch.Tensor:
        """[N, T] (or [N, T, F]) normalised signal -> time-major scores
        [T/stride, N, outsize] float32, computed in the module's dtype."""
        return self.linear_crf_head(self.features(signal))


def init_lstm_crf_params(
    config: BasecallModelConfig,
    generator: torch.Generator,
    device: torch.device | str | None = None,
) -> LSTMCRFModel:
    """A model with random weights of the reference shapes, drawn from
    ``generator`` with the JAX package's distributions (the numbers differ:
    the two frameworks' generators differ)."""
    model = LSTMCRFModel(config, device="cpu")
    h = config.lstm_size

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator) / math.sqrt(fan_in)

    def uniform(shape, scale):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale

    with torch.no_grad():
        for cv, w in zip(config.convs, model.conv_w):
            w.copy_(normal(w.shape, cv.insize * cv.winlen))
        for p in model.lstms:
            scale = 1.0 / math.sqrt(h)
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                getattr(p, name).copy_(uniform(getattr(p, name).shape, scale))
        model.linear1_w.copy_(normal(model.linear1_w.shape, h))
        if model.linear2_w is not None:
            model.linear2_w.copy_(normal(model.linear2_w.shape, config.out_features))
    return model.to(device) if device is not None else model


def _set_quantised(layer: nn.Module, wq: torch.Tensor, ws: torch.Tensor) -> None:
    del layer.w_ih
    layer.register_buffer("w_ih_q", wq.contiguous())
    layer.register_buffer("w_ih_s", ws.contiguous())


@torch.no_grad()
def quantize_lstm_crf_w8a8(model: LSTMCRFModel) -> LSTMCRFModel:
    """A copy of ``model`` with int8 input-projection weights.

    Only ``w_ih`` is quantised (symmetric int8 per output channel); the
    recurrent weights, biases, convolutions and the CRF head keep their
    precision. Layers whose ``w_ih`` dims are not multiples of 128 (fast's
    H = 96) and layers already quantised stay as they are. Quantise the
    float32 model, before any cast to a narrower type."""
    out = copy.deepcopy(model)
    out._frozen_lstm = None
    for layer in out.lstms:
        w = getattr(layer, "w_ih", None)
        if w is None or w.shape[0] % 128 or w.shape[1] % 128:
            continue
        _set_quantised(layer, *quantize_weight_rows(w))
    return out


def params_from_jax(params, config: BasecallModelConfig) -> LSTMCRFModel:
    """A float32 CPU model holding the weights of a JAX parameter pytree
    (``dorado_tpu.models.crf_model.init_lstm_crf_params`` layout, as numpy
    arrays or anything ``np.asarray`` takes), so both packages compute the
    same function. Layers that hold ``w_ih_q``/``w_ih_s`` in place of
    ``w_ih`` (``quantize_lstm_crf_params_w8a8`` there) become quantised
    layers here."""
    model = LSTMCRFModel(config, device="cpu")

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    with torch.no_grad():
        for p, w, b in zip(params["convs"], model.conv_w, model.conv_b):
            w.copy_(t(p["w"]).permute(2, 1, 0))  # HIO [K, C_in, C_out] -> [C_out, C_in, K]
            b.copy_(t(p["b"]))
        for p, layer in zip(params["lstms"], model.lstms):
            for name in ("w_hh", "b_ih", "b_hh"):
                getattr(layer, name).copy_(t(p[name]))
            if "w_ih_q" in p:
                _set_quantised(
                    layer, torch.from_numpy(np.array(p["w_ih_q"], dtype=np.int8)), t(p["w_ih_s"])
                )
            else:
                layer.w_ih.copy_(t(p["w_ih"]))
        model.linear1_w.copy_(t(params["linear1"]["w"]))
        if model.linear1_b is not None:
            model.linear1_b.copy_(t(params["linear1"]["b"]))
        if model.linear2_w is not None:
            model.linear2_w.copy_(t(params["linear2"]["w"]))
    return model
