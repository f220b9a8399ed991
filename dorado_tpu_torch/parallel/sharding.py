"""Several devices: the device mesh and the sharded basecall step.

Port of ``dorado_tpu/parallel/sharding.py``. The reference's only
parallelism is data parallelism over chunk batches (one ``CudaCaller`` per
GPU, dorado/api/runner_creation.cpp:86-124), which the runner gives with one
model replica on each card (``basecall.runner``). This module keeps the JAX
package's two-axis form of it, a ``("data", "model")`` grid of devices:

  - **data**: the rows of a batch split into contiguous shares, one per
    data group, each computed on its group's first device (chunks are
    independent, so no device waits for another);
  - **model**: the CRF head's output rows (``linear1``, ``linear2``: their
    weights and biases) split over the group's devices; each device
    computes its columns of the head, and the group's first device gathers
    them in column order, as XLA all-gathers the sharded head where the
    decode needs whole scores. For production models this axis is 1.

Where JAX lets ``jit`` place the work and pick the collectives, the step
here enqueues each group's work on its devices itself. The decode runs on
the card: K6 (both LSE scans in one launch, ``crf_cuda.forward_backward_
scores``) for the posteriors and the beam's back guide, and K7a + K5
(``crf_cuda.viterbi_path``) for the Viterbi path; on the CPU their plain
versions.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from dorado_tpu_torch.basecall.runner import (
    on_device,
    prepare_cuda,
    resolve_compute_dtype,
    resolve_devices,
)
from dorado_tpu_torch.config import BasecallModelConfig
from dorado_tpu_torch.models.crf_model import LSTMCRFModel, _linear_f32
from dorado_tpu_torch.ops.crf_cuda import forward_backward_scores, viterbi_path

# the parameters split over "model" (``_head_partition`` of the JAX module:
# linear1 and linear2, their w and b)
HEAD_PARAMS = ("linear1_w", "linear1_b", "linear2_w")
# the step's stay score, as the JAX step fixes it
BLANK_SCORE = 2.0


@dataclass(frozen=True)
class Mesh:
    """A [data, model] grid of devices."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str] = ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}


def make_mesh(
    n_devices: int | None = None,
    data: int | None = None,
    model: int = 1,
    devices: list | None = None,
) -> Mesh:
    """A ("data", "model") mesh over the first ``n_devices`` of ``devices``
    (every visible card unless given; the same device may appear more than
    once). Raises ValueError when ``data`` x ``model`` is not the number of
    devices."""
    devs = resolve_devices(list(devices) if devices is not None else None)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if data is None:
        data = n // model
    if data * model != n or n == 0:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(tuple(tuple(devs[d * model : (d + 1) * model]) for d in range(data)))


@dataclass(frozen=True)
class ShardedModel:
    """A model placed on a mesh: ``cells[d][m]`` is the copy on
    ``mesh.devices[d][m]`` in ``dtype``, holding the whole model but for the
    head parameters, of which it holds its own rows."""

    mesh: Mesh
    cells: list[list[LSTMCRFModel]]
    dtype: torch.dtype


def shard_params(
    model: LSTMCRFModel,
    mesh: Mesh,
    config: BasecallModelConfig,
    compute_dtype: torch.dtype | None = None,
) -> ShardedModel:
    """One copy of ``model`` on each device of ``mesh``: replicated, but for
    the CRF head's output rows, which split over the "model" axis (no split
    when that axis is 1). Each copy is cast to ``compute_dtype`` (None: bf16
    on CUDA, float32 on the CPU) with its LSTM constants frozen, as the
    runner makes its replicas. Raises ValueError for a model other than conv
    + LSTM + CRF (the JAX step's ``lstm_crf_forward``) and for head rows the
    axis does not divide."""
    if not isinstance(model, LSTMCRFModel) or not config.is_lstm_model:
        raise ValueError("the sharded step takes conv + LSTM CRF models only")
    parts = mesh.shape["model"]
    for name in HEAD_PARAMS:
        p = getattr(model, name)
        if p is not None and p.shape[0] % parts:
            raise ValueError(f"{name}: {p.shape[0]} rows do not split over {parts} devices")
    dtype = resolve_compute_dtype(compute_dtype, mesh.devices[0][0])
    cells = []
    for row in mesh.devices:
        out = []
        for m, dev in enumerate(row):
            cell = copy.deepcopy(model)
            cell._frozen_lstm = None
            with torch.no_grad():
                for name in HEAD_PARAMS:
                    p = getattr(cell, name)
                    if p is not None:
                        setattr(cell, name, nn.Parameter(p.detach().chunk(parts)[m].clone()))
            cell = cell.to(dev).eval()
            cell.freeze_lstm_constants(dtype)
            out.append(cell.to(dtype))
        cells.append(out)
    return ShardedModel(mesh, cells, dtype)


def _columns(
    x: torch.Tensor, row: list[LSTMCRFModel], devices, weight: str, bias: str | None
) -> torch.Tensor:
    """x @ W^T + b in float32 on x's device, each device of the group
    computing its rows of W (its columns of the output), gathered in order."""
    parts = []
    for cell, dev in zip(row, devices):
        with on_device(dev):
            b = getattr(cell, bias) if bias else None
            parts.append(_linear_f32(x.to(dev), getattr(cell, weight), b).to(x.device))
    return torch.cat(parts, dim=-1)


def _sharded_head(x: torch.Tensor, row: list[LSTMCRFModel], devices) -> torch.Tensor:
    """``LSTMCRFModel.linear_crf_head`` with its matmuls split over the
    group's devices: [T, N, H] -> float32 scores [T, N, outsize]."""
    if row[0].linear2_w is not None:
        y = _columns(x, row, devices, "linear1_w", "linear1_b").to(x.dtype)
        scores = _columns(y, row, devices, "linear2_w", None)
    else:
        scores = _columns(x, row, devices, "linear1_w", "linear1_b")
    return row[0].head_activation(scores)


def _decode(scores: torch.Tensor, decoder: str) -> tuple:
    """Time-major float32 scores [T, N, C] -> the step's outputs, [N, ...]."""
    scores = scores.contiguous()
    alpha, beta = forward_backward_scores(scores, BLANK_SCORE)
    posts = torch.softmax(alpha + beta, dim=-1).transpose(0, 1)
    if decoder == "viterbi":
        states, moves = viterbi_path(scores, BLANK_SCORE)
        return states.t(), moves.t(), posts
    return scores.transpose(0, 1), beta.transpose(0, 1), posts


def make_sharded_basecall_step(
    config: BasecallModelConfig,
    mesh: Mesh,
    decoder: str = "viterbi",
    compute_dtype: torch.dtype | None = None,
):
    """The basecall step with the batch split over the "data" axis:
    ``step(sharded, signal)`` takes a ``ShardedModel`` of ``shard_params``
    and signal [N, T] (a tensor or an array; N a multiple of the data axis,
    else ValueError), and returns, on the mesh's first device,

      - ``viterbi``: (states [N, T] int32, moves [N, T] uint8, posts
        [N, T+1, S] float32);
      - ``beam``: (scores [N, T, C] float32, the backward scores
        [N, T+1, S], posts),

    the JAX step's outputs in its layout. ``compute_dtype``: the model's
    type (None: bf16 on CUDA, float32 on the CPU), the one given to
    ``shard_params`` (else ValueError); the head writes float32 scores at
    either."""
    if decoder not in ("viterbi", "beam"):
        raise ValueError(f"unknown decoder {decoder!r}: expected 'viterbi' or 'beam'")
    first = mesh.devices[0][0]
    dtype = resolve_compute_dtype(compute_dtype, first)
    if first.type == "cuda":
        prepare_cuda()

    @torch.inference_mode()
    def step(sharded: ShardedModel, signal) -> tuple:
        if sharded.mesh != mesh:
            raise ValueError("the model was placed on another mesh")
        if sharded.dtype != dtype:
            raise ValueError(f"the model was placed in {sharded.dtype}, the step runs {dtype}")
        sig = torch.as_tensor(signal)
        groups = mesh.shape["data"]
        if sig.shape[0] % groups:
            raise ValueError(f"{sig.shape[0]} rows do not split over a data axis of {groups}")
        share = sig.shape[0] // groups
        outs = []
        for d, (row, devices) in enumerate(zip(sharded.cells, mesh.devices)):
            with on_device(devices[0]):
                x = row[0].features(sig[d * share : (d + 1) * share].to(devices[0]))
                outs.append(_decode(_sharded_head(x, row, devices), decoder))
        return tuple(torch.cat([o[i].to(first) for o in outs]) for i in range(3))

    return step
