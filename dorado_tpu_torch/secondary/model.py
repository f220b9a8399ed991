"""The counts polishing model: bidirectional GRU -> linear classifier.

Port of ``dorado_tpu/secondary/model.py`` (parity:
dorado/secondary/architectures/model_gru.cpp: torch GRU with batch_first,
``n_layers`` deep, bidirectional, a linear head to ``num_classes`` symbols
"*ACGT"). ``GRUModel`` holds ``self.gru`` (``nn.GRU``) and ``self.linear``,
so a reference ``weights.pt`` state dict and the CLI's ``--model-params``
directory of ``gru.weight_ih_l{l}[_reverse].tensor`` files load by name.

The JAX package runs the GRU as a ``lax.scan`` (no Pallas kernel); here it is
``nn.GRU`` (cuDNN on the card) with the same gate order (r, z, n, ``b_hn``
inside ``r *``). On the card the model computes in float32: it refuses TF32
in matmuls and turns cuDNN's TF32 off around its forward
(``float32_products``).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch
from torch import nn

SYMBOLS = "*ACGT"


@contextlib.contextmanager
def float32_products(x: torch.Tensor):
    """A polish model's forward on ``x``'s device in float32: on the card it
    raises if TF32 is on in matmuls (``prepare_cuda`` turns it off) and
    turns cuDNN's TF32 off for the block (PyTorch's default is on; the flags
    are the process's, and the polish pipeline runs on one thread)."""
    if x.device.type != "cuda":
        yield
        return
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("polish model: TF32 is on in matmuls; the model runs in float32")
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


class GRUModel(nn.Module):
    """[N, T, num_features] -> [N, T, num_classes] logits."""

    def __init__(self, num_features: int = 10, num_classes: int = 5, gru_size: int = 128,
                 n_layers: int = 2, bidirectional: bool = True):
        super().__init__()
        self.gru = nn.GRU(num_features, gru_size, n_layers, batch_first=True,
                          bidirectional=bidirectional)
        self.linear = nn.Linear(gru_size * (2 if bidirectional else 1), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.jit.is_scripting():
            return self.linear(self.gru(x)[0])
        return self._forward_float32(x)

    @torch.jit.unused
    def _forward_float32(self, x: torch.Tensor) -> torch.Tensor:
        with float32_products(x):
            return self.linear(self.gru(x)[0])


def init_gru_model(
    generator: torch.Generator, num_features: int = 10, num_classes: int = 5,
    gru_size: int = 128, n_layers: int = 2, bidirectional: bool = True,
) -> GRUModel:
    """A GRUModel with weights drawn from ``generator`` with the JAX
    package's distributions (``init_gru_params``: the gates uniform in
    ±1/sqrt(gru_size), the head normal over sqrt(fan-in), its bias 0; the
    numbers differ, the two frameworks' generators differ)."""
    model = GRUModel(num_features, num_classes, gru_size, n_layers, bidirectional)
    s = 1.0 / np.sqrt(gru_size)
    with torch.no_grad():
        for name, p in model.gru.named_parameters():
            p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * s)
        w = model.linear.weight
        w.copy_(torch.randn(w.shape, generator=generator) / np.sqrt(w.shape[1]))
        model.linear.bias.zero_()
    return model.eval()


def gru_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX package's GRU params (``init_gru_params``' pytree, its arrays
    as numpy) -> a GRUModel state dict."""
    out = {}
    for layer, entry in enumerate(params["layers"]):
        for key, sfx in (("fwd", ""), ("rev", "_reverse")):
            if key not in entry:
                continue
            for ours, theirs in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                 ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                out[f"gru.{ours}_l{layer}{sfx}"] = torch.tensor(
                    np.asarray(entry[key][theirs], np.float32))
    out["linear.weight"] = torch.tensor(np.asarray(params["linear"]["w"], np.float32))
    out["linear.bias"] = torch.tensor(np.asarray(params["linear"]["b"], np.float32))
    return out


def gru_model_from_state(arrays: dict) -> GRUModel:
    """A GRUModel of the widths a state dict's ``gru.*`` and ``linear.*``
    tensors give (as the JAX loaders read them: the layers while
    ``gru.weight_ih_l{l}`` exists, the reverse direction where present),
    with those tensors."""
    layers = 0
    while f"gru.weight_ih_l{layers}" in arrays:
        layers += 1
    if not layers or "linear.weight" not in arrays:
        raise ValueError("GRU weights need gru.weight_ih_l0 and linear.weight")
    w_ih0 = arrays["gru.weight_ih_l0"]
    model = GRUModel(num_features=int(w_ih0.shape[1]),
                     num_classes=int(arrays["linear.weight"].shape[0]),
                     gru_size=int(w_ih0.shape[0]) // 3, n_layers=layers,
                     bidirectional="gru.weight_ih_l0_reverse" in arrays)
    state = {k: torch.as_tensor(np.asarray(arrays[k], np.float32))
             for k in model.state_dict()}
    model.load_state_dict(state)
    return model.eval()


def load_gru_tensor_dir(path: Path | str) -> GRUModel:
    """A GRUModel from a directory of ``gru.*.tensor`` and ``linear.*.tensor``
    files (the CLI's ``--model-params``)."""
    from dorado_tpu_torch.io.tensor_file import load_tensor

    d = Path(path)
    arrays = {}
    layer = 0
    while (d / f"gru.weight_ih_l{layer}.tensor").exists():
        for sfx in ("", "_reverse"):
            if not (d / f"gru.weight_ih_l{layer}{sfx}.tensor").exists():
                continue
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                name = f"gru.{kind}_l{layer}{sfx}"
                arrays[name] = load_tensor(d / f"{name}.tensor")
        layer += 1
    for name in ("linear.weight", "linear.bias"):
        arrays[name] = load_tensor(d / f"{name}.tensor")
    return gru_model_from_state(arrays)


def save_gru_tensor_dir(model: GRUModel, path: Path | str) -> Path:
    """Write ``model``'s weights as one ``<name>.tensor`` file each."""
    from dorado_tpu_torch.io.tensor_file import save_tensor_file

    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    for name, t in model.state_dict().items():
        save_tensor_file(d / f"{name}.tensor", [t.detach().cpu()])
    return d


def decode_consensus(logits: np.ndarray, positions_minor: np.ndarray | None = None) -> str:
    """argmax over "*ACGT"; '*' (gap) positions are dropped
    (secondary/features/decoder_base.cpp decode_batch_bases_impl)."""
    classes = np.asarray(logits).argmax(axis=-1)
    out = []
    for c in classes.reshape(-1):
        if c != 0:
            out.append(SYMBOLS[c])
    return "".join(out)


class TorchScriptConsensusModel(nn.Module):
    """An opaque TorchScript polish model (``model.pt``; the reference's
    model_torch_script.h, loaded by model_factory.cpp:186-201) on
    ``device``: [N, T, num_features] -> [N, T, num_classes] scores. The JAX
    package runs it on the host CPU; here it runs where the pipeline does,
    in float32 (``float32_products``)."""

    def __init__(self, model_path: Path | str, device: torch.device | str = "cpu"):
        super().__init__()
        from dorado_tpu_torch.utils.torchscript import load_torchscript

        self.module = load_torchscript(model_path, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with float32_products(x):
            return self.module(x)
