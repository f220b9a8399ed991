"""The correction scorer with the HERRO inference contract (port of
``dorado_tpu/correct/nn_model.py``).

The reference ships the HERRO model as an opaque TorchScript blob and only
defines its interface (CorrectionInferenceNode.cpp:247-283): inputs
(bases [B, R, L] int32 padded with 11, quals [B, R, L] float, lengths,
supported-position indices per window), output tuple whose element [1] is
base logits over the 5 classes "ACGT*" at the supported positions.

``CorrectionModel`` is the JAX package's ``correction_forward`` as a
module: a per-column read-set encoder (base embedding + qual, masked mean +
max over the read axis) feeding a RoPE transformer over the window length,
with a 5-class head. The attention is the plain product, softmax, product
that the JAX function computes (no kernel of its own), over every column of
the window: the mask compares with the collate pad (11), which the window
features never hold (they pad with '.', 10), so one window goes through a
forward at a time, as in the JAX package. The forward runs in float32 with
TF32 off in its products (``float32_products``). ``correction_state_dict``
carries the JAX package's parameters across. ``TorchScriptScorer`` runs a
HERRO TorchScript model with that contract on the pipeline's device.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PAD_ENC = 11  # collate pad value (CorrectionInferenceNode.cpp:230)
NUM_SYMBOLS = 12  # "ACGT*acgt#." + pad
NUM_CLASSES = 5  # "ACGT*"
CLASSES = "ACGT*"


@dataclass
class CorrectionModelConfig:
    dim: int = 128
    depth: int = 4
    heads: int = 4
    ff_mult: int = 4
    emb_dim: int = 8


@contextlib.contextmanager
def float32_products(device: torch.device):
    """Matmuls in full float32 for the block on the card: TF32 off, and the
    process's setting put back after it (the correction command builds no
    runner, so it sets no process-wide flag of its own)."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _rope(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] rotary over T: non-interleaved halves, base 10000."""
    d, t = x.shape[-1], x.shape[-3]
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=x.device), inv)
    emb = torch.cat([freqs, freqs], -1)[:, None, :]
    rot = torch.cat([-x[..., d // 2 :], x[..., : d // 2]], -1)
    return x * emb.cos() + rot * emb.sin()


class _Block(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.ln2 = nn.LayerNorm(d, eps=1e-5)
        self.ff1 = nn.Linear(d, ff)
        self.ff2 = nn.Linear(ff, d)

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // heads
        qkv = self.qkv(self.ln1(x)).reshape(b, l, 3, heads, hd)
        q, k, v = _rope(qkv[:, :, 0]), _rope(qkv[:, :, 1]), qkv[:, :, 2]
        attn = torch.softmax(torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd), -1)
        x = x + self.proj(torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, l, d))
        return x + self.ff2(F.gelu(self.ff1(self.ln2(x)), approximate="tanh"))


class CorrectionModel(nn.Module):
    """bases [B, R, L] integer, quals [B, R, L] float32 -> logits [B, L, 5].
    ``logits`` is the forward without the float32 scope (TorchScript
    compiles it, as a HERRO-contract wrapper does)."""

    def __init__(self, cfg: CorrectionModelConfig | None = None):
        super().__init__()
        self.cfg = cfg = cfg or CorrectionModelConfig()
        self.heads = cfg.heads
        self.embed = nn.Embedding(NUM_SYMBOLS, cfg.emb_dim)
        self.col_in = nn.Linear(2 * (cfg.emb_dim + 1), cfg.dim)
        self.layers = nn.ModuleList(
            _Block(cfg.dim, cfg.ff_mult * cfg.dim) for _ in range(cfg.depth))
        self.head = nn.Linear(cfg.dim, NUM_CLASSES)

    @torch.jit.unused
    def forward(self, bases: torch.Tensor, quals: torch.Tensor) -> torch.Tensor:
        with float32_products(bases.device):
            return self.logits(bases, quals)

    @torch.jit.export
    def logits(self, bases: torch.Tensor, quals: torch.Tensor) -> torch.Tensor:
        # literals: TorchScript reads no module constant (PAD_ENC, NUM_SYMBOLS - 1)
        m = (bases != 11)[..., None].float()  # [B, R, L, 1]
        # the embedding index is clipped, as the JAX gather clips it
        emb = self.embed(bases.clamp(0, 11).long())
        feat = torch.cat([emb, quals[..., None]], -1)  # [B, R, L, E+1]
        denom = m.sum(1).clamp_min(1.0)
        mean = (feat * m).sum(1) / denom
        mx = torch.where(m > 0, feat, torch.full_like(feat, -1e9)).amax(1)
        mx = torch.where(denom > 0, mx, torch.zeros_like(mx))
        x = self.col_in(torch.cat([mean, mx], -1))  # [B, L, D]
        for layer in self.layers:
            x = layer(x, self.heads)
        return self.head(x)


def init_correction_model(
    generator: torch.Generator, cfg: CorrectionModelConfig | None = None
) -> CorrectionModel:
    """A CorrectionModel with weights drawn from ``generator`` with the JAX
    package's distributions (``init_correction_model``: the embedding normal
    at 0.1, each projection normal over sqrt(fan-in), biases 0, norms 1 and
    0; the numbers differ, the two frameworks' generators differ)."""
    model = CorrectionModel(cfg)
    with torch.no_grad():
        model.embed.weight.copy_(
            torch.randn(model.embed.weight.shape, generator=generator) * 0.1)
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                                 / np.sqrt(mod.in_features))
                mod.bias.zero_()
    return model.eval()


def correction_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX package's correction parameters (``init_correction_model``'s
    pytree, as numpy arrays) as a CorrectionModel state dict."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {"embed.weight": t(params["embed"])}
    for name in ("col_in", "head"):
        out[f"{name}.weight"] = t(params[name]["w"])
        out[f"{name}.bias"] = t(params[name]["b"])
    for i, layer in enumerate(params["layers"]):
        for name in ("qkv", "proj", "ff1", "ff2"):
            out[f"layers.{i}.{name}.weight"] = t(layer[name]["w"])
            out[f"layers.{i}.{name}.bias"] = t(layer[name]["b"])
        for name in ("ln1", "ln2"):
            out[f"layers.{i}.{name}.weight"] = t(layer[name]["g"])
            out[f"layers.{i}.{name}.bias"] = t(layer[name]["b"])
    return out


def window_logits(model: CorrectionModel, wf, device: torch.device) -> torch.Tensor:
    """The model's logits [L, 5] over one window's columns, on ``device``."""
    bases = torch.from_numpy(wf.bases[None]).to(device)
    quals = torch.from_numpy(wf.quals[None]).to(device)
    with torch.no_grad():
        return model(bases, quals)[0]


def predict_supported(model: CorrectionModel, wf, device: torch.device | None = None) -> str:
    """The predicted base (from "ACGT*") at each supported position of one
    WindowFeatures, matching decode_preds (CorrectionInferenceNode.cpp:
    278-283); the forward runs on ``device`` (the model's by default)."""
    if not len(wf.indices):
        return ""
    device = device or next(model.parameters()).device
    logits = window_logits(model, wf, device)
    at = logits[torch.from_numpy(wf.indices.astype(np.int64)).to(device)]
    return "".join(CLASSES[int(i)] for i in at.argmax(-1).cpu())


class TorchScriptScorer:
    """Runs an ONT-shipped HERRO TorchScript model (e.g. herro-v1) on
    ``device``, with the input contract of CorrectionInferenceNode.cpp:
    247-283: (bases int32 [B, R, L] padded with 11, quals float32, lengths
    int32, a list of per-window supported-index tensors), the module and all
    four inputs on ``device``; element [1] of the output tuple holds the
    base logits at the supported positions."""

    def __init__(self, model_path: str, device: torch.device | str = "cpu"):
        from dorado_tpu_torch.utils.torchscript import load_torchscript

        self.device = torch.device(device)
        self.module = load_torchscript(model_path, self.device)

    def predict(self, wf) -> str:
        if not len(wf.indices):
            return ""
        dev = self.device
        bases = torch.from_numpy(wf.bases[None].astype(np.int32)).to(dev)
        quals = torch.from_numpy(wf.quals[None].astype(np.float32)).to(dev)
        lengths = torch.tensor([wf.bases.shape[1]], dtype=torch.int32, device=dev)
        indices = [torch.from_numpy(wf.indices.astype(np.int32)).to(dev)]
        with torch.no_grad(), float32_products(dev):
            out = self.module(bases, quals, lengths, indices)
        logits = out[1] if isinstance(out, tuple) else out.toTuple()[1]
        preds = logits.argmax(-1).cpu().numpy().reshape(-1)
        return "".join(CLASSES[int(i)] for i in preds[: len(wf.indices)])
