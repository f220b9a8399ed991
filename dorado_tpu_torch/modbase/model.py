"""Modified-base calling models.

Port of ``dorado_tpu/modbase/model.py`` (parity with dorado/modbase/nn/
ModBaseModel.cpp), one ``nn.Module`` for each architecture:

  - conv_lstm (v1, context) and conv_lstm_v2 (chunked): three signal convs,
    two sequence convs and a merge conv (all SiLU), two LSTMs (the second
    over time reversed, SiLU after each), a linear head; v2 gives every
    stride step's softmax, flattened, v1 the last step's;
  - conv_lstm_v3: the convs' shapes and activations from the config's
    sublayers, no activation after the LSTMs.

The convs are ``F.conv1d`` and the head one product, as the JAX package
computes them outside any Pallas kernel. Each LSTM takes its input
projection as one ``torch.matmul`` plus the float32 bias sum and hands the
recurrence to ``ops.lstm.lstm_scan_time_major``: on the card, K1 float32.
The model runs in float32, as the JAX package runs it: on the card no
product may go through TF32. The forward runs its convs with cuDNN's TF32
off, scoped to them, and refuses to run while TF32 is on in matmuls
(PyTorch's default is off).

Weight file names follow load_modbase_conv_lstm_weights
(ModBaseModel.cpp:49-76): sig_conv1..3, seq_conv1..2, merge_conv1,
lstm1/lstm2, fc.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dorado_tpu_torch.io.tensor_file import load_tensor, save_tensor_file
from dorado_tpu_torch.modbase.config import ModBaseModelConfig, ModBaseModelType
from dorado_tpu_torch.ops.lstm import lstm_scan_time_major


def _act(name: str):
    if name in ("swish", "silu"):
        return F.silu
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"unsupported modbase activation {name}")


def _conv_specs(config: ModBaseModelConfig):
    """(signal convs, sequence convs, merge conv) as (cin, cout, k, stride,
    pad, act) tuples."""
    t = config.model_type
    if t in (ModBaseModelType.CONV_LSTM_V1, ModBaseModelType.CONV_LSTM_V2):
        pad = t is ModBaseModelType.CONV_LSTM_V2
        size, stride = config.size, config.stride
        kmer = config.kmer_len * 4
        sig = [
            (1, 4, 5, 1, 2 * pad, "swish"),
            (4, 16, 5, 1, 2 * pad, "swish"),
            (16, size, 9, stride, 4 * pad, "swish"),
        ]
        seq = [
            (kmer, 16, 5, 1, 2 * pad, "swish"),
            (16, size, 13, stride, 6 * pad, "swish"),
        ]
        merge = (size * 2, size, 5, 1, 2 * pad, "swish")
        return sig, seq, merge
    if t is ModBaseModelType.CONV_LSTM_V3:
        def spec(d):
            return (
                int(d["insize"]),
                int(d["size"]),
                int(d["winlen"]),
                int(d["stride"]),
                int(d.get("padding", d["winlen"] // 2)),
                d.get("activation", "swish"),
            )

        sig = [spec(d) for d in config.signal_encoder if d["type"] == "convolution"]
        seq = [spec(d) for d in config.sequence_encoder if d["type"] == "convolution"]
        enc_convs = [spec(d) for d in config.encoder if d["type"] == "convolution"]
        if len(enc_convs) != 1:
            raise ValueError("expected one merge convolution in v3 encoder")
        return sig, seq, enc_convs[0]
    raise ValueError(f"unsupported modbase model type {t}")


def stride_ratio(config: ModBaseModelConfig) -> int:
    """The signal convs' stride over the sequence convs'
    (ModBaseModelConfig.cpp:189-205): 1 for v1/v2 models, whose sequence
    convs downsample as far as the signal convs."""
    sig, seq, _merge = _conv_specs(config)
    sig_stride = int(np.prod([s[3] for s in sig]))
    seq_stride = int(np.prod([s[3] for s in seq]))
    if sig_stride % seq_stride:
        raise ValueError("modbase signal stride must be divisible by sequence stride")
    return sig_stride // seq_stride


class ModBaseConvLSTM(nn.Module):
    """A modbase model of ``config``'s type with zero weights (load them with
    ``load_modbase_params``, ``modbase_params_from_jax`` or
    ``init_modbase_params``). Layouts are the torch ones: conv weights
    [C_out, C_in, K], LSTM weights [4H, H] (gate order i, f, g, o), the head
    [num_out, H]."""

    def __init__(self, config: ModBaseModelConfig, device: torch.device | str | None = None):
        super().__init__()
        self.config = config
        sig, seq, merge = _conv_specs(config)
        self.specs = (sig, seq, merge)
        kw = {"device": device, "dtype": torch.float32}

        def conv_ws(specs):
            return nn.ParameterList(nn.Parameter(torch.zeros(s[1], s[0], s[2], **kw))
                                    for s in specs)

        def conv_bs(specs):
            return nn.ParameterList(nn.Parameter(torch.zeros(s[1], **kw)) for s in specs)

        self.sig_w, self.sig_b = conv_ws(sig), conv_bs(sig)
        self.seq_w, self.seq_b = conv_ws(seq), conv_bs(seq)
        self.merge_w = nn.Parameter(torch.zeros(merge[1], merge[0], merge[2], **kw))
        self.merge_b = nn.Parameter(torch.zeros(merge[1], **kw))
        h = config.size
        self.lstms = nn.ModuleList()
        for _ in range(2):
            layer = nn.Module()
            layer.w_ih = nn.Parameter(torch.zeros(4 * h, h, **kw))
            layer.w_hh = nn.Parameter(torch.zeros(4 * h, h, **kw))
            layer.b_ih = nn.Parameter(torch.zeros(4 * h, **kw))
            layer.b_hh = nn.Parameter(torch.zeros(4 * h, **kw))
            self.lstms.append(layer)
        self.fc_w = nn.Parameter(torch.zeros(config.num_out, h, **kw))
        self.fc_b = nn.Parameter(torch.zeros(config.num_out, **kw))

    @staticmethod
    def _lstm(layer: nn.Module, x: torch.Tensor, reverse: bool) -> torch.Tensor:
        """[T, N, H] -> [T, N, H]: the input projection in one product with
        the biases' sum, then the recurrence (``reverse``: walked from the
        last step, each output at its own step)."""
        xproj = torch.matmul(x, layer.w_ih.t()) + (layer.b_ih + layer.b_hh)
        return lstm_scan_time_major(xproj.contiguous(), layer.w_hh.t().contiguous(), reverse)

    def forward(self, sigs: torch.Tensor, seqs: torch.Tensor) -> torch.Tensor:
        """[N, T] signal + [N, T / stride_ratio, kmer_len * 4] kmer one-hots
        -> probabilities: [N, T / stride * num_out] for chunked models (each
        step's softmax, flattened), [N, num_out] for context models."""
        if sigs.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("modbase model: TF32 is on in matmuls; the model runs in float32")
        sig, seq, merge = self.specs
        # cuDNN runs float32 convs in TF32 unless told not to (PyTorch's
        # default): off here, for the convs alone. The flags are the
        # process's: the pipeline runs every forward on one thread, the
        # scheduler's, and its runner keeps them off anyway
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            x = sigs.float()[:, None, :]
            for spec, w, b in zip(sig, self.sig_w, self.sig_b):
                x = _act(spec[5])(F.conv1d(x, w, b, stride=spec[3], padding=spec[4]))
            s = seqs.float().transpose(1, 2)
            for spec, w, b in zip(seq, self.seq_w, self.seq_b):
                s = _act(spec[5])(F.conv1d(s, w, b, stride=spec[3], padding=spec[4]))
            z = torch.cat([x, s], dim=1)
            z = _act(merge[5])(F.conv1d(z, self.merge_w, self.merge_b, stride=merge[3],
                                        padding=merge[4]))
        z = z.permute(2, 0, 1)  # [T, N, H]
        # The JAX model runs lstm2 forwards on the time-flipped sequence and
        # flips its output (and, in v3, the head's) back. Every operation
        # outside the recurrence is per step, so the port runs lstm2
        # reversed (K1's own reverse) on the unflipped sequence instead: the
        # same operations on the same values, no flipped copies
        lstm1, lstm2 = self.lstms
        if self.config.model_type is ModBaseModelType.CONV_LSTM_V3:
            z = self._lstm(lstm2, self._lstm(lstm1, z, False), True)
        else:
            z = F.silu(self._lstm(lstm1, z, False))
            z = F.silu(self._lstm(lstm2, z, True))
        logits = torch.matmul(z, self.fc_w.t()) + self.fc_b  # [T, N, num_out]
        if self.config.model_type is ModBaseModelType.CONV_LSTM_V1:
            return torch.softmax(logits[-1], dim=-1)
        probs = torch.softmax(logits, dim=-1)
        return probs.permute(1, 0, 2).reshape(probs.shape[1], -1)


def init_modbase_params(
    config: ModBaseModelConfig, generator: torch.Generator,
    device: torch.device | str | None = None,
) -> ModBaseConvLSTM:
    """A model with random weights drawn from ``generator`` with the JAX
    package's distributions (the numbers differ: the two frameworks'
    generators differ)."""
    model = ModBaseConvLSTM(config, device="cpu")
    h = config.size

    def uniform(shape, scale):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale

    with torch.no_grad():
        for w in (*model.sig_w, *model.seq_w, model.merge_w):
            w.copy_(torch.randn(w.shape, generator=generator) / np.sqrt(w.shape[1] * w.shape[2]))
        for layer in model.lstms:
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                p = getattr(layer, name)
                p.copy_(uniform(p.shape, 1.0 / np.sqrt(h)))
        model.fc_w.copy_(torch.randn(model.fc_w.shape, generator=generator) / np.sqrt(h))
    return model.to(device) if device is not None else model


def modbase_params_from_jax(params, config: ModBaseModelConfig) -> ModBaseConvLSTM:
    """A float32 CPU model holding the weights of a JAX parameter pytree
    (``dorado_tpu.modbase.model.init_modbase_params``' layout: conv weights
    [K, C_in, C_out], as numpy arrays or anything ``np.asarray`` takes)."""
    model = ModBaseConvLSTM(config, device="cpu")

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    with torch.no_grad():
        convs = [*zip(params["sig_convs"], model.sig_w, model.sig_b),
                 *zip(params["seq_convs"], model.seq_w, model.seq_b),
                 (params["merge_conv"], model.merge_w, model.merge_b)]
        for p, w, b in convs:
            w.copy_(t(p["w"]).permute(2, 1, 0))
            b.copy_(t(p["b"]))
        for name, layer in zip(("lstm1", "lstm2"), model.lstms):
            for key in ("w_ih", "w_hh", "b_ih", "b_hh"):
                getattr(layer, key).copy_(t(params[name][key]))
        model.fc_w.copy_(t(params["fc"]["w"]))
        model.fc_b.copy_(t(params["fc"]["b"]))
    return model


# the conv weights' file names, in _convs_of's order
_CONV_FILES = ("sig_conv1", "sig_conv2", "sig_conv3", "seq_conv1", "seq_conv2", "merge_conv1")


def _convs_of(model: ModBaseConvLSTM):
    return [*zip(model.sig_w, model.sig_b), *zip(model.seq_w, model.seq_b),
            (model.merge_w, model.merge_b)]


def load_modbase_params(config: ModBaseModelConfig) -> ModBaseConvLSTM:
    """The float32 CPU model of a modbase model directory."""
    d = Path(config.model_path)
    model = ModBaseConvLSTM(config, device="cpu")

    def load(name):
        return load_tensor(d / f"{name}.tensor").float()

    with torch.no_grad():
        for name, (w, b) in zip(_CONV_FILES, _convs_of(model)):
            w.copy_(load(f"{name}.weight"))
            b.copy_(load(f"{name}.bias"))
        for name, layer in zip(("lstm1", "lstm2"), model.lstms):
            layer.w_ih.copy_(load(f"{name}.weight_ih_l0"))
            layer.w_hh.copy_(load(f"{name}.weight_hh_l0"))
            layer.b_ih.copy_(load(f"{name}.bias_ih_l0"))
            layer.b_hh.copy_(load(f"{name}.bias_hh_l0"))
        model.fc_w.copy_(load("fc.weight"))
        model.fc_b.copy_(load("fc.bias"))
    return model


def load_refine_levels(config: ModBaseModelConfig) -> np.ndarray | None:
    path = Path(config.model_path) / "refine_kmer_levels.tensor"
    if not config.refine.do_rough_rescale or not path.exists():
        return None
    return load_tensor(path).float().numpy()


def save_modbase_params(model: ModBaseConvLSTM, path: Path | str) -> None:
    """Write a model's weights in the dorado modbase on-disk layout."""
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)

    def save(name, t):
        save_tensor_file(d / f"{name}.tensor", [t.detach().float().cpu().contiguous()])

    for name, (w, b) in zip(_CONV_FILES, _convs_of(model)):
        save(f"{name}.weight", w)
        save(f"{name}.bias", b)
    for name, layer in zip(("lstm1", "lstm2"), model.lstms):
        save(f"{name}.weight_ih_l0", layer.w_ih)
        save(f"{name}.weight_hh_l0", layer.w_hh)
        save(f"{name}.bias_ih_l0", layer.b_ih)
        save(f"{name}.bias_hh_l0", layer.b_hh)
    save("fc.weight", model.fc_w)
    save("fc.bias", model.fc_b)


def save_modbase_model(
    config: ModBaseModelConfig, model: ModBaseConvLSTM, path: Path | str,
    refine_levels: np.ndarray | None = None,
) -> Path:
    """Write ``model``, its ``config.toml`` and, for a model that rescales,
    its kmer levels (``refine_kmer_levels.tensor``) as a modbase model
    directory at ``path``."""
    from dorado_tpu_torch.models.presets import modbase_config_toml

    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.toml").write_text(modbase_config_toml(config))
    save_modbase_params(model, d)
    if refine_levels is not None:
        save_tensor_file(d / "refine_kmer_levels.tensor",
                         [torch.from_numpy(np.asarray(refine_levels, dtype=np.float32))])
    return d
