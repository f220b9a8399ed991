"""The read-level polishing model and the model zoo's factory.

Port of the parts of ``dorado_tpu/secondary/architectures.py`` that the
polish models use: the primitives (``linear``, ``embedding``,
``conv1d_same``, ``batch_norm1d`` in eval form, ``read_level_conv``,
``_scaled_feature``, ``_mean_pool``), ``LatentSpaceLSTM``
(model_latent_space_lstm.cpp:122-281) as an ``nn.Module``, ``model_factory``
for ``GRUModel`` and ``LatentSpaceLSTM``, and ``parse_model_config``.
``SlotAttentionConsensus`` and ``VariantPerceiver`` (the variant models) are
not ported yet: ``model_factory`` refuses them by name.

The LSTM's two bidirectional layers run the input projection as one product
with both biases, then the recurrence through
``ops.lstm.lstm_scan_time_major``: K1 float32 on a CUDA float32 tensor, its
plain version on the CPU. The JAX model flips the projected input for the
reverse direction and flips the output back; K1's ``reverse`` walks the
unflipped sequence from its last step, each output at its own step. Every
other operation is per step, so the values are the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dorado_tpu_torch.ops.lstm import lstm_scan_time_major
from dorado_tpu_torch.secondary.model import GRUModel, float32_products, init_gru_model

DEFAULT_FEATURE_COLUMNS = {
    "base": 0,
    "qual": 1,
    "strand": 2,
    "mapq": 3,
    "dwell": 4,
    "haplotag": 5,
    "snp_qv": 6,
}

NOT_PORTED = ("SlotAttentionConsensus", "VariantPerceiver")

# ---------------------------------------------------------------------------
# shared building blocks
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.t()
    return y + b if b is not None else y


def embedding(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``w`` at ``idx``, a float tensor of whole numbers cast to int
    as the JAX ``embedding`` casts it (toward zero)."""
    return w[idx.to(torch.int32)]


def conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [N, C, L] -> [N, C_out, L], symmetric same padding (odd k)."""
    k = w.shape[-1]
    return F.conv1d(x, w, padding=(k - 1) // 2) + b[None, :, None]


def batch_norm1d(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm1d over [N, C, L] (running stats), in the
    JAX package's order of operations."""
    inv = torch.rsqrt(var + eps)
    return (x - mean[None, :, None]) * (inv * g)[None, :, None] + b[None, :, None]


class ConvBlock(nn.Module):
    """Conv1d -> ReLU -> BatchNorm1d (model_latent_space_lstm.cpp:17-57)."""

    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__()
        if k % 2 == 0:
            raise ValueError("Kernel sizes must be odd for symmetric padding")
        self.conv = nn.Conv1d(in_ch, out_ch, k, padding=(k - 1) // 2)
        self.bn = nn.BatchNorm1d(out_ch)


def read_level_conv(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        bn = layer.bn
        x = batch_norm1d(F.relu(conv1d_same(x, layer.conv.weight, layer.conv.bias)), bn.weight,
                         bn.bias, bn.running_mean, bn.running_var, bn.eps)
    return x


def _scaled_feature(x: torch.Tensor, column: int) -> torch.Tensor:
    return (x[..., column] / 25.0 - 1.0)[..., None]


def _mean_pool(x: torch.Tensor, non_empty_mask: torch.Tensor) -> torch.Tensor:
    """MeanPoolerImpl (model_latent_space_lstm.cpp:92-97): x [b, d, p, C],
    mask [b, d] -> [b, p, C]: masked, summed over the reads, divided by the
    count of non-empty reads (the JAX order)."""
    depths = non_empty_mask.sum(-1)[:, None, None]
    return (x * non_empty_mask[:, :, None, None]).sum(1) / depths


class BidirLSTM(nn.Module):
    """``num_layers`` bidirectional LSTM layers over [N, T, C] (gate order i,
    f, g, o), their weights named as ``nn.LSTM`` names them; each direction
    runs through ``lstm_scan_time_major``."""

    def __init__(self, input_size: int, hidden: int, num_layers: int):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        in_size = input_size
        for layer in range(num_layers):
            for sfx in ("", "_reverse"):
                for name, shape in (("weight_ih", (4 * hidden, in_size)),
                                    ("weight_hh", (4 * hidden, hidden)),
                                    ("bias_ih", (4 * hidden,)), ("bias_hh", (4 * hidden,))):
                    self.register_parameter(f"{name}_l{layer}{sfx}",
                                            nn.Parameter(torch.zeros(shape)))
            in_size = 2 * hidden

    def _direction(self, z: torch.Tensor, layer: int, reverse: bool) -> torch.Tensor:
        """[T, N, C] -> [T, N, H]: the input projection in one product with
        the biases' sum, then the recurrence (``reverse``: walked from the
        last step, each output at its own step)."""
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        w_ih, w_hh = getattr(self, f"weight_ih{sfx}"), getattr(self, f"weight_hh{sfx}")
        bias = getattr(self, f"bias_ih{sfx}") + getattr(self, f"bias_hh{sfx}")
        xproj = torch.matmul(z, w_ih.t()) + bias
        return lstm_scan_time_major(xproj.contiguous(), w_hh.t().contiguous(), reverse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = x.transpose(0, 1)  # [T, N, C]
        for layer in range(self.num_layers):
            z = torch.cat([self._direction(z, layer, False), self._direction(z, layer, True)],
                          dim=-1)
        return z.transpose(0, 1)


# ---------------------------------------------------------------------------
# LatentSpaceLSTM
# ---------------------------------------------------------------------------


@dataclass
class LatentSpaceLSTMConfig:
    num_classes: int = 5
    lstm_size: int = 128
    cnn_size: int = 128
    kernel_sizes: tuple = (1, 17)
    pooler_type: str = "mean"
    use_dwells: bool = False
    bases_alphabet_size: int = 6
    bases_embedding_size: int = 6
    bidirectional: bool = True
    feature_columns: dict = field(default_factory=lambda: dict(DEFAULT_FEATURE_COLUMNS))


class LatentSpaceLSTM(nn.Module):
    """x [b, p, d, f] read-level features -> logits [b, p, num_classes]
    (model_latent_space_lstm.cpp:209-281): base and strand embeddings plus
    the scaled qual (and the dwell), a per-read conv stack over positions,
    an expansion to ``lstm_size``, the mean over non-empty reads, two
    bidirectional LSTM layers and a linear head. Weights are zero until
    loaded (``init_latent_space_lstm``, ``latent_space_lstm_state_dict``)."""

    def __init__(self, config: LatentSpaceLSTMConfig):
        super().__init__()
        if not config.bidirectional:
            raise NotImplementedError(
                "unidirectional ReversibleLSTM stack: not used by released models")
        self.config = config
        cfg = config
        self.base_embedder = nn.Embedding(cfg.bases_alphabet_size, cfg.bases_embedding_size)
        self.strand_embedder = nn.Embedding(3, cfg.bases_embedding_size)
        in_ch = cfg.bases_embedding_size + (2 if cfg.use_dwells else 1)
        blocks = []
        for k in cfg.kernel_sizes:
            blocks.append(ConvBlock(in_ch, cfg.cnn_size, k))
            in_ch = cfg.cnn_size
        self.read_level_conv = nn.ModuleList(blocks)
        self.pre_pool_expansion_layer = nn.Linear(cfg.cnn_size, cfg.lstm_size)
        self.lstm = BidirLSTM(cfg.lstm_size, cfg.lstm_size, 2)
        self.linear = nn.Linear(2 * cfg.lstm_size, cfg.num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with float32_products(x):
            cfg = self.config
            cols = cfg.feature_columns
            non_empty = x.sum(dim=(1, -1)) != 0  # [b, d]
            emb = embedding(self.base_embedder.weight, x[..., cols["base"]])
            emb = emb + embedding(self.strand_embedder.weight, x[..., cols["strand"]] + 1)
            feats = [emb, _scaled_feature(x, cols["qual"])]
            if cfg.use_dwells:
                feats.append(x[..., cols["dwell"]][..., None])
            h = torch.cat(feats, dim=-1)  # [b, p, d, C]
            h = h.permute(0, 2, 3, 1)  # [b, d, C, p]
            b, d, c, p = h.shape
            h = read_level_conv(self.read_level_conv, h.reshape(b * d, c, p))
            h = h.transpose(1, 2)  # [b*d, p, cnn]
            ex = self.pre_pool_expansion_layer
            h = linear(h, ex.weight, ex.bias).reshape(b, d, p, cfg.lstm_size)
            h = _mean_pool(h, non_empty)  # [b, p, lstm]
            h = self.lstm(h)
            return linear(h, self.linear.weight, self.linear.bias)


def init_latent_space_lstm(cfg: LatentSpaceLSTMConfig, generator: torch.Generator,
                           ) -> LatentSpaceLSTM:
    """A LatentSpaceLSTM with weights drawn from ``generator`` with the JAX
    package's distributions (``init_latent_space_lstm``: embeddings normal,
    convs uniform in ±1/sqrt(fan-in), batch norms at their identity, linear
    layers and LSTM gates uniform in ±1/sqrt(fan-in) and ±1/sqrt(H)); the
    numbers differ, the two frameworks' generators differ."""
    model = LatentSpaceLSTM(cfg)

    def uniform(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * bound)

    with torch.no_grad():
        for emb in (model.base_embedder, model.strand_embedder):
            emb.weight.copy_(torch.randn(emb.weight.shape, generator=generator))
        for block in model.read_level_conv:
            w = block.conv.weight
            s = 1.0 / np.sqrt(w.shape[1] * w.shape[2])
            uniform(w, s)
            uniform(block.conv.bias, s)
        for lin in (model.pre_pool_expansion_layer, model.linear):
            s = 1.0 / np.sqrt(lin.weight.shape[1])
            uniform(lin.weight, s)
            uniform(lin.bias, s)
        for p in model.lstm.parameters():
            uniform(p, 1.0 / np.sqrt(cfg.lstm_size))
    return model.eval()


def latent_space_lstm_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX package's LatentSpaceLSTM params (``init_latent_space_lstm``'s
    pytree, its arrays as numpy), batch-norm running stats included -> a
    LatentSpaceLSTM state dict."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    out = {
        "base_embedder.weight": t(params["base_embedder"]["w"]),
        "strand_embedder.weight": t(params["strand_embedder"]["w"]),
    }
    for i, layer in enumerate(params["read_level_conv"]["layers"]):
        pre = f"read_level_conv.{i}"
        out[f"{pre}.conv.weight"] = t(layer["conv"]["w"])
        out[f"{pre}.conv.bias"] = t(layer["conv"]["b"])
        for ours, theirs in (("weight", "g"), ("bias", "b"), ("running_mean", "mean"),
                             ("running_var", "var")):
            out[f"{pre}.bn.{ours}"] = t(layer["bn"][theirs])
        out[f"{pre}.bn.num_batches_tracked"] = torch.tensor(0)
    for name in ("pre_pool_expansion_layer", "linear"):
        out[f"{name}.weight"] = t(params[name]["w"])
        out[f"{name}.bias"] = t(params[name]["b"])
    for layer, entry in enumerate(params["lstm"]["layers"]):
        for key, sfx in (("fwd", ""), ("rev", "_reverse")):
            for ours, theirs in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                 ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                out[f"lstm.{ours}_l{layer}{sfx}"] = t(entry[key][theirs])
    return out


# ---------------------------------------------------------------------------
# factory and model directories
# ---------------------------------------------------------------------------


def _flag(kwargs: dict, name: str, default: bool = False) -> bool:
    v = kwargs.get(name, default)
    return v == "true" if isinstance(v, str) else bool(v)


def latent_space_lstm_config(kwargs: dict) -> LatentSpaceLSTMConfig:
    """A config.toml's ``[model.kwargs]`` -> LatentSpaceLSTMConfig, as the
    JAX ``model_factory`` reads them."""
    kernel_sizes = kwargs.get("kernel_sizes", (1, 17))
    if isinstance(kernel_sizes, str):
        kernel_sizes = tuple(int(v) for v in kernel_sizes.split(","))
    return LatentSpaceLSTMConfig(
        num_classes=int(kwargs["num_classes"]),
        lstm_size=int(kwargs["lstm_size"]),
        cnn_size=int(kwargs["cnn_size"]),
        kernel_sizes=tuple(kernel_sizes),
        pooler_type=kwargs.get("pooler_type", "mean"),
        use_dwells=_flag(kwargs, "use_dwells"),
        bases_alphabet_size=int(kwargs.get("bases_alphabet_size", 6)),
        bases_embedding_size=int(kwargs.get("bases_embedding_size", 6)),
        bidirectional=_flag(kwargs, "bidirectional", True),
    )


def model_factory(model_type: str, kwargs: dict, generator: torch.Generator | None = None,
                  ) -> nn.Module:
    """A model of ``model_type`` with the config's ``kwargs``, its weights
    drawn from ``generator`` (seed 0 unless given). Raises ValueError for
    the variant models, which are not ported yet, and for unknown types."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    if model_type == "GRUModel":
        return init_gru_model(
            generator,
            num_features=int(kwargs["num_features"]),
            num_classes=int(kwargs["num_classes"]),
            gru_size=int(kwargs["gru_size"]),
            n_layers=int(kwargs["n_layers"]),
            bidirectional=_flag(kwargs, "bidirectional", True),
        )
    if model_type == "LatentSpaceLSTM":
        return init_latent_space_lstm(latent_space_lstm_config(kwargs), generator)
    if model_type in NOT_PORTED:
        raise ValueError(f"Model type {model_type!r} is not yet ported to dorado_tpu_torch "
                         f"(SlotAttentionConsensus and VariantPerceiver come with the variant "
                         f"models); the port runs GRUModel and LatentSpaceLSTM")
    raise ValueError(f"Unknown model type: {model_type!r}")


def parse_model_config(config_path):
    """Parse a polish/variant model-directory config.toml
    (secondary/architectures/model_config.cpp:94-180): [model] type+kwargs,
    [feature_encoder] type+kwargs, label_scheme, config_version, supported
    basecallers. Sections beyond [model] are optional here so hand-written
    test configs stay valid."""
    import tomllib
    from pathlib import Path

    with open(config_path, "rb") as fh:
        config = tomllib.load(fh)
    if "model" not in config:
        raise ValueError("Model config must include the [model] section.")
    model = config["model"]
    out = {
        "version": config.get("config_version", 1),
        "model_type": model["type"],
        "model_kwargs": model.get("kwargs", {}),
        "model_dir": str(Path(config_path).parent),
        "feature_encoder_type": "",
        "feature_encoder_kwargs": {},
        "label_scheme_type": "",
        "supported_basecallers": set(),
    }
    if "basecaller_model" in config:
        out["supported_basecallers"].add(config["basecaller_model"])
    for name in config.get("supported_basecallers", []):
        out["supported_basecallers"].add(name)
    if "feature_encoder" in config:
        fe = config["feature_encoder"]
        out["feature_encoder_type"] = fe.get("type", "")
        out["feature_encoder_kwargs"] = fe.get("kwargs", {})
    if "label_scheme" in config:
        ls = config["label_scheme"]
        out["label_scheme_type"] = ls.get("type", "") if isinstance(ls, dict) else str(ls)
    return out


__all__ = [
    "GRUModel", "LatentSpaceLSTM", "LatentSpaceLSTMConfig", "model_factory",
    "parse_model_config", "init_latent_space_lstm", "latent_space_lstm_state_dict",
]
