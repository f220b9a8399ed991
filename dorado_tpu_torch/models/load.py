"""Load and write dorado model directories.

Port of ``dorado_tpu/models/load.py``. Weight-file naming follows the
reference (dorado/basecall/crf_utils.cpp:26-150): each weight lives in its
own ``<layer>.<name>.tensor`` archive. LSTM models index layers as
``{conv_idx}`` / ``{n_convs + lstm_idx + 1}`` / ``{n_convs + n_lstms + 1}``;
transformer models use ``conv.{i}`` / ``transformer_encoder.{i}`` /
``upsample`` / ``crf`` prefixes.

The loaders return the JAX package's parameter pytree as numpy arrays (conv
weights [K, C_in, C_out], LSTM weights [4H, C], linear weights [out, in]),
the layout ``params_from_jax`` and ``tx_params_from_jax`` take; a bf16
weight comes back as float32, which holds it exactly. ``build_model`` makes
the model from them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dorado_tpu_torch.config import BasecallModelConfig, load_model_config
from dorado_tpu_torch.io.tensor_file import load_tensor as _load_tensor
from dorado_tpu_torch.io.tensor_file import save_tensor_file

Params = dict


def load_tensor(path: Path) -> np.ndarray:
    t = _load_tensor(path)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _conv_in(w: np.ndarray) -> np.ndarray:
    """torch conv weight [C_out, C_in, K] -> [K, C_in, C_out]."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def load_lstm_params(config: BasecallModelConfig) -> Params:
    """The conv + LSTM CRF parameter pytree of a model directory."""
    if config.is_flstm_model:
        raise ValueError(
            f"{config.model_path}: a factorised-LSTM (FLSTM) model; "
            "LSTMCRFModel supports conv + LSTM CRF models only"
        )
    d = Path(config.model_path)
    params: Params = {"convs": [], "lstms": []}
    for i in range(len(config.convs)):
        params["convs"].append({
            "w": _conv_in(load_tensor(d / f"{i}.conv.weight.tensor")),
            "b": load_tensor(d / f"{i}.conv.bias.tensor"),
        })
    n_convs = len(config.convs)
    for l in range(config.lstm_layers):
        layer = n_convs + l + 1  # the reference skips one index for its permute layer
        params["lstms"].append({
            "w_ih": load_tensor(d / f"{layer}.rnn.weight_ih_l0.tensor"),
            "w_hh": load_tensor(d / f"{layer}.rnn.weight_hh_l0.tensor"),
            "b_ih": load_tensor(d / f"{layer}.rnn.bias_ih_l0.tensor"),
            "b_hh": load_tensor(d / f"{layer}.rnn.bias_hh_l0.tensor"),
        })
    layer = n_convs + config.lstm_layers + 1
    params["linear1"] = {"w": load_tensor(d / f"{layer}.linear.weight.tensor")}
    if config.bias:
        params["linear1"]["b"] = load_tensor(d / f"{layer}.linear.bias.tensor")
    if config.out_features is not None:
        params["linear2"] = {"w": load_tensor(d / f"{layer + 1}.linear.weight.tensor")}
    return params


def load_tx_params(config: BasecallModelConfig) -> Params:
    """The transformer (sup) parameter pytree of a model directory."""
    d = Path(config.model_path)
    params: Params = {"convs": [], "layers": []}
    for i in range(len(config.convs)):
        params["convs"].append({
            "w": _conv_in(load_tensor(d / f"conv.{i}.conv.weight.tensor")),
            "b": load_tensor(d / f"conv.{i}.conv.bias.tensor"),
        })
    for i in range(config.tx.tx.depth):
        p = f"transformer_encoder.{i}"
        params["layers"].append({
            "wqkv": load_tensor(d / f"{p}.self_attn.Wqkv.weight.tensor"),
            "out_proj_w": load_tensor(d / f"{p}.self_attn.out_proj.weight.tensor"),
            "out_proj_b": load_tensor(d / f"{p}.self_attn.out_proj.bias.tensor"),
            "fc1": load_tensor(d / f"{p}.ff.fc1.weight.tensor"),
            "fc2": load_tensor(d / f"{p}.ff.fc2.weight.tensor"),
            "norm1": load_tensor(d / f"{p}.norm1.weight.tensor"),
            "norm2": load_tensor(d / f"{p}.norm2.weight.tensor"),
        })
    params["upsample"] = {
        "w": load_tensor(d / "upsample.linear.weight.tensor"),
        "b": load_tensor(d / "upsample.linear.bias.tensor"),
    }
    params["crf"] = {"w": load_tensor(d / "crf.linear.weight.tensor")}
    return params


def load_model(path: Path | str) -> tuple[BasecallModelConfig, Params]:
    """Parse config.toml and load every weight of a model directory."""
    config = load_model_config(path)
    if config.is_tx_model:
        return config, load_tx_params(config)
    return config, load_lstm_params(config)


def build_model(config: BasecallModelConfig, params: Params):
    """The float32 CPU model of a parameter pytree: ``LSTMCRFModel`` or
    ``TxModel`` (the runner moves its own copy to the card)."""
    if config.is_tx_model:
        from dorado_tpu_torch.models.tx_model import tx_params_from_jax

        return tx_params_from_jax(params, config)
    from dorado_tpu_torch.models.crf_model import params_from_jax

    return params_from_jax(params, config)


def model_params(model) -> Params:
    """The parameter pytree of an unquantised ``LSTMCRFModel`` or ``TxModel``
    (the inverse of ``build_model``), as float32 numpy arrays."""

    def n(t):
        return t.detach().float().cpu().numpy()

    convs = [{"w": _conv_in(n(w)), "b": n(b)} for w, b in zip(model.conv_w, model.conv_b)]
    if model.config.is_tx_model:
        if model.precision != "float":
            raise ValueError(f"model_params needs an unquantised model, not {model.precision}")
        names = ("wqkv", "out_proj_w", "out_proj_b", "fc1", "fc2", "norm1", "norm2")
        return {
            "convs": convs,
            "layers": [{k: n(getattr(layer, k)) for k in names} for layer in model.layers],
            "upsample": {"w": n(model.upsample_w), "b": n(model.upsample_b)},
            "crf": {"w": n(model.crf_w)},
        }
    if any(getattr(layer, "w_ih", None) is None for layer in model.lstms):
        raise ValueError("model_params needs an unquantised model")
    params = {
        "convs": convs,
        "lstms": [{k: n(getattr(layer, k)) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
                  for layer in model.lstms],
        "linear1": {"w": n(model.linear1_w)},
    }
    if model.linear1_b is not None and model.config.bias:
        params["linear1"]["b"] = n(model.linear1_b)
    if model.linear2_w is not None:
        params["linear2"] = {"w": n(model.linear2_w)}
    return params


def save_model(config: BasecallModelConfig, model, path: Path | str) -> Path:
    """Write ``model`` and its ``config.toml`` as a model directory at
    ``path`` (named after the model, as ``config.model_name`` is)."""
    from dorado_tpu_torch.models.presets import config_toml

    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.toml").write_text(config_toml(config))
    save = save_tx_params if config.is_tx_model else save_lstm_params
    save(config, model_params(model), d)
    return d


# ---------------------------------------------------------------------------
# Export: a parameter pytree written back out as a dorado-layout directory
# ---------------------------------------------------------------------------


def _t(x) -> torch.Tensor:
    """A weight as a CPU tensor (numpy arrays and tensors of any dtype)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def _conv_out(w) -> torch.Tensor:
    """[K, C_in, C_out] -> the torch conv layout [C_out, C_in, K]."""
    return _t(w).permute(2, 1, 0).contiguous()


def save_lstm_params(config: BasecallModelConfig, params: Params, path: Path | str) -> None:
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    for i, cv in enumerate(params["convs"]):
        save_tensor_file(d / f"{i}.conv.weight.tensor", [_conv_out(cv["w"])])
        save_tensor_file(d / f"{i}.conv.bias.tensor", [_t(cv["b"])])
    n_convs = len(params["convs"])
    for l, p in enumerate(params["lstms"]):
        layer = n_convs + l + 1
        for fname, key in (
            ("weight_ih_l0", "w_ih"),
            ("weight_hh_l0", "w_hh"),
            ("bias_ih_l0", "b_ih"),
            ("bias_hh_l0", "b_hh"),
        ):
            save_tensor_file(d / f"{layer}.rnn.{fname}.tensor", [_t(p[key])])
    layer = n_convs + len(params["lstms"]) + 1
    save_tensor_file(d / f"{layer}.linear.weight.tensor", [_t(params["linear1"]["w"])])
    if "b" in params["linear1"]:
        save_tensor_file(d / f"{layer}.linear.bias.tensor", [_t(params["linear1"]["b"])])
    if "linear2" in params:
        save_tensor_file(d / f"{layer + 1}.linear.weight.tensor", [_t(params["linear2"]["w"])])


def save_tx_params(config: BasecallModelConfig, params: Params, path: Path | str) -> None:
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    for i, cv in enumerate(params["convs"]):
        save_tensor_file(d / f"conv.{i}.conv.weight.tensor", [_conv_out(cv["w"])])
        save_tensor_file(d / f"conv.{i}.conv.bias.tensor", [_t(cv["b"])])
    for i, lp in enumerate(params["layers"]):
        p = f"transformer_encoder.{i}"
        for fname, key in (
            ("self_attn.Wqkv.weight", "wqkv"),
            ("self_attn.out_proj.weight", "out_proj_w"),
            ("self_attn.out_proj.bias", "out_proj_b"),
            ("ff.fc1.weight", "fc1"),
            ("ff.fc2.weight", "fc2"),
            ("norm1.weight", "norm1"),
            ("norm2.weight", "norm2"),
        ):
            save_tensor_file(d / f"{p}.{fname}.tensor", [_t(lp[key])])
    save_tensor_file(d / "upsample.linear.weight.tensor", [_t(params["upsample"]["w"])])
    save_tensor_file(d / "upsample.linear.bias.tensor", [_t(params["upsample"]["b"])])
    save_tensor_file(d / "crf.linear.weight.tensor", [_t(params["crf"]["w"])])
