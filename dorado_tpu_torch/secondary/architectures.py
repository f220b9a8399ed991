"""The read-level polishing and variant models and the model zoo's factory.

Port of ``dorado_tpu/secondary/architectures.py``: the primitives
(``linear``, ``embedding``, ``conv1d_same``, ``batch_norm1d`` in eval form,
``read_level_conv``, ``_scaled_feature``, ``_mean_pool``, ``layer_norm``,
``rms_norm``, ``gru_cell``, ``swiglu``, ``_rope_pair``),
``LatentSpaceLSTM`` (model_latent_space_lstm.cpp:122-281),
``SlotAttentionConsensus`` (model_slot_attention_consensus.cpp:17-463) with
its host phasing pass ``batch_adjacency_phase``, ``VariantPerceiver``
(model_variant_perceiver.cpp:29-675), ``model_factory`` for the four model
types and ``parse_model_config``.

Every LSTM (the LatentSpaceLSTM's two bidirectional layers, the slot
model's four alternating directions, the perceiver's decoder) runs the
input projection as one product with both biases, then the recurrence
through ``ops.lstm.lstm_scan_time_major``: K1 float32 on a CUDA float32
tensor, its plain version on the CPU. The JAX model flips the projected
input for the reverse direction and flips the output back; K1's
``reverse`` walks the unflipped sequence from its last step, each output at
its own step. Every other operation is per step, so the values are the
same.

The perceiver's attention runs over every (sequence, position) token of a
window with no mask: at a default window (about 2e4 columns, 100 reads)
that is 2e6 keys for 2e4 queries, whose logits (160 GB a head) the JAX
package materialises. Here it is ``F.scaled_dot_product_attention``, on the
card pinned to the memory-efficient backend, which does not materialise
them and raises where it cannot take a shape.
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


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5,
               ) -> torch.Tensor:
    """LayerNorm over the last axis, in the JAX package's order of
    operations (the mean, the biased variance, then the affine)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """nn/RMSNorm.cpp:14-18."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def gru_cell(cell: nn.GRUCell, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One step of ``cell``'s weights (torch GRUCell gate order r, z, n,
    ``b_hn`` inside ``r *``), written out as the JAX ``gru_cell``."""
    xr, xz, xn = linear(x, cell.weight_ih, cell.bias_ih).chunk(3, dim=-1)
    hr, hz, hn = linear(h, cell.weight_hh, cell.bias_hh).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


class SwiGLU(nn.Module):
    """model_variant_perceiver.cpp:29-48: fc1 -> (y, gate); fc2 of
    silu(gate) * y; no biases (the perceiver's)."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 2 * hidden_features, bias=False)
        self.fc2 = nn.Linear(hidden_features, in_features, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, gate = linear(x, self.fc1.weight).chunk(2, dim=-1)
        return linear(F.silu(gate) * y, self.fc2.weight)


class RMSNorm(nn.Module):
    """nn/RMSNorm.cpp: ``rms_norm`` with its weight."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)


def _rope_pair(q: torch.Tensor, k: torch.Tensor, theta: float = 10000.0):
    """RotaryEmbeddingImpl::forward (model_variant_perceiver.cpp:50-127):
    q/k [N, T, S, H, D], rotated over the position axis T (each sequence's
    positions from 0), non-interleaved halves."""
    d, t = q.shape[-1], q.shape[1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=q.device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)  # [T, D]
    cos = torch.cos(emb)[None, :, None, None, :]
    sin = torch.sin(emb)[None, :, None, None, :]

    def rotate_half(x):
        a, b = x.chunk(2, dim=-1)
        return torch.cat([-b, a], dim=-1)

    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def lstm_direction(z: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                   b_ih: torch.Tensor, b_hh: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One LSTM direction over [T, N, C] -> [T, N, H] (gate order i, f, g,
    o): the input projection in one product with the biases' sum, then the
    recurrence (``reverse``: walked from the last step, each output at its
    own step)."""
    xproj = torch.matmul(z, w_ih.t()) + (b_ih + b_hh)
    return lstm_scan_time_major(xproj.contiguous(), w_hh.t().contiguous(), reverse)


class LSTMDirection(nn.Module):
    """One direction of an LSTM layer, its weights named as ``nn.LSTM``
    names them without the layer suffix."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        for name, shape in (("weight_ih", (4 * hidden, input_size)),
                            ("weight_hh", (4 * hidden, hidden)),
                            ("bias_ih", (4 * hidden,)), ("bias_hh", (4 * hidden,))):
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def forward(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """[N, T, C] -> [N, T, H]."""
        return lstm_direction(x.transpose(0, 1), self.weight_ih, self.weight_hh, self.bias_ih,
                              self.bias_hh, reverse).transpose(0, 1)


def _read_features(model: nn.Module, cfg, x: torch.Tensor) -> torch.Tensor:
    """The variant models' per-read input [b, p, d, f] -> the read-level
    conv stack's output [b, p, d, cnn]: the base, strand (and haplotag)
    embeddings summed, the scaled qual (mapq, dwell, snp_qv) beside them,
    convolved over positions read by read."""
    cols = cfg.feature_columns
    emb = embedding(model.base_embedder.weight, x[..., cols["base"]])
    emb = emb + embedding(model.strand_embedder.weight, x[..., cols["strand"]] + 1)
    if cfg.use_haplotags:
        emb = emb + embedding(model.haplotag_embedder.weight, x[..., cols["haplotag"]])
    feats = [emb, _scaled_feature(x, cols["qual"])]
    if cfg.use_mapqc:
        feats.append(_scaled_feature(x, cols["mapq"]))
    if cfg.use_dwells:
        feats.append(x[..., cols["dwell"]][..., None])
    if cfg.use_snp_qv:
        feats.append(_scaled_feature(x, cols["snp_qv"]))
    h = torch.cat(feats, dim=-1).permute(0, 2, 3, 1)  # [b, d, C, p]
    b, d, c, p = h.shape
    h = read_level_conv(model.read_level_conv, h.reshape(b * d, c, p))
    return h.reshape(b, d, -1, p).permute(0, 3, 1, 2)  # [b, p, d, cnn]


def _variant_input_layers(model: nn.Module, cfg) -> None:
    """The embeddings and the conv stack both variant models start with."""
    model.base_embedder = nn.Embedding(cfg.bases_alphabet_size, cfg.bases_embedding_size)
    model.haplotag_embedder = nn.Embedding(cfg.MAX_HAPLOTAGS + 1, cfg.bases_embedding_size)
    model.strand_embedder = nn.Embedding(3, cfg.bases_embedding_size)
    in_ch = cfg.bases_embedding_size + 1 + cfg.use_dwells + cfg.use_mapqc + cfg.use_snp_qv
    blocks = []
    for k in cfg.kernel_sizes:
        blocks.append(ConvBlock(in_ch, cfg.cnn_size, k))
        in_ch = cfg.cnn_size
    model.read_level_conv = nn.ModuleList(blocks)


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
        """[T, N, C] -> [T, N, H]."""
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        return lstm_direction(z, *(getattr(self, f"{name}{sfx}") for name in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh")), reverse)

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


# ---------------------------------------------------------------------------
# SlotAttentionConsensus
# ---------------------------------------------------------------------------


@dataclass
class SlotAttentionConfig:
    num_slots: int = 2
    classes_per_slot: int = 5
    read_embedding_size: int = 128
    cnn_size: int = 128
    kernel_sizes: tuple = (1, 17)
    pooler_type: str = "mean"
    use_mapqc: bool = False
    use_dwells: bool = False
    use_haplotags: bool = False
    use_snp_qv: bool = False
    bases_alphabet_size: int = 6
    bases_embedding_size: int = 6
    add_lstm: bool = False
    use_reference: bool = False
    sa_iters: int = 3
    sa_epsilon: float = 1e-8
    sa_hidden_dim: int = 128
    feature_columns: dict = field(default_factory=lambda: dict(DEFAULT_FEATURE_COLUMNS))

    MAX_HAPLOTAGS = 16


def fixed_slot_noise(num_slots: int, dim: int) -> np.ndarray:
    """The slot block's fixed noise as the JAX package draws it (a
    registered parameter, shipped inside trained checkpoints:
    model_slot_attention_consensus.cpp:53-69)."""
    return np.random.RandomState(42).standard_normal((1, num_slots, dim)).astype(np.float32)


class SlotAttention(nn.Module):
    """SlotAttentionImpl (model_slot_attention_consensus.cpp:17-146)."""

    def __init__(self, num_slots: int, dim: int, hidden_dim: int):
        super().__init__()
        hidden_dim = max(dim, hidden_dim)
        self.num_slots = num_slots
        self.slots_mu = nn.Parameter(torch.zeros(1, 1, dim))
        self.slots_logsigma = nn.Parameter(torch.zeros(1, 1, dim))
        self.fixed_noise = nn.Parameter(torch.from_numpy(fixed_slot_noise(num_slots, dim)))
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.gru = nn.GRUCell(dim, dim)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(dim, hidden_dim),
                                  "fc2": nn.Linear(hidden_dim, dim)})
        self.norm_input = nn.LayerNorm(dim)
        self.norm_slots = nn.LayerNorm(dim)
        self.norm_pre_ff = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, iters: int = 3,
                epsilon: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B, n, d]; mask [B, n], True at an empty read -> (slots [B, S,
        d], attn [B, S, n]). The softmax runs over the slots; masked reads
        are zeroed after it and each slot's row is divided by its NaN-ignoring
        sum, which is 0/0 (NaN) where every read is masked."""
        b, n, d = x.shape
        s = self.num_slots
        scale = d ** -0.5
        mask3 = mask[:, None, :].expand(b, s, n)
        bias = torch.zeros(mask3.shape, dtype=x.dtype, device=x.device).masked_fill(
            mask3, float("-inf"))
        slots = self.slots_mu + torch.exp(self.slots_logsigma) * self.fixed_noise
        slots = slots.expand(b, s, d)

        def ln(norm, v):
            return layer_norm(v, norm.weight, norm.bias, norm.eps)

        x = ln(self.norm_input, x)
        k = linear(x, self.to_k.weight, self.to_k.bias)
        v = linear(x, self.to_v.weight, self.to_v.bias)
        attn = torch.zeros(b, s, n, dtype=x.dtype, device=x.device)
        fc1, fc2 = self.mlp["fc1"], self.mlp["fc2"]
        for _ in range(iters):
            slots_prev = slots
            q = linear(ln(self.norm_slots, slots), self.to_q.weight, self.to_q.bias)
            dots = torch.einsum("bsd,bnd->bsn", q, k) * scale + bias
            attn = torch.softmax(dots, dim=1) + epsilon
            attn = attn.masked_fill(mask3, 0.0)
            attn = attn / torch.nansum(attn, dim=-1, keepdim=True)
            updates = torch.einsum("bsn,bnd->bsd", attn, v)
            slots = gru_cell(self.gru, updates.reshape(-1, d),
                             slots_prev.reshape(-1, d)).reshape(b, s, d)
            ff = linear(F.relu(linear(ln(self.norm_pre_ff, slots), fc1.weight, fc1.bias)),
                        fc2.weight, fc2.bias)
            slots = slots + ff
        return slots, attn


class SlotAttentionConsensus(nn.Module):
    """x [b, p, d, f] read-level features -> per-slot class probabilities
    [b, p, slots, classes], phased (model_slot_attention_consensus.cpp:
    306-463 and ``batch_adjacency_phase``): the embeddings and the per-read
    conv stack, an expansion to ``read_embedding_size``, slot attention over
    each column's reads, with ``add_lstm`` four alternating one-direction
    LSTMs over the slots at ``num_slots * read_embedding_size`` (the first
    reversed) added back, a linear head and a softmax. Weights are zero
    until loaded (``init_slot_attention_consensus``,
    ``slot_attention_consensus_state_dict``) but for the fixed noise."""

    def __init__(self, config: SlotAttentionConfig):
        super().__init__()
        self.config = cfg = config
        _variant_input_layers(self, cfg)
        self.expansion_layer = nn.Linear(cfg.cnn_size, cfg.read_embedding_size)
        self.slot_attention = SlotAttention(cfg.num_slots, cfg.read_embedding_size,
                                            cfg.sa_hidden_dim)
        self.slot_classifier = nn.Linear(cfg.read_embedding_size, cfg.classes_per_slot)
        if cfg.add_lstm:
            size = cfg.num_slots * cfg.read_embedding_size
            self.lstm = nn.ModuleList(LSTMDirection(size, size) for _ in range(4))

    def forward_impl(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(unphased probabilities [b, p, slots, classes], attention [b, p,
        slots, d]) on ``x``'s device."""
        with float32_products(x):
            cfg = self.config
            h = _read_features(self, cfg, x)
            b, p, d = h.shape[:3]
            ex = self.expansion_layer
            h = linear(h.reshape(b * p, d, -1), ex.weight, ex.bias)
            empty = (x[..., cfg.feature_columns["base"]] == 0).reshape(b * p, d)
            slots, attn = self.slot_attention(h, empty, cfg.sa_iters, cfg.sa_epsilon)
            slots = slots.reshape(b, p, cfg.num_slots, -1)
            if cfg.add_lstm:
                # model_slot_attention_consensus.cpp:218-223: reverse = !(i % 2)
                z = slots.reshape(b, p, -1)
                for i, layer in enumerate(self.lstm):
                    z = layer(z, reverse=(i % 2 == 0))
                slots = slots + z.reshape(b, p, cfg.num_slots, -1)
            sc = self.slot_classifier
            out = torch.softmax(linear(slots, sc.weight, sc.bias), dim=-1)
            return out, attn.reshape(b, p, cfg.num_slots, d)

    def forward(self, x: torch.Tensor, phase: bool = True) -> torch.Tensor:
        """The probabilities, phased on the host (``batch_adjacency_phase``)
        unless ``phase`` is False, on ``x``'s device."""
        probs, _ = self.forward_impl(x)
        if not phase:
            return probs
        basecalls = x[..., self.config.feature_columns["base"]].detach().cpu().numpy()
        phased = batch_adjacency_phase(probs.detach().cpu().numpy(), basecalls, lookback=4)
        return torch.from_numpy(phased).to(x.device)


def batch_adjacency_phase(hap_probs: np.ndarray, basecalls: np.ndarray, lookback: int = 4,
                          ) -> np.ndarray:
    """Greedy haplotype phasing by local read support
    (model_slot_attention_consensus.cpp:235-304). Sequential over positions,
    so it runs on host numpy; inputs are the softmax outputs.

    hap_probs [b, p, n_haps(2), n_classes], basecalls [b, p, d]."""
    basecalls = basecalls.copy()
    basecalls[basecalls == 0] = -1  # remap padding
    basecalls[basecalls == 5] = 0  # remap deletions
    n_pos = basecalls.shape[1]
    probs = hap_probs.copy()
    preds = probs.argmax(-1)  # [b, p, haps]

    for pos in range(lookback, n_pos):
        window_preds = preds[:, pos - lookback:pos + 1]  # [b, L+1, haps]
        window_basecalls = basecalls[:, pos - lookback:pos + 1]  # [b, L+1, d]
        # transpose to [b, d, L+1] for comparisons against per-hap windows
        wb = np.swapaxes(window_basecalls, 1, 2)
        preds_flipped = window_preds.copy()
        preds_flipped[:, -1] = preds_flipped[:, -1, ::-1]

        def support(wp):
            s = 0
            for hap in range(wp.shape[-1]):
                s = s + ((wp[:, None, :, hap] == wb).all(-1)).sum(-1)
            return s

        unflip = support(window_preds)
        flip = support(preds_flipped)
        idx = np.nonzero(flip > unflip)[0]
        if len(idx):
            probs[idx, pos] = probs[idx, pos][:, ::-1]
            preds[idx, pos] = preds[idx, pos][:, ::-1]
    return probs


# ---------------------------------------------------------------------------
# VariantPerceiver
# ---------------------------------------------------------------------------


@dataclass
class VariantPerceiverConfig:
    ploidy: int = 2
    num_classes: int = 5
    read_embedding_size: int = 128
    cnn_size: int = 128
    kernel_sizes: tuple = (1, 17)
    dimension: int = 256
    num_blocks: int = 4
    num_heads: int = 8
    use_mapqc: bool = False
    use_dwells: bool = False
    use_haplotags: bool = False
    use_snp_qv: bool = False
    bases_alphabet_size: int = 6
    bases_embedding_size: int = 6
    use_decoder_lstm: bool = False
    update_read_embeddings: bool = False
    max_depth: int = 100
    feature_columns: dict = field(default_factory=lambda: dict(DEFAULT_FEATURE_COLUMNS))

    MAX_HAPLOTAGS = 16


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over [N, H, L, D] without the logits in
    memory: on the card the memory-efficient backend only (a shape it cannot
    take raises rather than falling back to the math backend, which would
    materialise them), on the CPU PyTorch's choice."""
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v)


class CrossAttentionBlock(nn.Module):
    """MultiSequenceCrossAttentionBlockImpl (model_variant_perceiver.cpp:
    241-287): queries from x, keys and values from ``cross``, both rotated
    over positions; attention over the (sequence, position) tokens of each
    batch row; then ``rms_norm(x + out)`` and ``rms_norm(swiglu(x) + x)``.
    ``read_embeddings`` is registered in the reference but unused: kept for
    the checkpoint's shape."""

    def __init__(self, dim: int, num_heads: int, max_depth: int):
        super().__init__()
        self.num_heads = num_heads
        self.kv_proj = nn.Linear(dim, 2 * dim, bias=False)
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.read_embeddings = nn.Embedding(max_depth, dim)
        self.out_proj = SwiGLU(dim, dim)
        self.norm1 = RMSNorm(dim)
        self.norm2 = RMSNorm(dim)

    def forward(self, x: torch.Tensor, cross: torch.Tensor) -> torch.Tensor:
        n, t, n_q, dim = x.shape
        n_kv = cross.shape[2]
        heads = self.num_heads
        head_dim = dim // heads
        q = linear(x, self.q_proj.weight).reshape(n, t, n_q, heads, head_dim)
        kv = linear(cross, self.kv_proj.weight).reshape(n, t, n_kv, 2, heads, head_dim)
        q, k = _rope_pair(q, kv[..., 0, :, :])
        v = kv[..., 1, :, :]
        # [N, H, S*T, D], tokens in (sequence, position) order
        q2 = q.permute(0, 3, 2, 1, 4).reshape(n, heads, n_q * t, head_dim)
        k2 = k.permute(0, 3, 2, 1, 4).reshape(n, heads, n_kv * t, head_dim)
        v2 = v.permute(0, 3, 2, 1, 4).reshape(n, heads, n_kv * t, head_dim)
        out = attention(q2, k2, v2).reshape(n, heads, n_q, t, head_dim)
        out = out.permute(0, 3, 2, 1, 4).reshape(n, t, n_q, dim)
        x = self.norm1(x + out)
        return self.norm2(self.out_proj(x) + x)


class HaplotypeSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, max_depth: int):
        super().__init__()
        self.self_attention = CrossAttentionBlock(dim, num_heads, max_depth)
        self.norm = RMSNorm(dim)

    def forward(self, haps: torch.Tensor) -> torch.Tensor:
        return self.norm(haps + self.self_attention(haps, haps))


class MessagePassingBlock(nn.Module):
    """MessagePassingBlockImpl (model_variant_perceiver.cpp:339-375): reads
    to haplotypes, the haplotypes' self-attention and, with
    ``update_read_embeddings``, haplotypes back to reads."""

    def __init__(self, dim: int, num_heads: int, update_read_embeddings: bool, max_depth: int):
        super().__init__()
        self.reads_to_haplotypes = CrossAttentionBlock(dim, num_heads, max_depth)
        self.haplotype_self_attention = HaplotypeSelfAttention(dim, num_heads, max_depth)
        self.haplotypes_to_reads = (CrossAttentionBlock(dim, num_heads, max_depth)
                                    if update_read_embeddings else None)

    def forward(self, reads: torch.Tensor, haps: torch.Tensor):
        haps = self.haplotype_self_attention(self.reads_to_haplotypes(haps, reads))
        if self.haplotypes_to_reads is not None:
            reads = self.haplotypes_to_reads(reads, haps)
        return reads, haps


class VariantPerceiver(nn.Module):
    """x [b, p, d, f] read-level features -> logits [b, p, ploidy,
    num_classes] (model_variant_perceiver.cpp:618-675): the embeddings and
    the per-read conv stack, an expansion to ``dimension``, one latent
    sequence from ``latent_init``, ``num_blocks`` message-passing blocks
    (the last never updates the reads), with ``use_decoder_lstm`` one
    forward LSTM over the latent, and a linear head. Weights are zero until
    loaded (``init_variant_perceiver``, ``variant_perceiver_state_dict``)."""

    def __init__(self, config: VariantPerceiverConfig):
        super().__init__()
        self.config = cfg = config
        _variant_input_layers(self, cfg)
        self.expansion_layer = nn.Linear(cfg.cnn_size, cfg.dimension)
        self.latent_init = nn.Parameter(torch.zeros(cfg.dimension))
        self.blocks = nn.ModuleList(
            MessagePassingBlock(cfg.dimension, cfg.num_heads,
                                cfg.update_read_embeddings and i < cfg.num_blocks - 1,
                                cfg.max_depth)
            for i in range(cfg.num_blocks))
        self.output = nn.Linear(cfg.dimension, cfg.num_classes * cfg.ploidy)
        if cfg.use_decoder_lstm:
            self.decoder_lstm = LSTMDirection(cfg.dimension, cfg.dimension)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with float32_products(x):
            cfg = self.config
            h = _read_features(self, cfg, x)
            b, p = h.shape[:2]
            ex = self.expansion_layer
            reads = linear(h, ex.weight, ex.bias)  # [b, p, d, dim]
            haps = self.latent_init[None, None, None, :].expand(b, p, 1, cfg.dimension)
            for block in self.blocks:
                reads, haps = block(reads, haps)
            haps = haps[:, :, 0]  # the single latent sequence
            if cfg.use_decoder_lstm:
                haps = self.decoder_lstm(haps)
            out = linear(haps, self.output.weight, self.output.bias)
            return out.reshape(b, p, cfg.ploidy, cfg.num_classes)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


_LSTM_NAMES = (("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"),
               ("bias_hh", "b_hh"))


def _input_state(params, embedders: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """The embeddings' and the read-level conv stack's entries of a state
    dict, from the JAX pytree (batch-norm running stats included)."""
    out = {f"{name}.weight": _t(params[name]["w"]) for name in embedders}
    for i, layer in enumerate(params["read_level_conv"]["layers"]):
        pre = f"read_level_conv.{i}"
        out[f"{pre}.conv.weight"] = _t(layer["conv"]["w"])
        out[f"{pre}.conv.bias"] = _t(layer["conv"]["b"])
        for ours, theirs in (("weight", "g"), ("bias", "b"), ("running_mean", "mean"),
                             ("running_var", "var")):
            out[f"{pre}.bn.{ours}"] = _t(layer["bn"][theirs])
        out[f"{pre}.bn.num_batches_tracked"] = torch.tensor(0)
    return out


def _linear_state(out: dict, name: str, p) -> None:
    out[f"{name}.weight"] = _t(p["w"])
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


def latent_space_lstm_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX package's LatentSpaceLSTM params (``init_latent_space_lstm``'s
    pytree, its arrays as numpy), batch-norm running stats included -> a
    LatentSpaceLSTM state dict."""
    out = _input_state(params, ("base_embedder", "strand_embedder"))
    for name in ("pre_pool_expansion_layer", "linear"):
        _linear_state(out, name, params[name])
    for layer, entry in enumerate(params["lstm"]["layers"]):
        for key, sfx in (("fwd", ""), ("rev", "_reverse")):
            for ours, theirs in _LSTM_NAMES:
                out[f"lstm.{ours}_l{layer}{sfx}"] = _t(entry[key][theirs])
    return out


_VARIANT_EMBEDDERS = ("base_embedder", "haplotag_embedder", "strand_embedder")


def slot_attention_consensus_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX package's SlotAttentionConsensus params
    (``init_slot_attention_consensus``' pytree, its arrays as numpy),
    batch-norm running stats and the fixed noise included -> a
    SlotAttentionConsensus state dict."""
    out = _input_state(params, _VARIANT_EMBEDDERS)
    for name in ("expansion_layer", "slot_classifier"):
        _linear_state(out, name, params[name])
    sa = params["slot_attention"]
    for name in ("slots_mu", "slots_logsigma", "fixed_noise"):
        out[f"slot_attention.{name}"] = _t(sa[name])
    for name in ("to_q", "to_k", "to_v"):
        _linear_state(out, f"slot_attention.{name}", sa[name])
    for ours, theirs in _LSTM_NAMES:  # GRUCell's names are the LSTM's
        out[f"slot_attention.gru.{ours}"] = _t(sa["gru"][theirs])
    for name in ("fc1", "fc2"):
        _linear_state(out, f"slot_attention.mlp.{name}", sa["mlp"][name])
    for name in ("norm_input", "norm_slots", "norm_pre_ff"):
        out[f"slot_attention.{name}.weight"] = _t(sa[name]["g"])
        out[f"slot_attention.{name}.bias"] = _t(sa[name]["b"])
    for i, layer in enumerate(params.get("lstm", [])):
        for ours, theirs in _LSTM_NAMES:
            out[f"lstm.{i}.{ours}"] = _t(layer[theirs])
    return out


def _cross_attention_state(out: dict, pre: str, p) -> None:
    for name in ("kv_proj", "q_proj", "read_embeddings"):
        out[f"{pre}.{name}.weight"] = _t(p[name]["w"])
    for name in ("fc1", "fc2"):
        _linear_state(out, f"{pre}.out_proj.{name}", p["out_proj"][name])
    for name in ("norm1", "norm2"):
        out[f"{pre}.{name}.weight"] = _t(p[name]["w"])


def variant_perceiver_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX package's VariantPerceiver params (``init_variant_perceiver``'s
    pytree, its arrays as numpy), batch-norm running stats and the unused
    read-embedding tables included -> a VariantPerceiver state dict."""
    out = _input_state(params, _VARIANT_EMBEDDERS)
    for name in ("expansion_layer", "output"):
        _linear_state(out, name, params[name])
    out["latent_init"] = _t(params["latent_init"])
    for i, block in enumerate(params["blocks"]):
        pre = f"blocks.{i}"
        _cross_attention_state(out, f"{pre}.reads_to_haplotypes", block["reads_to_haplotypes"])
        sa = block["haplotype_self_attention"]
        _cross_attention_state(out, f"{pre}.haplotype_self_attention.self_attention",
                               sa["self_attention"])
        out[f"{pre}.haplotype_self_attention.norm.weight"] = _t(sa["norm"]["w"])
        if "haplotypes_to_reads" in block:
            _cross_attention_state(out, f"{pre}.haplotypes_to_reads",
                                   block["haplotypes_to_reads"])
    if "decoder_lstm" in params:
        for ours, theirs in _LSTM_NAMES:
            out[f"decoder_lstm.{ours}"] = _t(params["decoder_lstm"][theirs])
    return out


def _draw_variant_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Every weight of a variant model drawn from ``generator`` with the JAX
    package's distributions (``init_slot_attention_consensus``,
    ``init_variant_perceiver``): embeddings and ``latent_init`` normal,
    convs uniform in ±1/sqrt(fan-in), linear layers (weights and biases)
    uniform in ±1/sqrt(in features), GRU and LSTM gates in ±1/sqrt(H), the
    slots' mean normal and their log-sigma uniform in ±sqrt(6 / (1 + dim));
    batch and layer norms at their identity, the fixed noise as it is."""
    def uniform(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * bound)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
            elif isinstance(m, (nn.Linear, nn.Conv1d)):
                w = m.weight
                bound = 1.0 / np.sqrt(w[0].numel())
                uniform(w, bound)
                if m.bias is not None:
                    uniform(m.bias, bound)
            elif isinstance(m, (nn.GRUCell, LSTMDirection)):
                hidden = m.weight_hh.shape[1]
                for p in (m.weight_ih, m.weight_hh, m.bias_ih, m.bias_hh):
                    uniform(p, 1.0 / np.sqrt(hidden))
            elif isinstance(m, SlotAttention):
                m.slots_mu.copy_(torch.randn(m.slots_mu.shape, generator=generator))
                uniform(m.slots_logsigma, float(np.sqrt(6.0 / (1 + m.slots_mu.shape[-1]))))
            elif isinstance(m, VariantPerceiver):
                m.latent_init.copy_(torch.randn(m.latent_init.shape, generator=generator))


def init_slot_attention_consensus(cfg: SlotAttentionConfig, generator: torch.Generator,
                                  ) -> SlotAttentionConsensus:
    """A SlotAttentionConsensus with weights drawn from ``generator`` with
    the JAX package's distributions (``_draw_variant_weights``; the numbers
    differ, the two frameworks' generators differ)."""
    model = SlotAttentionConsensus(cfg)
    _draw_variant_weights(model, generator)
    return model.eval()


def init_variant_perceiver(cfg: VariantPerceiverConfig, generator: torch.Generator,
                           ) -> VariantPerceiver:
    """A VariantPerceiver with weights drawn from ``generator`` with the JAX
    package's distributions (``_draw_variant_weights``; the numbers differ,
    the two frameworks' generators differ)."""
    model = VariantPerceiver(cfg)
    _draw_variant_weights(model, generator)
    return model.eval()


# ---------------------------------------------------------------------------
# factory and model directories
# ---------------------------------------------------------------------------


def _flag(kwargs: dict, name: str, default: bool = False) -> bool:
    v = kwargs.get(name, default)
    return v == "true" if isinstance(v, str) else bool(v)


def _kernel_sizes(kwargs: dict) -> tuple:
    kernel_sizes = kwargs.get("kernel_sizes", (1, 17))
    if isinstance(kernel_sizes, str):
        kernel_sizes = tuple(int(v) for v in kernel_sizes.split(","))
    return tuple(kernel_sizes)


def latent_space_lstm_config(kwargs: dict) -> LatentSpaceLSTMConfig:
    """A config.toml's ``[model.kwargs]`` -> LatentSpaceLSTMConfig, as the
    JAX ``model_factory`` reads them."""
    return LatentSpaceLSTMConfig(
        num_classes=int(kwargs["num_classes"]),
        lstm_size=int(kwargs["lstm_size"]),
        cnn_size=int(kwargs["cnn_size"]),
        kernel_sizes=_kernel_sizes(kwargs),
        pooler_type=kwargs.get("pooler_type", "mean"),
        use_dwells=_flag(kwargs, "use_dwells"),
        bases_alphabet_size=int(kwargs.get("bases_alphabet_size", 6)),
        bases_embedding_size=int(kwargs.get("bases_embedding_size", 6)),
        bidirectional=_flag(kwargs, "bidirectional", True),
    )


def slot_attention_config(kwargs: dict) -> SlotAttentionConfig:
    """A config.toml's ``[model.kwargs]`` -> SlotAttentionConfig, as the JAX
    ``model_factory`` reads them (not ``sa_iters``, ``sa_hidden_dim`` or
    ``sa_epsilon``: their defaults hold)."""
    return SlotAttentionConfig(
        num_slots=int(kwargs["num_slots"]),
        classes_per_slot=int(kwargs["classes_per_slot"]),
        read_embedding_size=int(kwargs["read_embedding_size"]),
        cnn_size=int(kwargs["cnn_size"]),
        kernel_sizes=_kernel_sizes(kwargs),
        pooler_type=kwargs.get("pooler_type", "mean"),
        use_mapqc=_flag(kwargs, "use_mapqc"),
        use_dwells=_flag(kwargs, "use_dwells"),
        use_haplotags=_flag(kwargs, "use_haplotags"),
        use_snp_qv=_flag(kwargs, "use_snp_qv"),
        bases_alphabet_size=int(kwargs.get("bases_alphabet_size", 6)),
        bases_embedding_size=int(kwargs.get("bases_embedding_size", 6)),
        add_lstm=_flag(kwargs, "add_lstm"),
        use_reference=_flag(kwargs, "use_reference"),
    )


def variant_perceiver_config(kwargs: dict) -> VariantPerceiverConfig:
    """A config.toml's ``[model.kwargs]`` -> VariantPerceiverConfig, as the
    JAX ``model_factory`` reads them (not ``max_depth``: its default
    holds)."""
    return VariantPerceiverConfig(
        ploidy=int(kwargs["ploidy"]),
        num_classes=int(kwargs["num_classes"]),
        read_embedding_size=int(kwargs["read_embedding_size"]),
        cnn_size=int(kwargs["cnn_size"]),
        kernel_sizes=_kernel_sizes(kwargs),
        dimension=int(kwargs["dimension"]),
        num_blocks=int(kwargs["num_blocks"]),
        num_heads=int(kwargs["num_heads"]),
        use_mapqc=_flag(kwargs, "use_mapqc"),
        use_dwells=_flag(kwargs, "use_dwells"),
        use_haplotags=_flag(kwargs, "use_haplotags"),
        use_snp_qv=_flag(kwargs, "use_snp_qv"),
        bases_alphabet_size=int(kwargs.get("bases_alphabet_size", 6)),
        bases_embedding_size=int(kwargs.get("bases_embedding_size", 6)),
        use_decoder_lstm=_flag(kwargs, "use_decoder_lstm"),
        update_read_embeddings=_flag(kwargs, "update_read_embeddings"),
    )


def model_factory(model_type: str, kwargs: dict, generator: torch.Generator | None = None,
                  ) -> nn.Module:
    """A model of ``model_type`` with the config's ``kwargs``, its weights
    drawn from ``generator`` (seed 0 unless given). A missing kwarg raises
    KeyError, as in the JAX factory; an unknown type ValueError."""
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
    if model_type == "SlotAttentionConsensus":
        return init_slot_attention_consensus(slot_attention_config(kwargs), generator)
    if model_type == "VariantPerceiver":
        return init_variant_perceiver(variant_perceiver_config(kwargs), generator)
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
    "GRUModel", "LatentSpaceLSTM", "LatentSpaceLSTMConfig", "SlotAttentionConsensus",
    "SlotAttentionConfig", "VariantPerceiver", "VariantPerceiverConfig", "model_factory",
    "parse_model_config", "init_latent_space_lstm", "init_slot_attention_consensus",
    "init_variant_perceiver", "latent_space_lstm_state_dict",
    "slot_attention_consensus_state_dict", "variant_perceiver_state_dict",
    "batch_adjacency_phase",
]
