"""Basecall model configuration.

Parses a model directory's ``config.toml`` into typed dataclasses describing
the encoder (conv + LSTM stack or conv + transformer stack), the CRF output
head, signal normalisation and per-model basecalling batch parameters.

Semantics-parity notes (reference: nanoporetech/dorado):
  - field meanings and derived quantities (stride, outsize, state_len,
    chunk-size normalisation) follow
    dorado/config/BasecallModelConfig.cpp:214-470 and
    dorado/config/include/config/BasecallModelConfig.h:97-165
  - batch-param normalisation follows dorado/config/BatchParams.cpp:89-108
"""

from __future__ import annotations

import enum
import tomllib
from dataclasses import dataclass, field
from pathlib import Path


class Activation(enum.Enum):
    SWISH = "swish"
    SWISH_CLAMP = "swish_clamp"
    TANH = "tanh"


class ScalingStrategy(enum.Enum):
    MED_MAD = "med_mad"
    QUANTILE = "quantile"
    PA = "pa"


class SampleType(enum.Enum):
    DNA = "dna"
    RNA002 = "rna002"
    RNA004 = "rna004"
    UNKNOWN = "unknown"


# Default per-run workload parameters (reference: dorado/utils/parameters.h:8-12).
DEFAULT_CHUNKSIZE = 10000
DEFAULT_OVERLAP = 500
DEFAULT_BATCHSIZE = 0  # 0 => auto


@dataclass
class QuantileScalingParams:
    quantile_a: float = 0.2
    quantile_b: float = 0.9
    shift_multiplier: float = 0.51
    scale_multiplier: float = 0.53


@dataclass
class StandardisationParams:
    standardise: bool = False
    mean: float = 0.0
    stdev: float = 1.0


@dataclass
class SignalNormalisationParams:
    strategy: ScalingStrategy = ScalingStrategy.QUANTILE
    quantile: QuantileScalingParams = field(default_factory=QuantileScalingParams)
    standardisation: StandardisationParams = field(default_factory=StandardisationParams)


@dataclass
class ConvParams:
    insize: int
    size: int
    winlen: int
    stride: int
    activation: Activation
    # flstm marks a conv layer feeding a factorised-LSTM stack
    flstm: bool = False

    @property
    def padding(self) -> int:
        return self.winlen // 2


@dataclass
class TxEncoderParams:
    d_model: int = -1
    nhead: int = -1
    depth: int = -1
    dim_feedforward: int = -1
    attn_window: tuple[int, int] = (-1, -1)
    deepnorm_alpha: float = 1.0
    theta: float = 10000.0
    max_seq_len: int = 2048


@dataclass
class LinearUpsampleParams:
    size: int
    scale_factor: int


@dataclass
class CRFEncoderParams:
    insize: int
    n_base: int
    state_len: int
    scale: float
    blank_score: float
    expand_blanks: bool
    permute: list[int]

    @property
    def outsize(self) -> int:
        if self.expand_blanks:
            return self.n_base ** (self.state_len + 1)
        return (self.n_base + 1) * self.n_base**self.state_len

    @property
    def out_features(self) -> int:
        return self.n_base ** (self.state_len + 1)


@dataclass
class TxStack:
    tx: TxEncoderParams
    upsample: LinearUpsampleParams
    crf: CRFEncoderParams


@dataclass
class BatchParams:
    chunk_size: int = DEFAULT_CHUNKSIZE
    overlap: int = DEFAULT_OVERLAP
    batch_size: int = DEFAULT_BATCHSIZE

    def normalise(self, chunk_size_granularity: int, stride: int) -> None:
        """Snap overlap to a stride multiple and chunk size to a granularity
        multiple that stays greater than overlap
        (reference semantics: dorado/config/BatchParams.cpp:89-108)."""
        self.overlap = max(1, self.overlap // stride) * stride
        min_chunk_size = self.overlap + chunk_size_granularity - 1
        self.chunk_size = (
            max(min_chunk_size, self.chunk_size) // chunk_size_granularity
        ) * chunk_size_granularity


@dataclass
class BasecallModelConfig:
    model_path: Path
    qscale: float = 1.0
    qbias: float = 0.0
    lstm_size: int = 0
    lstm_inner_dim: int | None = None  # factorised LSTM
    lstm_layers: int = 5
    stride: int = 1
    bias: bool = True
    clamp: bool = False
    out_features: int | None = None
    state_len: int = 0
    outsize: int = 0
    blank_score: float = 0.0
    scale: float = 1.0
    num_features: int = 1
    sample_rate: int = -1
    signal_norm_params: SignalNormalisationParams = field(
        default_factory=SignalNormalisationParams
    )
    polya_speed_correction: float | None = None
    polya_offset_correction: float | None = None
    mean_qscore_start_pos: int = -1
    sample_type: SampleType = SampleType.UNKNOWN
    convs: list[ConvParams] = field(default_factory=list)
    tx: TxStack | None = None
    basecaller: BatchParams = field(default_factory=BatchParams)

    @property
    def model_name(self) -> str:
        return self.model_path.name

    @property
    def is_tx_model(self) -> bool:
        return self.tx is not None

    @property
    def is_lstm_model(self) -> bool:
        return not self.is_tx_model

    @property
    def is_flstm_model(self) -> bool:
        return self.is_lstm_model and self.lstm_inner_dim is not None

    @property
    def has_pre_v4_head(self) -> bool:
        """A conv + LSTM model whose CRF head is pre-v4: one linear layer
        with a bias, then 5 tanh (a first conv of 4 or more than one input
        feature, as the stereo model's 13)."""
        return self.is_lstm_model and self.out_features is None and (
            self.convs[0].size <= 4 or self.num_features != 1
        )

    @property
    def scale_factor(self) -> int:
        return self.tx.upsample.scale_factor if self.tx is not None else 1

    @property
    def stride_inner(self) -> int:
        return self.stride * self.scale_factor

    @property
    def chunk_size_granularity(self) -> int:
        return self.stride_inner * (16 if self.is_tx_model else 1)

    @property
    def num_states(self) -> int:
        return 4**self.state_len

    @property
    def is_rna_model(self) -> bool:
        return self.sample_type in (SampleType.RNA002, SampleType.RNA004)

    @property
    def is_duplex_model(self) -> bool:
        return self.num_features > 1

    def normalise_basecaller_params(self) -> None:
        self.basecaller.normalise(self.chunk_size_granularity, self.stride_inner)

    def has_normalised_basecaller_params(self) -> bool:
        cs, ov = self.basecaller.chunk_size, self.basecaller.overlap
        return (
            cs % self.chunk_size_granularity == 0
            and ov % self.stride_inner == 0
            and cs > ov
        )


def _sample_type_from_string(s: str) -> SampleType:
    table = {
        "dna": SampleType.DNA,
        "rna002": SampleType.RNA002,
        "rna004": SampleType.RNA004,
    }
    return table.get(s.lower(), SampleType.UNKNOWN)


def _sample_type_from_model_name(name: str) -> SampleType:
    lowered = name.lower()
    if "rna004" in lowered:
        return SampleType.RNA004
    if "rna002" in lowered:
        return SampleType.RNA002
    if "dna" in lowered or lowered.startswith("sample_type"):
        return SampleType.DNA
    return SampleType.UNKNOWN


_ACTIVATIONS = {
    "swish": Activation.SWISH,
    "swish_clamp": Activation.SWISH_CLAMP,
    "tanh": Activation.TANH,
}


def _parse_conv(segment: dict, allow_swish_clamp: bool) -> ConvParams:
    act_name = segment["activation"]
    act = _ACTIVATIONS.get(act_name)
    if act is None:
        raise ValueError(f"unknown conv activation: {act_name!r}")
    if not allow_swish_clamp and act is Activation.SWISH_CLAMP:
        act = Activation.SWISH
    return ConvParams(
        insize=int(segment["insize"]),
        size=int(segment["size"]),
        winlen=int(segment["winlen"]),
        stride=int(segment.get("stride", 1)),
        activation=act,
    )


def _parse_signal_norm(config_toml: dict) -> SignalNormalisationParams:
    params = SignalNormalisationParams()
    if "scaling" in config_toml:
        strategy = config_toml["scaling"]["strategy"]
        params.strategy = ScalingStrategy(strategy)
    if "normalisation" in config_toml:
        norm = config_toml["normalisation"]
        params.quantile = QuantileScalingParams(
            quantile_a=float(norm["quantile_a"]),
            quantile_b=float(norm["quantile_b"]),
            shift_multiplier=float(norm["shift_multiplier"]),
            scale_multiplier=float(norm["scale_multiplier"]),
        )
    if "standardisation" in config_toml:
        stdn = config_toml["standardisation"]
        standardise = int(stdn["standardise"]) > 0
        params.standardisation = StandardisationParams(
            standardise=standardise,
            mean=float(stdn["mean"]) if standardise else 0.0,
            stdev=float(stdn["stdev"]) if standardise else 1.0,
        )
        if standardise and params.strategy is not ScalingStrategy.PA:
            raise ValueError("standardisation requires scaling.strategy == 'pa'")
        if params.standardisation.stdev <= 0.0:
            raise ValueError("standardisation.stdev must be > 0")
    return params


def _parse_qscore(config: BasecallModelConfig, config_toml: dict) -> None:
    qscore = config_toml.get("qscore")
    if qscore is None:
        return
    config.qbias = float(qscore["bias"])
    config.qscale = float(qscore["scale"])
    if "mean_qscore_start_pos" in qscore:
        config.mean_qscore_start_pos = int(qscore["mean_qscore_start_pos"])
    else:
        # Default used for models without an explicit start position
        # (dorado/config/BasecallModelConfig.cpp:30-37).
        config.mean_qscore_start_pos = 60
    if config.mean_qscore_start_pos < 0:
        raise ValueError("qscore.mean_qscore_start_pos cannot be < 0")


def _parse_polya(config: BasecallModelConfig, config_toml: dict) -> None:
    polya = config_toml.get("poly_a")
    if polya is None:
        return
    coeffs = polya.get("calibration_coefficients")
    if coeffs is not None:
        if isinstance(coeffs, list):
            config.polya_speed_correction = 1.0 / float(coeffs[0])
        else:
            config.polya_speed_correction = 1.0 / float(coeffs)
        return
    if "speed_correction" in polya or "offset_correction" in polya:
        if not ("speed_correction" in polya and "offset_correction" in polya):
            raise ValueError(
                "poly_a must contain both speed_correction and offset_correction or neither"
            )
        config.polya_speed_correction = float(polya["speed_correction"])
        config.polya_offset_correction = float(polya["offset_correction"])


def _parse_run_info(config: BasecallModelConfig, config_toml: dict) -> None:
    run_info = config_toml.get("run_info")
    if run_info is not None:
        config.sample_rate = int(run_info["sample_rate"])
        if "sample_type" in run_info:
            config.sample_type = _sample_type_from_string(run_info["sample_type"])
    if config.sample_type is SampleType.UNKNOWN:
        config.sample_type = _sample_type_from_model_name(config.model_name)
        if config.sample_type is SampleType.UNKNOWN:
            raise ValueError(
                "failed to determine model sample type from model name or config"
            )


def _update_batch_params(config: BasecallModelConfig, config_toml: dict) -> None:
    b = config_toml.get("basecaller")
    if b is None:
        return
    chunksize = b.get("chunksize")
    overlap = b.get("overlap")
    # basecaller.batchsize in the config is ignored (CLI-only), matching the
    # reference (dorado/config/BatchParams.cpp:60-64).
    if chunksize is not None and int(chunksize) >= 0:
        config.basecaller.chunk_size = int(chunksize)
    if overlap is not None and int(overlap) >= 0:
        config.basecaller.overlap = int(overlap)


def _load_lstm_model_config(path: Path, config_toml: dict) -> BasecallModelConfig:
    config = BasecallModelConfig(model_path=path)
    _update_batch_params(config, config_toml)
    _parse_qscore(config, config_toml)
    _parse_polya(config, config_toml)

    config.num_features = int(config_toml["input"]["features"])
    encoder = config_toml["encoder"]
    if "type" in encoder:
        # v4-style model: explicit sublayer list
        sublayers = encoder["sublayers"]
        config.bias = False
        config.clamp = any(s.get("type") == "clamp" for s in sublayers)
        config.convs = [
            _parse_conv(s, allow_swish_clamp=True)
            for s in sublayers
            if s.get("type") == "convolution"
        ]
        for cv in config.convs:
            config.stride *= cv.stride
        config.lstm_size = config.convs[-1].size
        config.lstm_layers = 0
        flstm_layers = 0
        for s in sublayers:
            stype = s.get("type")
            if stype == "linear":
                config.out_features = int(s["out_features"])
                config.bias = bool(s.get("bias", config.lstm_size > 128))
            elif stype == "linearcrfencoder":
                config.blank_score = float(s["blank_score"])
                config.scale = float(s.get("scale", 1.0))
            elif stype == "lstm":
                config.lstm_layers += 1
            elif stype == "flstm":
                flstm_layers += 1
                inner_dim = int(s["inner_dim"])
                if config.lstm_inner_dim is not None and config.lstm_inner_dim != inner_dim:
                    raise ValueError("mismatched FLSTM inner dimensions")
                config.lstm_inner_dim = inner_dim
        if flstm_layers:
            if config.lstm_layers:
                raise ValueError("cannot mix LSTM and FLSTM layers")
            config.lstm_layers = flstm_layers
            config.convs[-1].flstm = True
    else:
        # pre-v4 model: implied conv stack
        config.stride = int(encoder["stride"])
        config.lstm_size = int(encoder["features"])
        config.blank_score = float(encoder["blank_score"])
        config.scale = float(encoder["scale"])
        first_conv = int(encoder.get("first_conv_size", 4))
        config.convs = [
            ConvParams(config.num_features, first_conv, 5, 1, Activation.SWISH),
            ConvParams(first_conv, 16, 5, 1, Activation.SWISH),
            ConvParams(16, config.lstm_size, 19, config.stride, Activation.SWISH),
        ]

    config.state_len = int(config_toml["global_norm"]["state_len"])
    config.outsize = 4 ** (config.state_len + 1)
    config.signal_norm_params = _parse_signal_norm(config_toml)

    if len(config.convs) != 3:
        raise ValueError(f"expected 3 convolution layers, found {len(config.convs)}")
    if config.convs[0].size not in (4, 16):
        raise ValueError(
            f"first convolution layer must be size 4 or 16, got {config.convs[0].size}"
        )

    _parse_run_info(config, config_toml)
    return config


def _load_tx_model_config(path: Path, config_toml: dict) -> BasecallModelConfig:
    config = BasecallModelConfig(model_path=path)
    _update_batch_params(config, config_toml)
    _parse_qscore(config, config_toml)
    _parse_polya(config, config_toml)

    model_toml = config_toml["model"]
    enc = model_toml["encoder"]["transformer_encoder"]
    layer = enc["layer"]
    if "rotary_base" in layer and "theta" in layer:
        raise ValueError("'rotary_base' and 'theta' are mutually exclusive")
    theta = float(layer.get("theta", layer.get("rotary_base", 10000.0)))
    tx_params = TxEncoderParams(
        d_model=int(layer["d_model"]),
        nhead=int(layer["nhead"]),
        depth=int(enc["depth"]),
        dim_feedforward=int(layer["dim_feedforward"]),
        attn_window=(int(layer["attn_window"][0]), int(layer["attn_window"][1])),
        deepnorm_alpha=float(layer["deepnorm_alpha"]),
        theta=theta,
        max_seq_len=int(layer.get("max_seq_len", 2048)),
    )
    ups = model_toml["encoder"]["upsample"]
    upsample = LinearUpsampleParams(
        size=int(ups["d_model"]), scale_factor=int(ups["scale_factor"])
    )
    crf_toml = model_toml["encoder"]["crf"]
    crf = CRFEncoderParams(
        insize=int(crf_toml["insize"]),
        n_base=int(crf_toml["n_base"]),
        state_len=int(crf_toml["state_len"]),
        scale=float(crf_toml["scale"]),
        blank_score=float(crf_toml["blank_score"]),
        expand_blanks=bool(crf_toml["expand_blanks"]),
        permute=[int(p) for p in crf_toml["permute"]],
    )
    config.tx = TxStack(tx=tx_params, upsample=upsample, crf=crf)

    for segment in model_toml["encoder"]["conv"]["sublayers"]:
        if segment.get("type") != "convolution":
            continue
        config.convs.append(_parse_conv(segment, allow_swish_clamp=False))
        config.stride *= config.convs[-1].stride
    config.stride //= upsample.scale_factor
    config.out_features = crf.out_features
    config.outsize = crf.outsize
    config.state_len = crf.state_len
    config.num_features = config.convs[0].insize
    config.signal_norm_params = _parse_signal_norm(config_toml)
    _parse_run_info(config, config_toml)
    config.lstm_size = -1
    return config


def _read_toml(path: Path) -> dict:
    with open(path / "config.toml", "rb") as f:
        return tomllib.load(f)


def is_tx_model_config(path: Path | str) -> bool:
    config_toml = _read_toml(Path(path))
    try:
        return "transformer_encoder" in config_toml["model"]["encoder"]
    except (KeyError, TypeError):
        return False


def load_model_config(path: Path | str) -> BasecallModelConfig:
    """Load and type a model directory's config.toml."""
    path = Path(path)
    config_toml = _read_toml(path)
    if is_tx_model_config(path):
        return _load_tx_model_config(path, config_toml)
    return _load_lstm_model_config(path, config_toml)
