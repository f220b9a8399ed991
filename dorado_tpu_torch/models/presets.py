"""In-code model architecture presets (shapes from the reference's checked-in
configs, SURVEY §2.3 / tests/data/model_configs/*/config.toml).

Used by the tests and ``chip_smoke.py`` so they need no model files on disk.
"""

from __future__ import annotations

from pathlib import Path

from dorado_tpu_torch.config import (
    Activation,
    BasecallModelConfig,
    BatchParams,
    ConvParams,
    CRFEncoderParams,
    LinearUpsampleParams,
    SampleType,
    ScalingStrategy,
    SignalNormalisationParams,
    StandardisationParams,
    TxEncoderParams,
    TxStack,
)


def hac_v43_config() -> BasecallModelConfig:
    """dna_r10.4.1_e8.2_400bps_hac@v4.3.0: conv 16/16/384 (stride 6, tanh
    final), 5x LSTM(384), LinearCRF state_len 4, clamp, no bias."""
    cfg = BasecallModelConfig(
        model_path=Path("dna_r10.4.1_e8.2_400bps_hac@v4.3.0"),
        qscale=1.1,
        qbias=-1.1,
        lstm_size=384,
        stride=6,
        bias=False,
        clamp=True,
        state_len=4,
        outsize=4**5,
        blank_score=2.0,
        scale=1.0,
        sample_rate=5000,
        sample_type=SampleType.DNA,
        convs=[
            ConvParams(1, 16, 5, 1, Activation.SWISH),
            ConvParams(16, 16, 5, 1, Activation.SWISH),
            ConvParams(16, 384, 19, 6, Activation.TANH),
        ],
        signal_norm_params=SignalNormalisationParams(
            strategy=ScalingStrategy.PA,
            standardisation=StandardisationParams(
                standardise=True, mean=91.88, stdev=22.65
            ),
        ),
        basecaller=BatchParams(chunk_size=10000, overlap=500, batch_size=0),
    )
    return cfg


def fast_v40_config() -> BasecallModelConfig:
    """dna_r10.4.1_e8.2_260bps_fast@v4.0.0: conv 16/16/96 (stride 5),
    5x LSTM(96), LinearCRF state_len 3."""
    cfg = BasecallModelConfig(
        model_path=Path("dna_r10.4.1_e8.2_260bps_fast@v4.0.0"),
        qscale=0.97,
        qbias=-0.2,
        lstm_size=96,
        stride=5,
        bias=False,
        clamp=True,
        state_len=3,
        outsize=4**4,
        blank_score=2.0,
        sample_rate=4000,
        sample_type=SampleType.DNA,
        convs=[
            ConvParams(1, 16, 5, 1, Activation.SWISH),
            ConvParams(16, 16, 5, 1, Activation.SWISH),
            ConvParams(16, 96, 19, 5, Activation.SWISH),
        ],
        basecaller=BatchParams(chunk_size=10000, overlap=500, batch_size=0),
    )
    return cfg


def sup_v50_config() -> BasecallModelConfig:
    """dna_r10.4.1_e8.2_400bps_sup@v5.0.0 transformer: conv stack stride 12,
    18-layer TxEncoder (d_model 512, 8 heads, ff 2048, window [127,128]),
    LinearUpsample x2, LinearScaledCRF state_len 5."""
    tx = TxEncoderParams(
        d_model=512,
        nhead=8,
        depth=18,
        dim_feedforward=2048,
        attn_window=(127, 128),
        deepnorm_alpha=2.4494897,
    )
    cfg = BasecallModelConfig(
        model_path=Path("dna_r10.4.1_e8.2_400bps_sup@v5.0.0"),
        qscale=1.05,
        qbias=-0.2,
        stride=6,
        state_len=5,
        outsize=4**6,
        blank_score=2.0,
        scale=5.0,
        sample_rate=5000,
        sample_type=SampleType.DNA,
        convs=[
            ConvParams(1, 64, 5, 1, Activation.SWISH),
            ConvParams(64, 64, 5, 1, Activation.SWISH),
            ConvParams(64, 128, 9, 3, Activation.SWISH),
            ConvParams(128, 128, 9, 2, Activation.SWISH),
            ConvParams(128, 512, 5, 2, Activation.SWISH),
        ],
        tx=TxStack(
            tx=tx,
            upsample=LinearUpsampleParams(size=512, scale_factor=2),
            crf=CRFEncoderParams(
                insize=512,
                n_base=4,
                state_len=5,
                scale=5.0,
                blank_score=2.0,
                expand_blanks=True,
                permute=[],
            ),
        ),
        signal_norm_params=SignalNormalisationParams(
            strategy=ScalingStrategy.PA,
            standardisation=StandardisationParams(
                standardise=True, mean=93.6376, stdev=23.0741
            ),
        ),
        basecaller=BatchParams(chunk_size=12288, overlap=600, batch_size=128),
    )
    return cfg
