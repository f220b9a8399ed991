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


def lstm_sup_config() -> BasecallModelConfig:
    """The conv + LSTM sup class, named dna_r10.4.1_e8.2_400bps_sup@v4.3.0,
    built from what the repository records of that class (the JAX package's
    benchmark and README: LSTM 768 wide, state_len 5) and, for every other
    field, hac v4.3's (``hac_v43_config``); its true ``config.toml`` is not
    in the repository. Field by field:

      - from the records: 5 LSTM layers of 768 (``lstm_size``), ``state_len``
        5, ``outsize`` 4^6 (1024 states);
      - from hac v4.3: the convs 1 -> 16 -> 16 (k5, swish) -> 768 (the last
        at k19, stride 6, tanh), ``stride`` 6, chunk 10000 (9996 once
        normalised to the stride) with overlap 500, ``clamp``, no bias,
        ``blank_score`` 2.0, ``scale`` 1.0, qscale 1.1 and qbias -1.1, 5 kHz
        DNA, pa scaling with hac's standardisation (mean 91.88, stdev
        22.65)."""
    cfg = hac_v43_config()
    cfg.model_path = Path("dna_r10.4.1_e8.2_400bps_sup@v4.3.0")
    cfg.lstm_size = 768
    cfg.state_len = 5
    cfg.outsize = 4**6
    cfg.convs[2] = ConvParams(16, 768, 19, 6, Activation.TANH)
    return cfg


def rna004_hac_config() -> BasecallModelConfig:
    """A stand-in for the direct-RNA hac model, named
    rna004_130bps_hac@v5.0.0 (the JAX package's model registry); the
    reference's RNA configs are not in the repository. Field by field:

      - from the registry's ``rna004_130bps`` chemistry: ``sample_type``
        RNA004 and ``sample_rate`` 4000;
      - from hac v4.3 (``hac_v43_config``), the stand-ins: the convs 1 -> 16
        -> 16 (k5, swish) -> 384 (k19, stride 6, tanh), 5 LSTM layers of
        384, ``state_len`` 4 (256 states), ``clamp``, no bias,
        ``blank_score`` 2.0, ``scale`` 1.0, qscale 1.1 and qbias -1.1,
        chunk 10000 with overlap 500, and pa scaling with hac's
        standardisation (mean 91.88, stdev 22.65).

    ``config_toml`` writes ``sample_type``, so both packages' loaders read
    it as an RNA model."""
    cfg = hac_v43_config()
    cfg.model_path = Path("rna004_130bps_hac@v5.0.0")
    cfg.sample_type = SampleType.RNA004
    cfg.sample_rate = 4000
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


def stereo_config() -> BasecallModelConfig:
    """The duplex stereo model, named dna_r10.4.1_e8.2_5khz_stereo@v1.1 (the
    JAX package's model registry), built from what the repository records of
    it; its true ``config.toml`` is not in the repository. Field by field:

      - from the registry's name: 5 kHz DNA;
      - from the stereo features (``duplex.stereo``) and the pre-v4 config
        layout both loaders parse for such a model (``[input] features``,
        ``[encoder]`` ``stride``, ``features``, ``first_conv_size``,
        ``scale``, ``blank_score``): 13 input features and the implied convs
        13 -> 16 (k5) -> 16 (k5) -> the LSTM width (k19, at the stride), all
        swish; the head takes a bias (``bias``) and computes 5 tanh of its
        output (``scale`` 5.0), which keeps the scores within +-5 (no clamp
        layer: ``clamp`` False, as the layout loads it);
      - from the JAX package's stereo tests: ``stride`` 5, ``state_len`` 3
        (``outsize`` 4^4, 64 states), ``blank_score`` 2.0;
      - from hac v4.3 (``hac_v43_config``): 5 LSTM layers of 384, chunk
        10000 with overlap 500;
      - the loaders' defaults for the rest (qscale 1.0, qbias 0.0, the
        default signal normalisation: the stereo features arrive scaled).

    ``config_toml`` writes it in the pre-v4 layout."""
    return BasecallModelConfig(
        model_path=Path("dna_r10.4.1_e8.2_5khz_stereo@v1.1"),
        lstm_size=384,
        stride=5,
        bias=True,
        clamp=False,
        state_len=3,
        outsize=4**4,
        blank_score=2.0,
        scale=5.0,
        num_features=13,
        sample_rate=5000,
        sample_type=SampleType.DNA,
        convs=[
            ConvParams(13, 16, 5, 1, Activation.SWISH),
            ConvParams(16, 16, 5, 1, Activation.SWISH),
            ConvParams(16, 384, 19, 5, Activation.SWISH),
        ],
        basecaller=BatchParams(chunk_size=10000, overlap=500, batch_size=0),
    )


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


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    if isinstance(v, str):
        return f'"{v}"'
    return repr(v)


def _toml_table(name: str, values: dict, array: bool = False) -> list[str]:
    head = f"[[{name}]]" if array else f"[{name}]"
    return [head] + [f"{k} = {_toml_value(v)}" for k, v in values.items()] + [""]


def _pre_v4_encoder(config: BasecallModelConfig) -> dict:
    """The pre-v4 ``[encoder]`` table of ``config``; raises ValueError where
    the layout cannot hold it (its convs, layer count and flags are
    implied)."""
    first = config.convs[0].size
    implied = [
        ConvParams(config.num_features, first, 5, 1, Activation.SWISH),
        ConvParams(first, 16, 5, 1, Activation.SWISH),
        ConvParams(16, config.lstm_size, 19, config.stride, Activation.SWISH),
    ]
    if (config.convs != implied or config.lstm_layers != 5 or not config.bias
            or config.clamp):
        raise ValueError(f"{config.model_name}: a pre-v4 head on another stack than the "
                         f"pre-v4 layout implies")
    return {"stride": config.stride, "features": config.lstm_size, "first_conv_size": first,
            "scale": config.scale, "blank_score": config.blank_score}


def config_toml(config: BasecallModelConfig) -> str:
    """The ``config.toml`` of a model directory for ``config``, in the
    reference's schema (v4 encoder sublayers for conv + LSTM models, the
    pre-v4 ``[encoder]`` table for a conv + LSTM model with a pre-v4 head,
    the ``model.encoder`` tables for transformers), such that
    ``load_model_config`` of the directory gives ``config`` back (a
    directory named after ``config.model_name``)."""
    lines: list[str] = []

    def conv(cv):
        return {"type": "convolution", "insize": cv.insize, "size": cv.size,
                "winlen": cv.winlen, "stride": cv.stride, "activation": cv.activation.value}

    if config.is_tx_model:
        tx, ups, crf = config.tx.tx, config.tx.upsample, config.tx.crf
        for cv in config.convs:
            lines += _toml_table("model.encoder.conv.sublayers", conv(cv), array=True)
        lines += _toml_table("model.encoder.transformer_encoder", {"depth": tx.depth})
        lines += _toml_table("model.encoder.transformer_encoder.layer", {
            "d_model": tx.d_model, "nhead": tx.nhead, "dim_feedforward": tx.dim_feedforward,
            "attn_window": list(tx.attn_window), "deepnorm_alpha": tx.deepnorm_alpha,
            "theta": tx.theta, "max_seq_len": tx.max_seq_len,
        })
        lines += _toml_table("model.encoder.upsample",
                             {"d_model": ups.size, "scale_factor": ups.scale_factor})
        lines += _toml_table("model.encoder.crf", {
            "insize": crf.insize, "n_base": crf.n_base, "state_len": crf.state_len,
            "scale": crf.scale, "blank_score": crf.blank_score,
            "expand_blanks": crf.expand_blanks, "permute": list(crf.permute),
        })
    elif config.has_pre_v4_head:
        lines += _toml_table("input", {"features": config.num_features})
        lines += _toml_table("encoder", _pre_v4_encoder(config))
        lines += _toml_table("global_norm", {"state_len": config.state_len})
    else:
        lines += _toml_table("input", {"features": config.num_features})
        lines += _toml_table("encoder", {"type": "serial"})
        for cv in config.convs:
            lines += _toml_table("encoder.sublayers", conv(cv), array=True)
        lines += _toml_table("encoder.sublayers", {"type": "permute"}, array=True)
        for i in range(config.lstm_layers):
            lines += _toml_table("encoder.sublayers", {
                "type": "lstm", "size": config.lstm_size, "insize": config.lstm_size,
                "reverse": i % 2 == 0,
            }, array=True)
        if config.out_features is not None:
            lines += _toml_table("encoder.sublayers", {
                "type": "linear", "in_features": config.lstm_size,
                "out_features": config.out_features, "bias": config.bias,
            }, array=True)
        lines += _toml_table("encoder.sublayers", {
            "type": "linearcrfencoder", "insize": config.lstm_size, "n_base": 4,
            "state_len": config.state_len, "bias": config.bias,
            "scale": config.scale, "blank_score": config.blank_score,
        }, array=True)
        if config.clamp:
            lines += _toml_table("encoder.sublayers", {"type": "clamp"}, array=True)
        lines += _toml_table("global_norm", {"state_len": config.state_len})
    qscore = {"bias": config.qbias, "scale": config.qscale}
    if config.mean_qscore_start_pos >= 0:
        qscore["mean_qscore_start_pos"] = config.mean_qscore_start_pos
    lines += _toml_table("qscore", qscore)
    norm = config.signal_norm_params
    lines += _toml_table("scaling", {"strategy": norm.strategy.value})
    q = norm.quantile
    lines += _toml_table("normalisation", {
        "quantile_a": q.quantile_a, "quantile_b": q.quantile_b,
        "shift_multiplier": q.shift_multiplier, "scale_multiplier": q.scale_multiplier,
    })
    st = norm.standardisation
    lines += _toml_table("standardisation", {
        "standardise": int(st.standardise), "mean": st.mean, "stdev": st.stdev,
    })
    lines += _toml_table("run_info", {
        "sample_rate": config.sample_rate, "sample_type": config.sample_type.value,
    })
    lines += _toml_table("basecaller", {
        "chunksize": config.basecaller.chunk_size, "overlap": config.basecaller.overlap,
    })
    return "\n".join(lines)


def hac_5mcg_5hmcg_v3_config(size: int = 256):
    """dna_r10.4.1_e8.2_400bps_hac@v5.0.0_5mCG_5hmCG@v3, a conv_lstm_v2
    modbase model: size 256, kmer_len 9, num_out 3 (h, m, canonical), stride
    6, motif CG at offset 0, chunk 192 with 96/96 samples of context, 4/4
    kmer context bases, base start justified, rough rescale with the kmer
    centred at index 6 (SURVEY.md §2.3). ``size`` narrows it for tests."""
    from dorado_tpu_torch.modbase.config import (
        ContextParams, ModBaseModelConfig, ModBaseModelType, ModificationParams,
        RefinementParams,
    )

    return ModBaseModelConfig(
        model_path=Path("dna_r10.4.1_e8.2_400bps_hac@v5.0.0_5mCG_5hmCG@v3"),
        model_type=ModBaseModelType.CONV_LSTM_V2,
        size=size, kmer_len=9, num_out=3, stride=6, sequence_stride=1,
        mods=ModificationParams(codes=["h", "m"], long_names=["5hmC", "5mC"], motif="CG",
                                motif_offset=0),
        context=ContextParams(samples_before=96, samples_after=96, chunk_size=192,
                              bases_before=4, bases_after=4, reverse=False,
                              base_start_justify=True),
        refine=RefinementParams(do_rough_rescale=True, center_idx=6),
    )


def small_conv_lstm_v3_config():
    """A small synthetic conv_lstm_v3 model (the shape of the 6mA@v4 models,
    narrowed: signal convs 1 -> 4 -> 16 -> 32 at stride 6, sequence convs 36
    -> 16 -> 32 at stride 1, a merge conv, LSTMs of 32), motif A: for the
    tests, which have no published v3 config."""
    from dorado_tpu_torch.modbase.config import (
        ContextParams, ModBaseModelConfig, ModBaseModelType, ModificationParams,
        RefinementParams,
    )

    def conv(insize, size, winlen, stride, activation="swish"):
        return {"type": "convolution", "insize": insize, "size": size, "winlen": winlen,
                "stride": stride, "padding": winlen // 2, "activation": activation}

    return ModBaseModelConfig(
        model_path=Path("small_conv_lstm_v3_6mA"),
        model_type=ModBaseModelType.CONV_LSTM_V3,
        size=32, kmer_len=9, num_out=2, stride=6, sequence_stride=1,
        mods=ModificationParams(codes=["a"], long_names=["6mA"], motif="A", motif_offset=0),
        context=ContextParams(samples_before=150, samples_after=150, chunk_size=300,
                              bases_before=4, bases_after=4, reverse=False,
                              base_start_justify=False),
        refine=RefinementParams(),
        signal_encoder=[conv(1, 4, 5, 1), conv(4, 16, 5, 1), conv(16, 32, 9, 6)],
        sequence_encoder=[conv(36, 16, 5, 1), conv(16, 32, 13, 1, "tanh")],
        encoder=[conv(64, 32, 5, 1), {"type": "lstm", "size": 32, "reverse": False},
                 {"type": "lstm", "size": 32, "reverse": True},
                 {"type": "linear", "in_features": 32, "out_features": 2}],
    )


def modbase_config_toml(config) -> str:
    """The ``config.toml`` of a modbase model directory for ``config`` (a
    ``ModBaseModelConfig``), such that ``load_modbase_config`` of the
    directory gives ``config`` back (but for ``model_path``)."""
    ctx, mods = config.context, config.mods
    lines = _toml_table("general", {"model": config.model_type.value})
    lines += _toml_table("model_params", {
        "size": config.size, "kmer_len": config.kmer_len, "num_out": config.num_out,
        "stride": config.stride, "sequence_stride": config.sequence_stride,
    })
    modbases = {"mod_bases": "".join(mods.codes), "motif": mods.motif,
                "motif_offset": mods.motif_offset}
    modbases.update({f"mod_long_names_{i}": n for i, n in enumerate(mods.long_names)})
    modbases.update({
        "chunk_context_0": ctx.samples_before, "chunk_context_1": ctx.samples_after,
        "chunk_size": ctx.chunk_size, "kmer_context_bases_0": ctx.bases_before,
        "kmer_context_bases_1": ctx.bases_after, "reverse_signal": ctx.reverse,
        "base_start_justify": ctx.base_start_justify,
    })
    lines += _toml_table("modbases", modbases)
    if config.refine.do_rough_rescale:
        lines += _toml_table("refinement", {"refine_do_rough_rescale": 1,
                                            "refine_kmer_center_idx": config.refine.center_idx})
    for key in ("signal_encoder", "sequence_encoder", "encoder"):
        for layer in getattr(config, key):
            lines += _toml_table(f"{key}.sublayers", layer, array=True)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# polish models (secondary/): config.toml tables in the reference schema
# (model_config.cpp:94-180) that ``secondary.architectures.parse_model_config``
# reads. The released polish models' configs and weights are not in the
# repository (``secondary/model_resolver.py`` names them): these are the
# widths the JAX package's code and tests give, and wait for those files.
# ---------------------------------------------------------------------------

POLISH_GRU_NAME = "dna_r10.4.1_e8.2_400bps_hac@v4.3.0_polish"
POLISH_RL_NAME = "dna_r10.4.1_e8.2_400bps_hac@v5.0.0_polish_rl"


def polish_gru_config(gru_size: int = 128) -> dict:
    """The counts model (``POLISH_GRU_NAME``, the legacy LUT's name for hac
    v4.3): GRUModel with ``num_features`` 10 (the pileup's "acgtACGTdD"
    columns, ``secondary/pileup.py``), 5 classes ("*ACGT"), ``gru_size``
    128, 2 layers, bidirectional (the JAX ``init_gru_params`` defaults,
    ``dorado_tpu/secondary/model.py:18-26``, and the schema test's kwargs,
    ``tests/test_secondary_zoo.py:359-361``); the counts encoder normalised
    by depth (``normalise = "total"``, NormaliseType::TOTAL) and the haploid
    label scheme, as in that test. ``gru_size`` narrows it for tests."""
    return {
        "config_version": 1,
        "basecaller_model": "dna_r10.4.1_e8.2_400bps_hac@v4.3.0",
        "model": {"type": "GRUModel", "kwargs": {
            "num_features": 10, "num_classes": 5, "gru_size": gru_size, "n_layers": 2,
            "bidirectional": True}},
        "feature_encoder": {"type": "CountsFeatureEncoder", "kwargs": {"normalise": "total"}},
        "label_scheme": {"type": "HaploidLabelScheme"},
    }


def polish_rl_config(lstm_size: int = 128, cnn_size: int = 128,
                     kernel_sizes: tuple = (1, 17)) -> dict:
    """The read-level model (``POLISH_RL_NAME``, the LUT's name for hac
    v5.0): LatentSpaceLSTM with ``lstm_size`` 128, ``cnn_size`` 128,
    ``kernel_sizes`` (1, 17), mean pooling, no dwells, bases and strand
    embedded in 6 of an alphabet of 6, bidirectional, 5 classes (the JAX
    ``LatentSpaceLSTMConfig`` defaults,
    ``dorado_tpu/secondary/architectures.py:263-273``); the read-alignment
    encoder at ``max_reads`` 100 (the JAX command's default,
    ``dorado_tpu/cli/main.py:1981``) without the dwell, haplotype and snp_qv
    columns (its defaults), and the haploid label scheme. The sizes narrow
    it for tests."""
    return {
        "config_version": 1,
        "basecaller_model": "dna_r10.4.1_e8.2_400bps_hac@v5.0.0",
        "model": {"type": "LatentSpaceLSTM", "kwargs": {
            "num_classes": 5, "lstm_size": lstm_size, "cnn_size": cnn_size,
            "kernel_sizes": list(kernel_sizes), "pooler_type": "mean", "use_dwells": False,
            "bases_alphabet_size": 6, "bases_embedding_size": 6, "bidirectional": True}},
        "feature_encoder": {"type": "ReadAlignmentFeatureEncoder", "kwargs": {
            "max_reads": 100, "include_dwells": False, "include_haplotype": False,
            "include_snp_qv": False}},
        "label_scheme": {"type": "HaploidLabelScheme"},
    }


def polish_config_toml(config: dict) -> str:
    """The ``config.toml`` of a polish model directory for a preset's
    tables."""
    lines = [f"{k} = {_toml_value(v)}" for k, v in config.items() if not isinstance(v, dict)]
    lines.append("")
    for name, table in config.items():
        if not isinstance(table, dict):
            continue
        lines += _toml_table(name, {k: v for k, v in table.items() if k != "kwargs"})
        if "kwargs" in table:
            lines += _toml_table(f"{name}.kwargs", table["kwargs"])
    return "\n".join(lines)


def save_polish_model(config: dict, model, path: Path | str, tensor_files: bool = False) -> Path:
    """A polish model directory at ``path``: ``config.toml`` for ``config``
    (a preset's tables) and ``model``'s state dict as ``weights.pt``, or, for
    a GRUModel with ``tensor_files``, one ``<name>.tensor`` file a weight
    (the layout of the CLI's ``--model-params``). The resolver, as the JAX
    package's, loads a GRUModel's ``weights.pt`` only."""
    import torch

    from dorado_tpu_torch.secondary.model import save_gru_tensor_dir

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.toml").write_text(polish_config_toml(config))
    if tensor_files:
        if config["model"]["type"] != "GRUModel":
            raise ValueError(".tensor files hold a GRUModel's weights only")
        save_gru_tensor_dir(model, path)
    else:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   path / "weights.pt")
    return path


# ---------------------------------------------------------------------------
# variant models: stand-ins. No released variant model's config or weights
# is in the repository; these are the JAX package's config defaults
# (``SlotAttentionConfig``, ``VariantPerceiverConfig``), read by the same
# ``parse_model_config`` and ``model_factory``.
# ---------------------------------------------------------------------------


def _variant_encoder() -> dict:
    """The read-alignment encoder of the variant stand-ins: 100 reads a
    column (the JAX command's default) with the haplotype column, so that
    ``variant``'s default local phasing fills it. The dwell column is on as
    well: the models read the haplotag at column 5 (``DEFAULT_FEATURE_COLUMNS``),
    after base, qual, strand, mapq and the dwell (zeros without move
    tables)."""
    return {"type": "ReadAlignmentFeatureEncoder", "kwargs": {
        "max_reads": 100, "include_dwells": True, "include_haplotype": "true",
        "include_snp_qv": False}}


def slot_attention_config(read_embedding_size: int = 128, cnn_size: int = 128,
                          kernel_sizes: tuple = (1, 17), add_lstm: bool = False) -> dict:
    """A stand-in SlotAttentionConsensus config (no released one is in the
    repository): 2 slots of 5 classes, read embedding 128, cnn 128, kernels
    (1, 17), mean pooling, haplotags embedded, bases and strand in 6 of an
    alphabet of 6 (the JAX ``SlotAttentionConfig`` defaults but
    ``use_haplotags``), on ``_variant_encoder``; the diploid label scheme.
    ``add_lstm`` adds the four alternating LSTMs at 2 x read embedding; the
    sizes narrow it for tests."""
    return {
        "config_version": 1,
        "basecaller_model": "dna_r10.4.1_e8.2_400bps_hac@v5.0.0",
        "model": {"type": "SlotAttentionConsensus", "kwargs": {
            "num_slots": 2, "classes_per_slot": 5, "read_embedding_size": read_embedding_size,
            "cnn_size": cnn_size, "kernel_sizes": list(kernel_sizes), "pooler_type": "mean",
            "use_mapqc": False, "use_dwells": False, "use_haplotags": True,
            "use_snp_qv": False, "bases_alphabet_size": 6, "bases_embedding_size": 6,
            "add_lstm": add_lstm, "use_reference": False}},
        "feature_encoder": _variant_encoder(),
        "label_scheme": {"type": "DiploidLabelScheme"},
    }


def variant_perceiver_config(dimension: int = 256, num_blocks: int = 4, num_heads: int = 8,
                             read_embedding_size: int = 128, cnn_size: int = 128,
                             kernel_sizes: tuple = (1, 17), use_decoder_lstm: bool = False,
                             update_read_embeddings: bool = False) -> dict:
    """A stand-in VariantPerceiver config (no released one is in the
    repository): ploidy 2, 5 classes, dimension 256, 4 blocks of 8 heads,
    read embedding 128, cnn 128, kernels (1, 17), haplotags embedded (the
    JAX ``VariantPerceiverConfig`` defaults but ``use_haplotags``), on
    ``_variant_encoder``; the diploid label scheme. ``use_decoder_lstm``
    adds the forward LSTM at ``dimension`` over the latent,
    ``update_read_embeddings`` the haplotypes-to-reads attention of every
    block but the last; the sizes narrow it for tests."""
    return {
        "config_version": 1,
        "basecaller_model": "dna_r10.4.1_e8.2_400bps_hac@v5.0.0",
        "model": {"type": "VariantPerceiver", "kwargs": {
            "ploidy": 2, "num_classes": 5, "read_embedding_size": read_embedding_size,
            "cnn_size": cnn_size, "kernel_sizes": list(kernel_sizes), "dimension": dimension,
            "num_blocks": num_blocks, "num_heads": num_heads, "use_mapqc": False,
            "use_dwells": False, "use_haplotags": True, "use_snp_qv": False,
            "bases_alphabet_size": 6, "bases_embedding_size": 6,
            "use_decoder_lstm": use_decoder_lstm,
            "update_read_embeddings": update_read_embeddings}},
        "feature_encoder": _variant_encoder(),
        "label_scheme": {"type": "DiploidLabelScheme"},
    }
