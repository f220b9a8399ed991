"""Modified-base model config parsing.

Port of ``dorado_tpu/modbase/config.py`` (parity with dorado/config/
ModBaseModelConfig.{h,cpp}): general params (model type, size, kmer_len,
num_out, stride), modification params (codes, long names, motif), context
params (chunk context/size, kmer context bases, reverse, justify), refinement
params (rough rescale, kmer center index).
"""

from __future__ import annotations

import dataclasses
import tomllib
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

BASE_IDS = {"A": 0, "C": 1, "G": 2, "T": 3}


class ModBaseModelType(Enum):
    CONV_LSTM_V1 = "conv_lstm"
    CONV_LSTM_V2 = "conv_lstm_v2"
    CONV_LSTM_V3 = "conv_lstm_v3"
    CONV_V1 = "conv_only"


@dataclass
class ModificationParams:
    codes: list[str]  # e.g. ["h", "m"]
    long_names: list[str]  # e.g. ["5hmC", "5mC"]
    motif: str  # e.g. "CG"
    motif_offset: int

    @property
    def count(self) -> int:
        return len(self.codes)

    @property
    def base(self) -> str:
        b = self.motif[self.motif_offset]
        if b not in BASE_IDS:
            raise ValueError(f"invalid canonical base {b!r} in motif {self.motif!r}")
        return b

    @property
    def base_id(self) -> int:
        return BASE_IDS[self.base]


@dataclass
class ContextParams:
    samples_before: int
    samples_after: int
    chunk_size: int
    bases_before: int
    bases_after: int
    reverse: bool
    base_start_justify: bool

    @property
    def samples(self) -> int:
        return self.samples_before + self.samples_after

    @property
    def kmer_len(self) -> int:
        return self.bases_before + self.bases_after + 1

    def normalised(self, stride: int) -> "ContextParams":
        """Sample counts rounded up to multiples of ``stride``
        (ModBaseModelConfig.cpp ContextParams::normalised)."""

        def norm(v):
            return -(-v // stride) * stride

        return dataclasses.replace(
            self,
            samples_before=norm(self.samples_before),
            samples_after=norm(self.samples_after),
            chunk_size=norm(self.chunk_size),
        )


@dataclass
class RefinementParams:
    do_rough_rescale: bool = False
    center_idx: int = 0


@dataclass
class ModBaseModelConfig:
    model_path: Path
    model_type: ModBaseModelType
    size: int
    kmer_len: int
    num_out: int
    stride: int
    sequence_stride: int
    mods: ModificationParams
    context: ContextParams
    refine: RefinementParams
    # the sublayers of a v3 model, as the toml lists them
    sequence_encoder: list[dict] = field(default_factory=list)
    signal_encoder: list[dict] = field(default_factory=list)
    encoder: list[dict] = field(default_factory=list)

    @property
    def is_chunked_input_model(self) -> bool:
        return self.model_type in (
            ModBaseModelType.CONV_LSTM_V2,
            ModBaseModelType.CONV_LSTM_V3,
        )

    @property
    def num_states(self) -> int:
        """Output states: the modifications and the canonical base."""
        return self.mods.count + 1


def load_modbase_config(path: Path | str) -> ModBaseModelConfig:
    path = Path(path)
    with open(path / "config.toml", "rb") as f:
        toml = tomllib.load(f)

    general = toml["general"]
    model_type = ModBaseModelType(general["model"])
    mp = toml["model_params"]
    mb = toml["modbases"]

    codes = mb["mod_bases"]
    if isinstance(codes, str):
        # older configs give the codes as one string, such as "hm"
        codes = list(codes)
    long_names = [mb[f"mod_long_names_{i}"] for i in range(len(codes))]

    mods = ModificationParams(
        codes=codes,
        long_names=long_names,
        motif=mb["motif"],
        motif_offset=int(mb["motif_offset"]),
    )

    ctx_before = int(mb["chunk_context_0"])
    ctx_after = int(mb["chunk_context_1"])
    context = ContextParams(
        samples_before=ctx_before,
        samples_after=ctx_after,
        chunk_size=int(mb.get("chunk_size", ctx_before + ctx_after)),
        bases_before=int(mb["kmer_context_bases_0"]),
        bases_after=int(mb["kmer_context_bases_1"]),
        reverse=bool(mb.get("reverse_signal", False)),
        base_start_justify=bool(mb.get("base_start_justify", False)),
    )

    refine = RefinementParams()
    if "refinement" in toml:
        r = toml["refinement"]
        refine = RefinementParams(
            do_rough_rescale=int(r.get("refine_do_rough_rescale", 0)) == 1,
            center_idx=int(r.get("refine_kmer_center_idx", 0)),
        )

    def sublayers(key):
        return list(toml.get(key, {}).get("sublayers", []))

    return ModBaseModelConfig(
        model_path=path,
        model_type=model_type,
        size=int(mp["size"]),
        kmer_len=int(mp["kmer_len"]),
        num_out=int(mp["num_out"]),
        stride=int(mp.get("stride", 1)),
        sequence_stride=int(mp.get("sequence_stride", 1)),
        mods=mods,
        context=context,
        refine=refine,
        sequence_encoder=sublayers("sequence_encoder"),
        signal_encoder=sublayers("signal_encoder"),
        encoder=sublayers("encoder"),
    )


def validate_modbase_compat(config: ModBaseModelConfig, canonical_stride: int) -> None:
    """A chunked model's stride must divide the canonical model's stride."""
    if config.is_chunked_input_model and canonical_stride % config.stride != 0:
        raise ValueError(
            f"modbase stride {config.stride} incompatible with canonical "
            f"stride {canonical_stride}"
        )
