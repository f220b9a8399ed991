"""Polish model resolution, from local directories only.

Port of ``dorado_tpu/secondary/model_resolver.py`` (the reference's
cli_lib/polish.cpp:515-640): ``--model auto`` reads the basecaller model
name from the input BAM's @RG DS ``basecall_model=`` field and maps it
through the basecaller -> polish lookup tables; a name resolves to a
directory under ``--models-directory``; a path is used as it is. The port
has no model downloader: a name without a local directory is refused with
a ValueError that says so.

A resolved directory holds a reference-schema config.toml and either
``model.pt`` (TorchScript, run as an opaque module) or ``weights.pt`` (a
torch state dict). As in the JAX package, ``weights.pt`` loads into a
``GRUModel`` only; other architectures are refused with a ValueError.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

# cli_lib/polish.cpp:517-541 lookup tables (transcribed ONT release metadata)
LUT_LEGACY_POLISH = {
    "dna_r10.4.1_e8.2_400bps_hac@v4.2.0": "dna_r10.4.1_e8.2_400bps_hac@v4.2.0_polish",
    "dna_r10.4.1_e8.2_400bps_sup@v4.2.0": "dna_r10.4.1_e8.2_400bps_sup@v4.2.0_polish",
    "dna_r10.4.1_e8.2_400bps_hac@v4.3.0": "dna_r10.4.1_e8.2_400bps_hac@v4.3.0_polish",
    "dna_r10.4.1_e8.2_400bps_sup@v4.3.0": "dna_r10.4.1_e8.2_400bps_sup@v4.3.0_polish",
}
LUT_POLISH = {
    "dna_r10.4.1_e8.2_400bps_hac@v5.0.0": "dna_r10.4.1_e8.2_400bps_hac@v5.0.0_polish_rl",
    "dna_r10.4.1_e8.2_400bps_sup@v5.0.0": "dna_r10.4.1_e8.2_400bps_sup@v5.0.0_polish_rl",
    "dna_r10.4.1_e8.2_400bps_hac@v5.2.0": "dna_r10.4.1_e8.2_400bps_hac@v5.2.0_polish_rl",
    "dna_r10.4.1_e8.2_400bps_sup@v5.2.0": "dna_r10.4.1_e8.2_400bps_sup@v5.2.0_polish_rl",
}
BACTERIAL_MODEL = "dna_r10.4.1_e8.2_400bps_polish_bacterial_methylation_v5.0.0"


def basecaller_model_from_header(header_text: str) -> str | None:
    """basecall_model=<name> from the first @RG DS field
    (polish.cpp parse_basecaller_model_from_header)."""
    for line in header_text.splitlines():
        if not line.startswith("@RG"):
            continue
        m = re.search(r"basecall_model=([^\s,;]+)", line)
        if m:
            return m.group(1)
    return None


def resolve_polish_model_name(basecaller_model: str, bacteria: bool = False) -> str | None:
    """basecaller model name -> polish model name via the reference LUTs."""
    if bacteria:
        return BACTERIAL_MODEL if basecaller_model in (LUT_LEGACY_POLISH | LUT_POLISH) else None
    return LUT_POLISH.get(basecaller_model) or LUT_LEGACY_POLISH.get(basecaller_model)


def resolve_model_dir(
    model_arg: str,
    header_text: str = "",
    bacteria: bool = False,
    models_directory: str | Path | None = None,
) -> Path:
    """--model {auto | name | path} -> on-disk model directory.

    Raises ValueError with an actionable message on any resolution failure
    (unknown basecaller model, a name with no directory under
    ``models_directory``)."""
    p = Path(model_arg)
    if p.is_dir():
        return p
    if model_arg == "auto":
        bc = basecaller_model_from_header(header_text)
        if not bc:
            raise ValueError(
                "--model auto requires a basecall_model= entry in the input "
                "BAM's @RG DS header; pass an explicit model name or path."
            )
        name = resolve_polish_model_name(bc, bacteria=bacteria)
        if not name:
            raise ValueError(f"No polish model is known for basecaller model {bc!r}.")
    else:
        name = model_arg

    models_directory = Path(models_directory or ".")
    local = models_directory / name
    if local.is_dir():
        return local
    raise ValueError(
        f"Polish model {name!r} is not a directory under {str(models_directory)!r}: the port "
        f"has no model downloader, so pass the path of a model directory or put the model "
        f"there."
    )


def load_resolved_model(model_dir: Path | str, device: torch.device | str = "cpu"):
    """(model, model_config_dict, feature_kind) from a resolved model
    directory: model.pt -> a TorchScript module on ``device``; weights.pt ->
    a GRUModel's state dict (on the CPU; the pipeline moves it), as in the
    JAX package, which refuses other architectures' weights.pt."""
    from dorado_tpu_torch.secondary.architectures import parse_model_config
    from dorado_tpu_torch.secondary.model import TorchScriptConsensusModel, gru_model_from_state

    model_dir = Path(model_dir)
    mc = parse_model_config(model_dir / "config.toml")
    feature_kind = "counts" if mc["model_type"] == "GRUModel" else "read_level"

    if (model_dir / "model.pt").exists():
        return TorchScriptConsensusModel(model_dir / "model.pt", device), mc, feature_kind

    weights = model_dir / "weights.pt"
    if not weights.exists():
        raise ValueError(f"Model dir {model_dir} has neither model.pt nor weights.pt.")
    state = torch.load(str(weights), map_location="cpu")
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if mc["model_type"] != "GRUModel":
        # as the JAX loader (dorado_tpu/secondary/model_resolver.py:137-143): other architectures
        # ship as TorchScript
        raise ValueError(
            f"weights.pt loading is implemented for GRUModel; {mc['model_type']} "
            "models ship as TorchScript (model.pt) which is supported directly."
        )
    return gru_model_from_state(state), mc, feature_kind
