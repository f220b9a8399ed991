"""Custom barcode kit (arrangement) parsing.

Port of ``dorado_tpu/demux/custom_kit.py``, which reproduces
demux/parse_custom_kit.cpp:22-200: an arrangement TOML defines a
kit (flanks, barcode name pattern, index range, optional second end and
scoring overrides); barcode sequences come from a FASTA
(parse_custom_sequences.cpp:10-27). The parsed kit uses the same dict schema
as the port's ``demux/barcode_kits_data.json``, so ``BarcodeClassifier``
consumes it unchanged.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

DEFAULT_SCORING_PARAMS = {
    "max_barcode_penalty": 9,
    "barcode_end_proximity": 75,
    "min_barcode_penalty_dist": 3,
    "min_separation_only_dist": 6,
    "flank_left_pad": 5,
    "flank_right_pad": 10,
    "front_barcode_window": 175,
    "rear_barcode_window": 175,
    "min_flank_score": 0.5,
    "midstrand_flank_score": 0.95,
}


def check_normalized_id_pattern(pattern: str) -> bool:
    """prefix%\\d*i patterns only (parse_custom_kit.cpp:22-43)."""
    modulo_pos = pattern.find("%")
    if modulo_pos < 0:
        return False
    i_pos = pattern.find("i", modulo_pos)
    if i_pos < 0 or i_pos != len(pattern) - 1:
        return False
    return all(c.isdigit() for c in pattern[modulo_pos + 1 : i_pos])


def _fill_bc_names(pattern: str, start: int, end: int) -> list[str]:
    if not check_normalized_id_pattern(pattern):
        raise ValueError("Barcode pattern must be prefix%\\d+i, e.g. BC%02i")
    modulo_pos = pattern.find("%")
    prefix = pattern[:modulo_pos]
    width_str = pattern[modulo_pos + 1 : -1]
    width = int(width_str) if width_str else 0
    return [f"{prefix}{i:0{width}d}" for i in range(start, end + 1)]


def parse_custom_arrangement(arrangement_file: str | Path):
    """Returns (kit_name, kit_info_dict) (parse_custom_kit.cpp:45-131)."""
    with open(arrangement_file, "rb") as fh:
        config_toml = tomllib.load(fh)
    config = config_toml["arrangement"]
    kit_name = config["name"]

    info = {
        "name": config["kit"],
        "double_ends": False,
        "ends_different": False,
        "rear_only_barcodes": bool(config.get("rear_only_barcodes", False)),
        "rna_barcodes": bool(config.get("rna_barcodes", False)),
        "barcodes2": [],
        "bottom_front_flank": "",
        "bottom_rear_flank": "",
    }

    start, end = int(config["first_index"]), int(config["last_index"])
    if start > end:
        raise ValueError("first_index must be <= last_index in the arrangement file.")

    barcode1_pattern = config["barcode1_pattern"]
    info["top_front_flank"] = config["mask1_front"]
    info["top_rear_flank"] = config["mask1_rear"]
    if not info["top_front_flank"] and not info["top_rear_flank"]:
        raise ValueError("At least one of mask1_front or mask1_rear needs to be specified.")
    info["barcodes"] = _fill_bc_names(barcode1_pattern, start, end)

    if any(k in config for k in ("mask2_front", "mask2_rear", "barcode2_pattern")):
        if not all(k in config for k in ("mask2_front", "mask2_rear", "barcode2_pattern")):
            raise ValueError(
                "For double ended barcodes, mask2_front mask2_rear and "
                "barcode2_pattern must all be set."
            )
        info["bottom_front_flank"] = config["mask2_front"]
        info["bottom_rear_flank"] = config["mask2_rear"]
        if not info["bottom_front_flank"] and not info["bottom_rear_flank"]:
            raise ValueError(
                "At least one of mask2_front or mask2_rear needs to be specified."
            )
        barcode2_pattern = config["barcode2_pattern"]
        info["barcodes2"] = _fill_bc_names(barcode2_pattern, start, end)
        info["double_ends"] = True
        info["ends_different"] = (
            info["bottom_front_flank"] != info["top_front_flank"]
            or info["bottom_rear_flank"] != info["top_rear_flank"]
            or barcode1_pattern != barcode2_pattern
        )

    info["scoring_params"] = parse_scoring_params(arrangement_file)
    return kit_name, info


def parse_scoring_params(
    arrangement_file: str | Path, base_params: dict | None = None
) -> dict:
    """[scoring] overrides on top of the defaults
    (parse_custom_kit.cpp:133-177)."""
    params = dict(base_params or DEFAULT_SCORING_PARAMS)
    with open(arrangement_file, "rb") as fh:
        config_toml = tomllib.load(fh)
    scoring = config_toml.get("scoring", {})
    for key in DEFAULT_SCORING_PARAMS:
        if key in scoring:
            want_float = isinstance(DEFAULT_SCORING_PARAMS[key], float)
            params[key] = (float if want_float else int)(scoring[key])
    return params


def parse_custom_sequences(sequences_file: str | Path) -> dict[str, str]:
    """FASTA/FASTQ of custom barcode/adapter sequences -> {name: seq}
    (parse_custom_sequences.cpp:10-27). Header tags after the name are
    ignored here (adapters carry et/sk tags; barcodes do not)."""
    sequences: dict[str, str] = {}
    text = Path(sequences_file).read_text()
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(">"):
            name = line[1:].split()[0].split("\t")[0]
            i += 1
            seq = []
            while i < len(lines) and not lines[i].startswith((">", "@")):
                seq.append(lines[i])
                i += 1
            sequences[name] = "".join(seq)
        elif line.startswith("@"):
            name = line[1:].split()[0].split("\t")[0]
            sequences[name] = lines[i + 1]
            i += 4
        else:
            i += 1
    return sequences
