"""MinKNOW sample sheet parsing.

Port of ``dorado_tpu/utils/sample_sheet.py``, which reproduces the reference's `utils::SampleSheet` (utils/SampleSheet.cpp:1-449):
CSV with a validated header set, one experiment per file, barcode→alias/type
mapping keyed optionally on flow_cell_id / position_id / experiment_id, and a
permitted-barcode filter fed to the barcode classifier
(BarcodeClassifierNode.cpp:124-137).
"""

from __future__ import annotations

import re
from typing import Optional

ALLOWED_COLUMNS = {
    "protocol_run_id",
    "flow_cell_id",
    "position_id",
    "sample_id",
    "experiment_id",
    "flow_cell_product_code",
    "kit",
    "alias",
    "type",
    "barcode",
}
MAX_USER_FIELD_LENGTH = 40
_FREETEXT_RE = re.compile(r"^[A-Za-z0-9_-]*$")
_BARCODE_ALIAS_RE = re.compile(r"^barcode(\d{2})$")
UNCLASSIFIED = "unclassified"


class SampleSheetError(RuntimeError):
    pass


def _valid_freetext(value: str) -> bool:
    return len(value) <= MAX_USER_FIELD_LENGTH and bool(_FREETEXT_RE.match(value))


class SampleSheet:
    """type is "barcode" when a barcode column is present, else "none"."""

    def __init__(self, filename: str = "", skip_index_matching: bool = False):
        self.filename = filename
        self.skip_index_matching = skip_index_matching
        self.type = "none"
        self._has_flow_cell_id = False
        self._has_position_id = False
        self._columns: dict[str, int] = {}
        self._rows: list[list[str]] = []
        self._allowed_barcodes: Optional[set[str]] = None
        if filename:
            self.load(filename)

    # -- loading ---------------------------------------------------------
    def load(self, filename: str) -> None:
        self.filename = filename
        # newline=None handles \n, \r\n and bare-\r files (SampleSheet.cpp
        # EolFileFormat detection)
        with open(filename, "r", newline=None) as fh:
            lines = [ln for ln in fh.read().splitlines()]
        if not lines:
            raise SampleSheetError(
                f"Cannot read column headers from sample sheet file {filename}"
            )
        col_names = lines[0].split(",")
        self._validate_headers(col_names, filename)
        self._columns = {name: i for i, name in enumerate(col_names)}

        expected_experiment_id = ""
        for line in lines[1:]:
            if not line:
                continue
            row = line.split(",")
            if len(row) != len(self._columns):
                raise SampleSheetError(
                    f"Row in sample sheet file {filename} has incorrect number of entries"
                )
            experiment_id = row[self._columns["experiment_id"]]
            if not expected_experiment_id:
                expected_experiment_id = experiment_id
            elif expected_experiment_id != experiment_id:
                raise SampleSheetError(
                    f"Sample sheet file {filename} contains more than one experiment_id"
                )
            for key in ("experiment_id", "sample_id", "alias"):
                self._validate_text(row, key)
            self._validate_alias(row, "alias")
            self._rows.append(row)

        if self.skip_index_matching and not self._is_barcode_mapping_unique():
            raise SampleSheetError(
                "Unable to infer barcode aliases from sample sheet file: "
                f"{filename} does not contain a unique mapping of barcode ids."
            )

        if self.type == "barcode":
            idx = self._columns["barcode"]
            self._allowed_barcodes = {row[idx] for row in self._rows}

    def _validate_headers(self, col_names: list[str], filename: str) -> None:
        for name in col_names:
            if name not in ALLOWED_COLUMNS:
                raise SampleSheetError(
                    f"Sample sheet {filename} contains invalid column {name}"
                )
        self._has_flow_cell_id = "flow_cell_id" in col_names
        self._has_position_id = "position_id" in col_names
        if not (self._has_flow_cell_id or self._has_position_id):
            raise SampleSheetError(
                f"Sample sheet {filename} must contain at least one of the "
                "'flow_cell_id', and 'position_id' columns."
            )
        if "experiment_id" not in col_names:
            raise SampleSheetError(
                f"Sample sheet {filename} must contain experiment_id column."
            )
        if "kit" not in col_names:
            raise SampleSheetError(f"Sample sheet {filename} must contain kit column.")
        self.type = "barcode" if "barcode" in col_names else "none"
        has_alias = "alias" in col_names
        if self.type != "none" and not has_alias:
            raise SampleSheetError(
                f"Sample sheet {filename} contains barcode columns but alias "
                "column is missing."
            )
        if self.type == "none" and has_alias:
            raise SampleSheetError(
                f"Sample sheet {filename} contains alias column but barcode "
                "columns are missing."
            )

    def _validate_text(self, row: list[str], key: str) -> None:
        idx = self._columns.get(key)
        if idx is not None and not _valid_freetext(row[idx]):
            raise SampleSheetError(
                f"{key} '{row[idx]}' is not a valid string (at most "
                f"{MAX_USER_FIELD_LENGTH} alphanumerical characters including "
                "'-' and '_')"
            )

    def _validate_alias(self, row: list[str], key: str) -> None:
        idx = self._columns.get(key)
        if idx is not None:
            value = row[idx]
            if _BARCODE_ALIAS_RE.match(value) or value == UNCLASSIFIED:
                raise SampleSheetError(f"{key} {value} is a forbidden alias")

    def _is_barcode_mapping_unique(self) -> bool:
        for col, flag in (
            ("flow_cell_id", self._has_flow_cell_id),
            ("position_id", self._has_position_id),
        ):
            if flag and self._rows:
                idx = self._columns[col]
                first = self._rows[0][idx]
                if any(row[idx] != first for row in self._rows):
                    return False
        idx = self._columns.get("barcode")
        if idx is None:
            return len(self._rows) == 0
        return len({row[idx] for row in self._rows}) == len(self._rows)

    # -- lookups ---------------------------------------------------------
    def _get(self, row: list[str], key: str) -> str:
        idx = self._columns.get(key)
        return row[idx] if idx is not None else ""

    def _check_index(self, flow_cell_id: str, position_id: str) -> bool:
        if self.skip_index_matching:
            return True
        ok = self._has_flow_cell_id or self._has_position_id
        if self._has_flow_cell_id:
            ok = ok and bool(flow_cell_id)
        if self._has_position_id:
            ok = ok and bool(position_id)
        return ok

    def _match_index(
        self, row: list[str], flow_cell_id: str, position_id: str, experiment_id: str
    ) -> bool:
        if self.skip_index_matching:
            return True
        if self._get(row, "experiment_id") != experiment_id:
            return False
        if self._has_flow_cell_id and self._get(row, "flow_cell_id") != flow_cell_id:
            return False
        if self._has_position_id and self._get(row, "position_id") != position_id:
            return False
        return True

    def _get_value(
        self,
        column: str,
        flow_cell_id: str,
        position_id: str,
        experiment_id: str,
        barcode: str,
    ) -> str:
        if self.type != "barcode" or not self._check_index(flow_cell_id, position_id):
            return ""
        # trim any "KITNAME_" prefix off the barcode (SampleSheet.cpp:221-225)
        barcode_only = barcode.split("_", 1)[-1] if "_" in barcode else barcode
        for row in self._rows:
            if (
                self._match_index(row, flow_cell_id, position_id, experiment_id)
                and self._get(row, "barcode") == barcode_only
            ):
                return self._get(row, column)
        return ""

    def get_alias(
        self,
        barcode: str,
        flow_cell_id: str = "",
        position_id: str = "",
        experiment_id: str = "",
    ) -> str:
        return self._get_value("alias", flow_cell_id, position_id, experiment_id, barcode)

    def get_sample_type(
        self,
        barcode: str,
        flow_cell_id: str = "",
        position_id: str = "",
        experiment_id: str = "",
    ) -> str:
        return self._get_value("type", flow_cell_id, position_id, experiment_id, barcode)

    def get_barcode_values(self) -> Optional[set[str]]:
        return self._allowed_barcodes

    def barcode_is_permitted(self, barcode_name: str) -> bool:
        if self._allowed_barcodes is None:
            return True
        return barcode_name in self._allowed_barcodes
