"""The port's MinKNOW sample sheet (``dorado_tpu_torch.utils.sample_sheet``)
against the JAX package's on sheets written here: valid and invalid sheets
(with the same error messages), aliases and sample types with and without
index matching, several runs in one sheet, kit-prefixed barcodes and the
permitted barcodes."""

import pytest
import torch

from dorado_tpu.utils.sample_sheet import SampleSheet as JaxSampleSheet
from dorado_tpu.utils.sample_sheet import SampleSheetError as JaxSampleSheetError
from dorado_tpu_torch.utils.sample_sheet import SampleSheet, SampleSheetError

HEAD = "experiment_id,kit,flow_cell_id,position_id,barcode,alias,type"
SHEETS = {
    "single": [HEAD] + [f"exp1,SQK-NBD114-24,FAB001,1A,barcode{i:02d},patient_{i},test_sample"
                        for i in (1, 2, 5, 8)],
    "two_runs": [HEAD,
                 "exp1,SQK-NBD114-24,FAB001,1A,barcode01,left_1,test_sample",
                 "exp1,SQK-NBD114-24,FAB002,1B,barcode01,right_1,negative_control",
                 "exp1,SQK-NBD114-24,FAB002,1B,barcode03,right_3,test_sample"],
    "position_only": ["experiment_id,kit,position_id,barcode,alias",
                      "e,SQK-RBK114-96,X1,barcode07,s7", "e,SQK-RBK114-96,X1,barcode09,s9"],
    "no_barcode": ["experiment_id,kit,flow_cell_id,sample_id", "e,SQK-LSK114,FAB001,sample-1"],
    "crlf": [HEAD, "exp1,SQK-NBD114-24,FAB001,1A,barcode04,crlf_4,test_sample", ""],
}
BAD = {
    "invalid_column": ["experiment_id,kit,flow_cell_id,colour", "e,k,f,red"],
    "no_index": ["experiment_id,kit,barcode,alias", "e,k,barcode01,a"],
    "no_experiment": ["kit,flow_cell_id,barcode,alias", "k,f,barcode01,a"],
    "no_kit": ["experiment_id,flow_cell_id,barcode,alias", "e,f,barcode01,a"],
    "barcode_without_alias": ["experiment_id,kit,flow_cell_id,barcode", "e,k,f,barcode01"],
    "alias_without_barcode": ["experiment_id,kit,flow_cell_id,alias", "e,k,f,a"],
    "short_row": [HEAD, "exp1,k,f,p,barcode01,a"],
    "two_experiments": [HEAD, "e1,k,f,p,barcode01,a,t", "e2,k,f,p,barcode02,b,t"],
    "bad_text": [HEAD, "e1,k,f,p,barcode01,has space,t"],
    "long_text": [HEAD, f"e1,k,f,p,barcode01,{'a' * 41},t"],
    "forbidden_alias": [HEAD, "e1,k,f,p,barcode01,barcode07,t"],
    "unclassified_alias": [HEAD, "e1,k,f,p,barcode01,unclassified,t"],
    "empty": [],
}
LOOKUPS = [
    (bc, fc, pos, exp)
    for bc in ("barcode01", "barcode03", "barcode05", "barcode07", "barcode09", "barcode04",
               "SQK-NBD114-24_barcode02", "NB24_barcode08", "barcode99")
    for fc, pos, exp in (("", "", ""), ("FAB001", "1A", "exp1"), ("FAB002", "1B", "exp1"),
                         ("FAB001", "", "exp1"), ("", "X1", "e"), ("FAB001", "1A", "other"))
]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def write(tmp_path, name, lines, newline="\n"):
    path = tmp_path / f"{name}.csv"
    path.write_bytes(newline.join(lines).encode())
    return str(path)


@pytest.mark.parametrize("name", sorted(SHEETS))
@pytest.mark.parametrize("skip", [False, True])
def test_lookups_match_jax(tmp_path, name, skip):
    path = write(tmp_path, name, SHEETS[name], "\r\n" if name == "crlf" else "\n")
    if skip and name in ("two_runs", "no_barcode"):
        # two flow cells, or no barcodes: no unique mapping without the index
        with pytest.raises(SampleSheetError, match="unique mapping") as ours:
            SampleSheet(path, skip_index_matching=True)
        with pytest.raises(JaxSampleSheetError) as theirs:
            JaxSampleSheet(path, skip_index_matching=True)
        assert str(ours.value) == str(theirs.value)
        return
    ours, theirs = SampleSheet(path, skip), JaxSampleSheet(path, skip)
    assert ours.type == theirs.type
    assert ours.get_barcode_values() == theirs.get_barcode_values()
    aliases = 0
    for args in LOOKUPS:
        assert ours.get_alias(*args) == theirs.get_alias(*args)
        assert ours.get_sample_type(*args) == theirs.get_sample_type(*args)
        assert ours.barcode_is_permitted(args[0]) == theirs.barcode_is_permitted(args[0])
        aliases += bool(ours.get_alias(*args))
    assert aliases > 0 or name == "no_barcode"


def test_two_runs_resolve_per_run(tmp_path):
    sheet = SampleSheet(write(tmp_path, "two_runs", SHEETS["two_runs"]))
    assert sheet.get_alias("barcode01", "FAB001", "1A", "exp1") == "left_1"
    assert sheet.get_alias("barcode01", "FAB002", "1B", "exp1") == "right_1"
    assert sheet.get_alias("barcode01", "FAB002", "1A", "exp1") == ""
    assert sheet.get_sample_type("NB24_barcode01", "FAB002", "1B", "exp1") == "negative_control"
    assert sheet.get_barcode_values() == {"barcode01", "barcode03"}


@pytest.mark.parametrize("name", sorted(BAD))
def test_invalid_sheets_match_jax(tmp_path, name):
    path = write(tmp_path, name, BAD[name])
    with pytest.raises(SampleSheetError) as ours:
        SampleSheet(path)
    with pytest.raises(JaxSampleSheetError) as theirs:
        JaxSampleSheet(path)
    assert str(ours.value) == str(theirs.value)


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        SampleSheet(str(tmp_path / "absent.csv"))
