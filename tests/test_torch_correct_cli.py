"""``python -m dorado_tpu_torch correct`` against ``dorado_tpu.cli.main``'s
on the CPU, both in process, on the same seeded FASTQ (12 reads of
4.5-6.5 kb from both strands of a 7 kb genome at 5% errors: the NN path
takes only alignments that span a whole window of 4096) and the same
weights: equal FASTA, PAF and printed block counts, and equal exit codes,
for the vote consensus, ``--nn`` (the full-width model), ``--to-paf``, and
``--from-paf`` against a run that maps (one index block's targets),
``--resume-from`` (and its missing file), ``--compute-num-blocks``,
``--run-block-id`` out of range, the overlap-index options and
``--model-path`` with a scripted HERRO-contract module.

The JAX command draws its random NN weights from ``PRNGKey(0)``; the port's
command builds its model through ``nn_model.init_correction_model``, patched
here to return those weights carried across."""

import jax
import numpy as np
import pytest
import torch

from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.correct import nn_model as jax_nn
from dorado_tpu_torch.cli.main import main as torch_main
from dorado_tpu_torch.correct import nn_model
from dorado_tpu_torch.utils.torchscript import script_and_save
from tests.torch_correct import HerroContract, correct_reads
from tests.torch_polish import write_fastq

# -i 5k cuts the reads into blocks of one or two reads
BLOCK = ["-i", "5k", "--run-block-id", "1"]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("correct_cli")
    reads = correct_reads(21, 7000, 12, (4500, 6500), error=0.05)
    return {"dir": tmp, "reads": reads, "fastq": write_fastq(tmp / "reads.fastq", reads)}


@pytest.fixture
def same_weights(monkeypatch):
    """The port's random correction model patched to the JAX command's
    ``PRNGKey(0)`` weights; the number of models the port's command built."""
    built = []
    params = jax.tree.map(np.asarray, jax_nn.init_correction_model(jax.random.PRNGKey(0)))

    def init(generator, cfg=None):
        built.append(cfg)
        model = nn_model.CorrectionModel(cfg)
        model.load_state_dict(nn_model.correction_state_dict(params))
        return model.eval()

    monkeypatch.setattr(nn_model, "init_correction_model", init)
    return built


def _cli(capfd, main, argv, out):
    capfd.readouterr()
    rc = main([*argv, "-o", str(out)])
    return rc, capfd.readouterr()


def parity(capfd, data, tag, argv, rc=0):
    """Both commands on the CPU: equal exit codes and output text; (the
    output text, the port's stderr)."""
    texts = {}
    for who, main in (("jax", jax_main), ("torch", torch_main)):
        out = data["dir"] / f"{tag}_{who}.out"
        got, printed = _cli(capfd, main, [*argv, "-x", "cpu", "-t", "2"], out)
        assert got == rc, printed.err
        texts[who] = (out.read_text() if out.exists() else "") + printed.out
    assert texts["torch"] == texts["jax"]
    return texts["torch"], printed.err


def fasta(text: str) -> dict[str, str]:
    out, name = {}, None
    for line in text.splitlines():
        if line.startswith(">"):
            name = line[1:]
            out[name] = ""
        else:
            out[name] += line
    return out


@pytest.fixture(scope="module")
def paf(data):
    """The overlaps of both commands' ``--to-paf`` (equal), as a PAF file
    that the other cases read back with ``-p`` instead of mapping again."""
    texts = {}
    for who, main in (("jax", jax_main), ("torch", torch_main)):
        out = data["dir"] / f"paf_{who}.paf"
        assert main(["correct", str(data["fastq"]), "--to-paf", "-x", "cpu", "-t", "2",
                     "-o", str(out)]) == 0
        texts[who] = out.read_text()
    assert texts["torch"] == texts["jax"]
    assert len(texts["torch"].splitlines()) > 50 and "\tcg:Z:" in texts["torch"]
    return data["dir"] / "paf_torch.paf"


def test_vote_consensus(capfd, data, paf):
    text, err = parity(capfd, data, "vote", ["correct", str(data["fastq"]), "-p", str(paf)])
    got = fasta(text)
    assert len(got) == 12 and "> Corrected 12/12 reads" in err
    assert sum(got[n] != s for n, s, _ in data["reads"]) >= 10


def test_nn(capfd, data, paf, same_weights):
    text, err = parity(capfd, data, "nn", ["correct", str(data["fastq"]), "--nn", "-p", str(paf)])
    assert same_weights == [None] and "window(s) on cpu" in err
    windows = int(err.split(" window(s)")[0].split("> ")[-1])
    got = fasta(text)
    assert len(got) == 12 and windows >= 10
    assert sum(got[n] != s for n, s, _ in data["reads"]) >= 6


def test_from_paf_equals_a_direct_run(capfd, data, paf, same_weights):
    """--from-paf reads the overlaps back and corrects as a run that maps
    them itself does (the block's targets: the index holds those reads)."""
    direct, err = parity(capfd, data, "direct", ["correct", str(data["fastq"]), "--nn", *BLOCK])
    text, err = parity(capfd, data, "from_paf",
                       ["correct", str(data["fastq"]), "--nn", *BLOCK, "-p", str(paf)])
    assert text == direct and "> Loaded" in err and "PAF overlaps" in err


def test_resume(capfd, data, paf):
    """Resuming after the furthest read of the skip set (':'-suffixed and
    tab-separated names among them); a missing skip file exits 1."""
    skip = data["dir"] / "done.txt"
    skip.write_text(f"{data['reads'][2][0]}:0\textra\n\n{data['reads'][7][0]} x\n")
    text, err = parity(capfd, data, "resume", [
        "correct", str(data["fastq"]), "--resume-from", str(skip), "-p", str(paf)])
    assert list(fasta(text)) == [n for n, _, _ in data["reads"][8:]] and "Resuming" in err
    _, err = parity(capfd, data, "resume_missing", [
        "correct", str(data["fastq"]), "--resume-from", str(data["dir"] / "none.txt")], rc=1)
    assert "does not exist" in err


def test_blocks(capfd, data):
    text, _ = parity(capfd, data, "blocks",
                     ["correct", str(data["fastq"]), "-i", "20k", "--compute-num-blocks"])
    assert int(text) >= 2
    _, err = parity(capfd, data, "block_range",
                    ["correct", str(data["fastq"]), "--run-block-id", "99"], rc=1)
    assert "out of range" in err


def test_overlap_index_options(capfd, data):
    """The overlap index's k, window and chain score, over one block's index."""
    text, _ = parity(capfd, data, "index_opts", [
        "correct", str(data["fastq"]), "--to-paf", *BLOCK, "--kmer-size", "13",
        "--ovl-window-size", "8", "--min-chain-score", "60"])
    assert text.count("\n") > 10


def test_model_path(capfd, data, paf):
    """A HERRO TorchScript module (``--model-path``) on the CPU: both commands
    load the same file and correct the reads the same way."""
    path = data["dir"] / "herro.pt"
    script_and_save(HerroContract(nn_model.init_correction_model(
        torch.Generator().manual_seed(4), nn_model.CorrectionModelConfig(dim=32, depth=2))),
        path)
    text, err = parity(capfd, data, "model_path",
                       ["correct", str(data["fastq"]), "--model-path", str(path), "-p",
                        str(paf)])
    assert "Loaded TorchScript scorer" in err and len(fasta(text)) == 12


def test_nn_defaults_to_cuda(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main(["correct", str(data["fastq"]), "--nn", *BLOCK,
                    "-o", str(data["dir"] / "x.fa")])
