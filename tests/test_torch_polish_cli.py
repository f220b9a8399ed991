"""``python -m dorado_tpu_torch polish`` against ``dorado_tpu.cli.main``'s
``polish`` on the CPU, both in process, on the same seeded drafts and reads
(``tests/torch_polish.py``) and weights: the same FASTA (or FASTQ) and exit
codes for FASTQ self-alignment, a SAM with two read groups, a ``.tensor``
``--model-params`` directory, ``weights.pt`` and ``model.pt`` model
directories, the read-level model (``--model-config``) and a missing model
name; and the hand-off of ``--vcf``/``--gvcf`` to the variant flow."""

import jax
import numpy as np
import pytest
import torch

from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.secondary import architectures as jax_arch
from dorado_tpu_torch.cli.main import main as torch_main
from dorado_tpu_torch.models import presets
from dorado_tpu_torch.secondary import architectures, model
from dorado_tpu_torch.utils.torchscript import script_and_save
from tests.torch_polish import jax_gru_params, polish_files

# one mapping thread: the test workers share the CPU
WINDOW = ["--window-len", "1000", "--window-overlap", "200", "-t", "1"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the GRU's and the plain LSTM's many small
    operators crawl at their thread-pool barriers when the test workers
    oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return polish_files(tmp_path_factory.mktemp("polish_cli"))


@pytest.fixture(scope="module")
def gru():
    m = model.GRUModel(gru_size=16)
    m.load_state_dict(model.gru_state_dict(jax_gru_params(np.random.RandomState(7))))
    return m.eval()


def _cli(capfd, main, argv, out):
    """(exit code, the output file's text or None, stderr) of an in-process
    run (the JAX command wants a real stderr: fd-level capture)."""
    capfd.readouterr()
    rc = main([*argv, "-o", str(out)])
    return rc, (out.read_text() if rc == 0 else None), capfd.readouterr().err


def _parity(capfd, data, tag, argv, ours_argv=None):
    """Both commands on the CPU: equal exit codes and outputs; the port's
    (exit code, output, stderr)."""
    d = data["dir"]
    rc_j, out_j, err_j = _cli(capfd, jax_main, [*argv, "-x", "cpu"], d / f"{tag}_jax.fa")
    rc_t, out_t, err_t = _cli(capfd, torch_main, [*(ours_argv or argv), "-x", "cpu"],
                              d / f"{tag}_torch.fa")
    assert rc_t == rc_j, (err_t, err_j)
    assert out_t == out_j
    return rc_t, out_t, err_t


def test_fastq_self_alignment_tensor_dir(capfd, data, gru):
    d = presets.save_polish_model(presets.polish_gru_config(16), gru, data["dir"] / "gru_t",
                                  tensor_files=True)
    argv = ["polish", str(data["fastq"]), str(data["fasta"]), "--model-params", str(d),
            *WINDOW]
    rc, fa, _ = _parity(capfd, data, "fastq", argv)
    assert rc == 0 and fa.count(">") == 2
    rc, fq, _ = _parity(capfd, data, "fastq_regions",
                        [*argv, "--regions", "ctg_a:501-1700", "--qualities",
                         "--min-mapq", "5", "--fill-char", "N", "--min-depth", "3"])
    assert rc == 0 and fq.startswith("@ctg_a")


def test_sam_read_groups_weights_pt(capfd, data, gru):
    d = presets.save_polish_model(presets.polish_gru_config(16), gru, data["dir"] / "gru_w")
    base = ["polish", str(data["sam"]), str(data["fasta"]), "-m", str(d), *WINDOW,
            "--regions", "ctg_b"]
    rc, _, err = _parity(capfd, data, "sam_no_rg", base)
    assert rc == 1 and "more than one read group" in err
    rc, fa, err = _parity(capfd, data, "sam_rg", [*base, "--RG", "rg_a"])
    assert rc == 0 and "(counts)" in err
    rc, _, err = _parity(capfd, data, "sam_bad_rg", [*base, "--RG", "nope"])
    assert rc == 1 and "not found" in err
    rc, fa_all, _ = _parity(capfd, data, "sam_all",
                            [*base, "--ignore-read-groups", "--no-fill-gaps"])
    assert rc == 0 and fa_all.startswith(">ctg_b_0 ") and fa_all != fa


def test_model_pt_and_missing_name(capfd, data, gru, tmp_path):
    """A ``model.pt`` scripted from the port's GRUModel, which both packages
    run (the JAX one on the host's torch), by ``-m`` and ``--model-params``;
    a model name with no directory exits 1 (the port: no downloader)."""
    d = tmp_path / "scripted"
    d.mkdir()
    (d / "config.toml").write_text(presets.polish_config_toml(presets.polish_gru_config(16)))
    script_and_save(gru, d / "model.pt")
    base = ["polish", str(data["fastq"]), str(data["fasta"]), *WINDOW]
    rc, _, err = _parity(capfd, data, "model_pt", [*base, "-m", str(d)])
    assert rc == 0
    rc, _, err = _parity(capfd, data, "model_pt_params", [*base, "--model-params", str(d)])
    assert rc == 0 and "TorchScript" in err
    rc, _, err = _parity(capfd, data, "missing", [*base, "-m", presets.POLISH_GRU_NAME,
                                                  "--models-directory", str(tmp_path)])
    assert rc == 1 and "no model downloader" in err


def test_read_level_model(capfd, data, monkeypatch):
    """The JAX command's ``--model-config`` draws LatentSpaceLSTM weights
    from ``PRNGKey(0)``; the port's command, given the same config, builds
    its model through ``model_factory``, patched here to return those
    weights carried across (both packages refuse a LatentSpaceLSTM's
    ``weights.pt``)."""
    cfg = presets.polish_rl_config(16, 12, (1, 5))
    kwargs = cfg["model"]["kwargs"]
    params = jax_arch.model_factory("LatentSpaceLSTM", kwargs)[0]
    m = architectures.LatentSpaceLSTM(architectures.latent_space_lstm_config(kwargs))
    m.load_state_dict(architectures.latent_space_lstm_state_dict(
        jax.tree.map(np.asarray, params)))
    built = []

    def carried(model_type, model_kwargs):
        assert model_type == "LatentSpaceLSTM"
        built.append(model_type)
        return m

    monkeypatch.setattr(architectures, "model_factory", carried)
    config = data["dir"] / "rl.toml"
    config.write_text(presets.polish_config_toml(cfg))
    base = ["polish", str(data["fastq"]), str(data["fasta"]), *WINDOW, "--regions", "ctg_b",
            "--model-config", str(config)]
    rc, fa, err = _parity(capfd, data, "rl", base)
    assert rc == 0 and fa.startswith(">ctg_b") and "LatentSpaceLSTM" in err and built


def test_refusals_and_random_weights(capfd, data, tmp_path):
    """``polish --vcf`` and ``--gvcf`` hand off to the variant flow (a VCF,
    exit 0; ``tests/test_torch_variant_cli.py`` holds it against the JAX
    command's), ``--ambig-ref`` alone leaves the FASTA as it is; a
    SlotAttentionConsensus config without its kwargs raises KeyError in both
    commands; no model: random GRU weights with a warning."""
    base = ["polish", str(data["fastq"]), str(data["fasta"]), "-x", "cpu"]
    for flag in ("--vcf", "--gvcf"):
        rc, vcf, _ = _cli(capfd, torch_main, [*base, *WINDOW, "--regions", "ctg_b", flag],
                          tmp_path / f"v{flag}.vcf")
        assert rc == 0 and vcf.startswith("##fileformat=VCFv4.1")
        assert vcf.count("\nctg_b\t") > (700 if flag == "--gvcf" else 0)
    rc, fa, err = _cli(capfd, torch_main, [*base, *WINDOW, "--regions", "ctg_b"],
                       tmp_path / "r.fa")
    assert rc == 0 and "random weights" in err and fa.startswith(">ctg_b")
    rc, fa_ambig, _ = _cli(capfd, torch_main, [*base, *WINDOW, "--regions", "ctg_b",
                                               "--ambig-ref"], tmp_path / "a.fa")
    assert rc == 0 and fa_ambig == fa
    cfg = tmp_path / "slot.toml"
    cfg.write_text('[model]\ntype = "SlotAttentionConsensus"\n')
    for main in (jax_main, torch_main):
        with pytest.raises(KeyError):
            main([*base, "--model-config", str(cfg), "-o", str(tmp_path / "x.fa")])
