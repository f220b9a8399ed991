"""``python -m dorado_tpu_torch variant`` (and ``polish --vcf/--gvcf``)
against ``dorado_tpu.cli.main``'s on the CPU, both in process, on the same
seeded diploid draft and reads (``tests/torch_variant.py``, with a span no
read covers) and the same weights: the same VCF text and exit codes for
the counts GRU, ``--model-config`` of each variant model, ``--gvcf``,
``--candidates`` with its bed file, each haplotag source (computed,
``--unphased``, ``--hp-tag`` on a SAM with HP tags) and the JAX command's
behaviours the port copies.

The JAX command draws its random weights from ``PRNGKey(0)``; the port's
command, given the same arguments, builds its model through
``model_factory`` (or ``init_gru_model``), patched here to return those
weights carried across."""

import jax
import numpy as np
import pytest
import torch

from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.secondary import architectures as jax_arch
from dorado_tpu.secondary import model as jax_model
from dorado_tpu_torch.cli.main import main as torch_main
from dorado_tpu_torch.models import presets
from dorado_tpu_torch.secondary import architectures, model
from tests.torch_variant import variant_files

# windows of 500 with 100 columns of margin: two over the 1 kb draft, the
# second holding its uncovered span, and the JAX perceiver's materialised
# logits small; one mapping thread
WINDOW = ["--window-len", "500", "--window-overlap", "100", "-t", "1"]
NARROW = dict(read_embedding_size=16, cnn_size=12, kernel_sizes=(1, 5))


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
    return variant_files(tmp_path_factory.mktemp("variant_cli"))


def carried(model_type: str, kwargs: dict) -> torch.nn.Module:
    """The port's model of ``model_type`` with the JAX factory's
    ``PRNGKey(0)`` weights."""
    params = jax.tree.map(np.asarray, jax_arch.model_factory(model_type, kwargs)[0])
    if model_type == "SlotAttentionConsensus":
        m = architectures.SlotAttentionConsensus(architectures.slot_attention_config(kwargs))
        m.load_state_dict(architectures.slot_attention_consensus_state_dict(params))
    else:
        m = architectures.VariantPerceiver(architectures.variant_perceiver_config(kwargs))
        m.load_state_dict(architectures.variant_perceiver_state_dict(params))
    return m.eval()


@pytest.fixture
def same_weights(monkeypatch):
    """The port's factory and random GRU patched to the JAX command's
    weights; the model types the port's command built."""
    built = []

    def factory(model_type, kwargs, generator=None):
        built.append(model_type)
        return carried(model_type, kwargs)

    def gru(generator):
        built.append("random GRU")
        m = model.GRUModel()
        m.load_state_dict(model.gru_state_dict(jax.tree.map(
            np.asarray, jax_model.init_gru_params(jax.random.PRNGKey(0)))))
        return m.eval()

    monkeypatch.setattr(architectures, "model_factory", factory)
    monkeypatch.setattr(model, "init_gru_model", gru)
    return built


def _cli(capfd, main, argv, out):
    capfd.readouterr()
    rc = main([*argv, "-o", str(out)])
    return rc, capfd.readouterr().err


def parity(capfd, data, tag, argv, out_name=None):
    """Both commands on the CPU: equal exit codes and VCF text; (the VCF
    text, the port's stderr). ``out_name`` None: ``-o`` is a file; else a
    directory, where both write ``out_name``."""
    outs = {}
    for who, main in (("jax", jax_main), ("torch", torch_main)):
        out = data["dir"] / f"{tag}_{who}"
        if out_name:
            out.mkdir()
        rc, err = _cli(capfd, main, [*argv, "-x", "cpu"],
                       out if out_name else out.with_suffix(".vcf"))
        assert rc == 0, err
        outs[who] = (out / out_name) if out_name else out.with_suffix(".vcf")
    text = outs["torch"].read_text()
    assert text == outs["jax"].read_text()
    assert text.startswith("##fileformat=VCFv4.1") and "#CHROM" in text
    return text, err, outs


def model_config(data, name, cfg) -> list[str]:
    path = data["dir"] / f"{name}.toml"
    path.write_text(presets.polish_config_toml(cfg))
    return ["--model-config", str(path)]


def body(text: str) -> list[str]:
    return [line for line in text.splitlines() if not line.startswith("#")]


def test_counts_gru(capfd, data, same_weights):
    """The random counts GRU (no model given), then ``--gvcf`` (a record at
    every covered position) and ``--pass-qual-filter``; a ``.tensor``
    ``--model-params`` directory is not read (the JAX command's
    behaviour): the same random GRU runs."""
    base = ["variant", str(data["fastq"]), str(data["fasta"]), *WINDOW]
    text, err, _ = parity(capfd, data, "gru", base)
    assert same_weights == ["random GRU"] and "window(s) on cpu" in err
    gtext, _, _ = parity(capfd, data, "gru_gvcf", [*base, "--gvcf", "--pass-qual-filter", "20"])
    assert len(body(gtext)) > 900 and "LowQual" in gtext
    tensor_dir = presets.save_polish_model(presets.polish_gru_config(16), model.init_gru_model(
        torch.Generator().manual_seed(1)), data["dir"] / "gru_t", tensor_files=True)
    ptext, err, _ = parity(capfd, data, "gru_params", [*base, "--model-params", str(tensor_dir)])
    assert ptext == text and "shares the polish path" in err


@pytest.mark.parametrize("source", ["compute", "unphased", "hp-tag"])
def test_slot_attention_consensus(capfd, data, same_weights, source):
    """The slot model with its LSTMs over each haplotag source; the window
    holding the uncovered span is NaN throughout (its 0/0 spread by the
    LSTMs) in both packages, and decodes to the same records."""
    cfg = presets.slot_attention_config(**NARROW, add_lstm=True)
    reads = data["sam"] if source == "hp-tag" else data["fastq"]
    flags = {"compute": [], "unphased": ["--unphased"], "hp-tag": ["--hp-tag"]}[source]
    text, err, _ = parity(capfd, data, f"slot_{source}", [
        "variant", str(reads), str(data["fasta"]), *WINDOW,
        *model_config(data, "slot", cfg), *flags])
    assert same_weights == ["SlotAttentionConsensus"] and "SlotAttentionConsensus" in err
    assert len(body(text)) > 0
    if source == "compute":
        # the second window, draft positions [500, 1000) with its margin
        # from 400, holds the uncovered span: its output is NaN throughout
        from dorado_tpu_torch.cli.main import _collect_alignments, _feature_opts
        from dorado_tpu_torch.secondary.architectures import parse_model_config
        from dorado_tpu_torch.secondary.variant_calling import VariantCaller, _ref_end

        args = type("Args", (), dict(reads=str(reads), draft=str(data["fasta"]), min_mapq=0,
                                     threads=1))
        window_reads = [r for r in _collect_alignments(args)["ctg"]
                        if r.ref_start < 1000 and _ref_end(r) > 400]
        caller = VariantCaller(carried(cfg["model"]["type"], cfg["model"]["kwargs"]),
                               "read_level", _feature_opts(parse_model_config(
                                   data["dir"] / "slot.toml"), "compute"), device="cpu")
        pile, feats = caller.features(window_reads, 400, 1000)
        assert (pile.depth == 0).any() and np.isnan(caller.forward(feats)).all()
        assert not any(500 <= int(line.split("\t")[1]) - 1 < 1000 for line in body(text))


def test_variant_perceiver_gvcf(capfd, data, same_weights):
    cfg = presets.variant_perceiver_config(32, 2, 4, **NARROW, use_decoder_lstm=True,
                                           update_read_embeddings=True)
    text, _, _ = parity(capfd, data, "perceiver", [
        "variant", str(data["fastq"]), str(data["fasta"]), *WINDOW, "--gvcf",
        *model_config(data, "perceiver", cfg)])
    assert same_weights == ["VariantPerceiver"] and len(body(text)) > 900


def test_candidates_into_directory(capfd, data, same_weights):
    """``--candidates`` spans (flanked by ``--variant-flanking-bases``) over
    a ``-o`` directory: ``variants.vcf`` and its processed-regions bed
    equal; the records only inside the spans."""
    base = ["variant", str(data["fastq"]), str(data["fasta"]), *WINDOW, "--candidates",
            str(data["candidates"]), "--variant-flanking-bases", "40"]
    text, err, outs = parity(capfd, data, "candidates", base, out_name="variants.vcf")
    beds = {who: (p.with_suffix(".processed_regions.bed")).read_text()
            for who, p in outs.items()}
    assert beds["torch"] == beds["jax"] and "Candidate windows" in err
    spans = [tuple(map(int, line.split("\t")[1:])) for line in beds["torch"].splitlines()]
    assert len(spans) > 2
    for line in body(text):
        pos = int(line.split("\t")[1]) - 1
        assert any(lo <= pos < hi for lo, hi in spans)


@pytest.mark.parametrize("flag", ["--vcf", "--gvcf"])
def test_polish_hands_off_to_variant(capfd, data, same_weights, flag):
    """``polish --vcf`` and ``--gvcf`` run the variant flow with its
    defaults (haplotags computed), here with the slot model, and
    ``--ambig-ref``."""
    cfg = presets.slot_attention_config(**NARROW)
    text, _, _ = parity(capfd, data, f"polish{flag}", [
        "polish", str(data["fastq"]), str(data["fasta"]), *WINDOW, flag, "--ambig-ref",
        *model_config(data, "slot_plain", cfg)])
    assert len(body(text)) > (900 if flag == "--gvcf" else 0)


def test_model_directories(capfd, data):
    """``-m`` with a GRU's ``weights.pt`` runs in both; a variant model's
    ``weights.pt`` is refused by both (exit 1), as the JAX resolver refuses
    it; a config without its model's kwargs raises KeyError in both."""
    gru = presets.save_polish_model(presets.polish_gru_config(16), model.init_gru_model(
        torch.Generator().manual_seed(2), gru_size=16), data["dir"] / "gru_w")
    base = ["variant", str(data["fastq"]), str(data["fasta"]), *WINDOW]
    parity(capfd, data, "gru_dir", [*base, "-m", str(gru)])
    cfg = presets.slot_attention_config(**NARROW)
    slot = presets.save_polish_model(cfg, architectures.model_factory(
        "SlotAttentionConsensus", cfg["model"]["kwargs"]), data["dir"] / "slot_w")
    for main in (jax_main, torch_main):
        rc, err = _cli(capfd, main, [*base, "-m", str(slot), "-x", "cpu"], data["dir"] / "x.vcf")
        assert rc == 1 and "weights.pt loading is implemented for GRUModel" in err
    bare = data["dir"] / "bare.toml"
    bare.write_text('[model]\ntype = "VariantPerceiver"\n')
    for main in (jax_main, torch_main):
        with pytest.raises(KeyError):
            main([*base, "--model-config", str(bare), "-x", "cpu", "-o",
                  str(data["dir"] / "y.vcf")])


def test_variant_defaults_to_cuda_and_raises_without_it(monkeypatch, data):
    from dorado_tpu_torch.secondary.variant_calling import VariantCaller

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gru = model.GRUModel(gru_size=16)
    for kw in ({}, {"device": "cuda"}, {"device": "auto"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VariantCaller(gru, **kw)
    assert VariantCaller(gru, device="cpu").device.type == "cpu"
    for extra in ([], ["-x", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main(["variant", str(data["fastq"]), str(data["fasta"]), *extra])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main(["polish", str(data["fastq"]), str(data["fasta"]), "--vcf", *extra])
