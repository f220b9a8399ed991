"""Hygiene of the port package: it imports neither JAX nor the JAX package,
builds its aligner from its own source with no fallback, its entry points
default to CUDA and refuse to fall back to the CPU, and each kernel wrapper
runs its plain version on CPU tensors without counting a launch."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dorado_tpu_torch
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
from dorado_tpu_torch.models.crf_model import LSTMCRFModel
from dorado_tpu_torch.models.presets import (
    fast_v40_config,
    hac_v43_config,
    lstm_sup_config,
    sup_v50_config,
)
from dorado_tpu_torch.models.tx_model import TxModel
from dorado_tpu_torch.ops import _cuda, attention, beam, crf_cuda, fused_norm, int8_matmul, lstm
from dorado_tpu_torch.pipeline import BasecallerPipeline

PKG = Path(dorado_tpu_torch.__file__).parent


def _module_names():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="dorado_tpu_torch.")
    )


def test_package_imports_no_jax():
    names = _module_names()
    assert "dorado_tpu_torch.basecall.runner" in names and len(names) > 20
    assert {"dorado_tpu_torch.models.tx_model", "dorado_tpu_torch.ops.attention",
            "dorado_tpu_torch.splitter.duplex_splitter", "dorado_tpu_torch.splitter.utils",
            "dorado_tpu_torch.utils.align", "dorado_tpu_torch.io.bam_reader",
            "dorado_tpu_torch.modbase.caller", "dorado_tpu_torch.modbase.config",
            "dorado_tpu_torch.modbase.encode", "dorado_tpu_torch.modbase.model",
            "dorado_tpu_torch.modbase.motif", "dorado_tpu_torch.modbase.scaler",
            "dorado_tpu_torch.modbase.tags", "dorado_tpu_torch.duplex.basespace",
            "dorado_tpu_torch.duplex.modbase", "dorado_tpu_torch.duplex.pairing",
            "dorado_tpu_torch.duplex.pipeline", "dorado_tpu_torch.duplex.stereo",
            "dorado_tpu_torch.parallel.sharding", "dorado_tpu_torch.parallel.distributed",
            "dorado_tpu_torch.utils.device_monitor", "dorado_tpu_torch.utils.stats",
            "dorado_tpu_torch.alignment.index", "dorado_tpu_torch.alignment.mapper",
            "dorado_tpu_torch.alignment.minimizer", "dorado_tpu_torch.utils.chain",
            "dorado_tpu_torch.utils.torchscript", "dorado_tpu_torch.secondary.architectures",
            "dorado_tpu_torch.secondary.features", "dorado_tpu_torch.secondary.model",
            "dorado_tpu_torch.secondary.model_resolver", "dorado_tpu_torch.secondary.pileup",
            "dorado_tpu_torch.secondary.polish", "dorado_tpu_torch.secondary.read_matrix",
            "dorado_tpu_torch.secondary.variant", "dorado_tpu_torch.secondary.variant_calling",
            "dorado_tpu_torch.correct.corrector", "dorado_tpu_torch.correct.features",
            "dorado_tpu_torch.correct.nn_model", "dorado_tpu_torch.correct.windows",
            "dorado_tpu_torch.alignment.aligner", "dorado_tpu_torch.alignment.bed_file",
            "dorado_tpu_torch.io.bai", "dorado_tpu_torch.io.sorted_bam",
            "dorado_tpu_torch.io.summary", "dorado_tpu_torch.demux.adapters",
            "dorado_tpu_torch.demux.barcoder", "dorado_tpu_torch.demux.custom_kit",
            "dorado_tpu_torch.demux.trimmer", "dorado_tpu_torch.polytail.calculator",
            "dorado_tpu_torch.utils.sample_sheet", "dorado_tpu_torch.io.cram",
            "dorado_tpu_torch.io.rans", "dorado_tpu_torch.splitter.rna_splitter",
            } <= set(names)
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "bad = sorted(new & {'jax', 'jaxlib', 'dorado_tpu'})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_sources_name_no_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert not {"jax", "jaxlib", "dorado_tpu"} & {
                    w.split(".")[0] for w in words[1:2]
                }, f"{path}: {line}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = fast_v40_config()
    model = LSTMCRFModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBasecallRunner(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BasecallerPipeline(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBasecallRunner(cfg, model, device="cuda")
    assert TorchBasecallRunner(cfg, model, device="cpu").device.type == "cpu"
    sup = _small_sup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBasecallRunner(sup, TxModel(sup))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BasecallerPipeline(sup, TxModel(sup))


def test_every_launch_goes_through_the_device_guard():
    """Static: no module of the package but ``ops/_cuda.py`` looks up a C
    entry point, takes a stream or checks a launch's code itself; every call
    into ``_cuda`` from a kernel wrapper is ``launch`` (or an argument
    check), and each module that counts a launch launches through it."""
    import ast

    private = {"kernel_function", "stream_ptr", "check_launch"}
    for path in PKG.rglob("*.py"):
        if path.name == "_cuda.py" and path.parent.name == "ops":
            continue
        tree = ast.parse(path.read_text())
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not private & (names | attrs), f"{path}: {private & (names | attrs)}"
        calls = {
            n.func.attr for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name) and n.func.value.id == "_cuda"
        }
        assert calls <= {"launch", "check_tensor", "build_kernels"}, f"{path}: {calls}"
        if path.parent.name == "ops" and ".launches += 1" in path.read_text():
            assert "launch" in calls, path


def test_launch_enters_the_device_and_passes_its_stream(monkeypatch):
    """``_cuda.launch`` calls the entry point while the tensors' device is
    current, with that device's stream last, and raises on an error code."""
    current, seen = [], []

    class Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    def fn(*args):
        seen.append((list(current), args))
        return args[0]

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(_cuda, "kernel_function", lambda name, symbol, argtypes: fn)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: f"stream of {dev}")
    card = torch.device("cuda", 1)
    _cuda.launch("lib", "symbol", [_cuda.INT, _cuda.INT], card, 0, 7)
    _cuda.launch("lib", "query", [_cuda.INT], card, 0, stream=False)
    assert seen == [([card], (0, 7, "stream of cuda:1")), ([card], (0,))]
    monkeypatch.setattr(_cuda, "_libs", {"lib": type("Lib", (), {
        "dtt_error_string": staticmethod(lambda code: b"bad")})()})
    with pytest.raises(RuntimeError, match="lib kernel launch failed: CUDA error 3"):
        _cuda.launch("lib", "symbol", [_cuda.INT], card, 3)


def _small_sup():
    """sup v5.0 at 2 layers and d_model 128 (2 heads of 64, ffn 256): the
    widths the W8A8 kernels take, with narrow convolutions."""
    cfg = sup_v50_config()
    cfg.tx.tx.depth = 2
    cfg.tx.tx.d_model = 128
    cfg.tx.tx.nhead = 2
    cfg.tx.tx.dim_feedforward = 256
    cfg.tx.crf.insize = 128
    conv = type(cfg.convs[2])
    cfg.convs[1].size = 16
    cfg.convs[0].size = 16
    cfg.convs[1].insize = 16
    cfg.convs[2] = conv(16, 16, 9, 3, cfg.convs[2].activation)
    cfg.convs[3] = conv(16, 16, 9, 2, cfg.convs[3].activation)
    cfg.convs[4] = conv(16, 128, 5, 2, cfg.convs[4].activation)
    return cfg


# every kernel wrapper of the port
WRAPPERS = (
    lstm.lstm_scan_time_major,
    int8_matmul.w8a8_matmul_fq,
    crf_cuda.backward_scores_shifted,
    crf_cuda.fused_forward_decode,
    crf_cuda.viterbi_traceback,
    crf_cuda.forward_scores,
    crf_cuda.backward_scores,
    crf_cuda.forward_backward_scores,
    beam.beam_forward,
    beam.beam_traceback,
    attention.windowed_attention_rope,
    int8_matmul.swiglu_w8a8,
    int8_matmul.w8a8_matmul,
    attention.windowed_attention_prerotated,
    attention.windowed_attention_halfperm,
    attention.windowed_attention_fused,
    fused_norm.matmul_residual_rmsnorm,
    crf_cuda.viterbi_forward,
    crf_cuda.fused_forward_decode_full,
    lstm.lstm_scan_time_major_int8,
    lstm.lstm_fused_time_major,
    lstm.lstm_scan_time_major_f32,
    int8_matmul.w8a8_matmul_fq_f32,
    int8_matmul.w8a8_matmul_f32,
    attention.windowed_attention_prerotated_f32,
    fused_norm.matmul_residual_rmsnorm_f32,
    lstm.lstm_scan_time_major_wide,
    lstm.lstm_scan_time_major_wide_f32,
    attention.windowed_attention_halfperm_f32,
)


@pytest.fixture
def no_kernels(monkeypatch):
    """Fail if anything tries to build or launch a CUDA kernel."""

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA kernel was requested for a CPU tensor")

    monkeypatch.setattr(_cuda, "kernel_function", refuse)
    monkeypatch.setattr(_cuda, "build_kernels", refuse)
    for wrapper in WRAPPERS:
        monkeypatch.setattr(wrapper, "launches", 0)


def _spy(monkeypatch, calls, module, name):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_wrappers_take_plain_version_on_cpu(no_kernels, monkeypatch):
    rs = np.random.RandomState(0)
    calls = []
    _spy(monkeypatch, calls, lstm, "lstm_scan_plain")
    _spy(monkeypatch, calls, crf_cuda, "backward_scores_shifted_plain")
    _spy(monkeypatch, calls, crf_cuda, "fused_forward_decode_plain")
    _spy(monkeypatch, calls, crf_cuda, "viterbi_traceback_plain")
    _spy(monkeypatch, calls, crf_cuda, "forward_scores_plain")
    _spy(monkeypatch, calls, crf_cuda, "backward_scores_plain")
    _spy(monkeypatch, calls, int8_matmul, "w8a8_matmul_fq_plain")
    _spy(monkeypatch, calls, beam, "beam_forward_plain")
    _spy(monkeypatch, calls, beam, "beam_traceback_plain")
    _spy(monkeypatch, calls, attention, "windowed_attention_rope_plain")
    _spy(monkeypatch, calls, int8_matmul, "swiglu_w8a8_plain")
    _spy(monkeypatch, calls, int8_matmul, "w8a8_matmul_plain")
    _spy(monkeypatch, calls, attention, "windowed_attention_prerotated_plain")
    _spy(monkeypatch, calls, attention, "windowed_attention_halfperm_plain")
    _spy(monkeypatch, calls, attention, "windowed_attention_fused_plain")
    _spy(monkeypatch, calls, fused_norm, "matmul_residual_rmsnorm_plain")
    x = torch.from_numpy(rs.randn(5, 2, 16).astype(np.float32))
    lstm.lstm_scan_time_major(x, torch.from_numpy(rs.randn(4, 16).astype(np.float32)))
    scores = torch.from_numpy(rs.randn(5, 2, 256).astype(np.float32))
    beta = crf_cuda.backward_scores_shifted(scores, 2.0)
    _, choices, final = crf_cuda.fused_forward_decode(scores, beta, 2.0)
    crf_cuda.viterbi_traceback(choices, torch.argmax(final, -1).to(torch.int32))
    crf_cuda.forward_scores(scores, 2.0)
    beta = crf_cuda.backward_scores(scores, 2.0)
    crf_cuda.forward_backward_scores(scores, 2.0)
    beam.beam_search_device(scores, beta, 32, 100.0, 2.0)
    wq = torch.from_numpy(rs.randint(-127, 128, (128, 128)).astype(np.int8))
    int8_matmul.w8a8_matmul_fq(
        torch.from_numpy(rs.randn(3, 128).astype(np.float32)), wq.t(), torch.ones(128)
    )
    cos, sin = attention.rope_tables(7, 64, 10000.0)
    attention.windowed_attention_rope(
        torch.from_numpy(rs.randn(2, 7, 3 * 64).astype(np.float32)), cos, sin, 1, 127, 128
    )
    xq, xs = int8_matmul.quantize_rows(torch.from_numpy(rs.randn(3, 128).astype(np.float32)))
    tq, ts = int8_matmul.swiglu_w8a8(xq, xs, wq.t(), torch.ones(128), wq.t(), torch.ones(128))
    int8_matmul.w8a8_matmul(tq, ts, wq.t(), torch.ones(128))
    qkv = torch.from_numpy(rs.randn(2, 7, 3 * 64).astype(np.float32))
    attention.windowed_attention_prerotated(attention.rope_qk(qkv, cos, sin, 1), qkv, 1, 127, 128)
    attention.windowed_attention_halfperm(qkv, cos, sin, 1, 127, 128)
    q = torch.from_numpy(rs.randn(2, 7, 1, 64).astype(np.float32))
    attention.windowed_attention_fused(q, q, q, 200, 256)
    x = torch.from_numpy(rs.randn(3, 128).astype(np.float32))
    fused_norm.matmul_residual_rmsnorm(x, wq.float(), None, x, torch.ones(128), 2.0)
    # backward_scores_shifted's plain version runs the plain backward scan too,
    # forward_backward_scores' both plain scans
    assert sorted(calls) == sorted(
        ["lstm_scan_plain", "backward_scores_shifted_plain", "backward_scores_plain",
         "fused_forward_decode_plain", "viterbi_traceback_plain", "forward_scores_plain",
         "backward_scores_plain", "forward_scores_plain", "backward_scores_plain",
         "w8a8_matmul_fq_plain", "beam_forward_plain",
         "beam_traceback_plain", "windowed_attention_rope_plain", "swiglu_w8a8_plain",
         "w8a8_matmul_plain", "windowed_attention_prerotated_plain",
         "windowed_attention_halfperm_plain", "windowed_attention_fused_plain",
         "matmul_residual_rmsnorm_plain"]
    )
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


@pytest.mark.parametrize("decoder,width", [("viterbi", 16), ("beam", 128)])
def test_cpu_runner_launches_no_kernel(no_kernels, decoder, width):
    cfg = hac_v43_config()
    cfg.lstm_size = width
    cfg.convs[2].size = width
    cfg.lstm_layers = 2
    runner = TorchBasecallRunner(
        cfg, LSTMCRFModel(cfg), chunk_size=1200, batch_size=2, device="cpu",
        decoder=decoder, lstm_precision="w8a8",
    )
    assert hasattr(runner.model.lstms[0], "w_ih_q") == (width == 128)
    buf = runner.make_input_buffer(0)
    out = runner.call_chunks(buf, 1)
    assert len(out) == 1 and len(out[0].moves) == 1200 // cfg.stride
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_cpu_tx_runner_launches_no_kernel(no_kernels):
    cfg = _small_sup()
    runner = TorchBasecallRunner(
        cfg, TxModel(cfg), chunk_size=768, batch_size=2, device="cpu", tx_precision="w8a8"
    )
    assert runner.model.layers[0].fc1_y_q.dtype == torch.int8
    buf = runner.make_input_buffer(0)
    out = runner.call_chunks(buf, 1)
    assert len(out) == 1 and len(out[0].moves) == 768 // cfg.stride
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


@pytest.mark.parametrize(
    "precision,attention_route,fused",
    [("int8", "ext", True), ("w8a8", "hp", True), ("bf16", "hp", True), ("int8", "extf", False)],
)
def test_cpu_tx_runner_routes_launch_no_kernel(no_kernels, precision, attention_route, fused):
    """The runner's transformer arguments (``tx_precision="int8"``,
    ``tx_attention``, ``tx_fused_norm``) on the CPU: the model takes them and
    runs every kernel's plain version."""
    cfg = _small_sup()
    runner = TorchBasecallRunner(
        cfg, TxModel(cfg), chunk_size=768, batch_size=2, device="cpu", tx_precision=precision,
        tx_attention=attention_route, tx_fused_norm=fused,
    )
    model = runner.model
    assert (model.attention, model.fused_norm) == (attention_route, fused)
    assert model.precision == {"bf16": "float"}.get(precision, precision)
    out = runner.call_chunks(runner.make_input_buffer(0), 1)
    assert len(out) == 1 and len(out[0].moves) == 768 // cfg.stride
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_decode_wrappers_at_1024_states_take_plain_version_on_cpu(no_kernels, monkeypatch):
    """The standalone decode kernels' wrappers (``viterbi_forward``,
    ``viterbi_path``, ``fused_forward_decode_full``) and the full-history
    scans and the beam at sup's 1024 states run their plain versions on CPU
    tensors and launch nothing."""
    rs = np.random.RandomState(1)
    calls = []
    for module, name in (
        (crf_cuda, "viterbi_forward_plain"), (crf_cuda, "viterbi_traceback_plain"),
        (crf_cuda, "fused_forward_decode_full_plain"), (crf_cuda, "forward_scores_plain"),
        (crf_cuda, "backward_scores_plain"), (beam, "beam_forward_plain"),
        (beam, "beam_traceback_plain"),
    ):
        _spy(monkeypatch, calls, module, name)
    scores = torch.from_numpy(rs.randn(6, 2, 4 * 1024).astype(np.float32))
    crf_cuda.forward_scores(scores, 2.0)
    beta = crf_cuda.backward_scores(scores, 2.0)
    beam.beam_search_device(scores, beta, 32, 100.0, 2.0)
    crf_cuda.viterbi_path(scores, 2.0)
    _, choices, _ = crf_cuda.fused_forward_decode_full(scores, beta, 2.0)
    assert choices.shape == (6, 2, 1024)
    # K8's plain version runs K7's for its choices
    assert calls == [
        "forward_scores_plain", "backward_scores_plain", "beam_forward_plain",
        "beam_traceback_plain", "viterbi_forward_plain", "viterbi_traceback_plain",
        "fused_forward_decode_full_plain", "viterbi_forward_plain",
    ]
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_cpu_tx_beam_runner_launches_no_kernel(no_kernels):
    cfg = _small_sup()
    runner = TorchBasecallRunner(
        cfg, TxModel(cfg), chunk_size=768, batch_size=2, device="cpu", tx_precision="w8a8",
        decoder="beam",
    )
    assert runner.decoder == "beam" and cfg.num_states == 1024
    out = runner.call_chunks(runner.make_input_buffer(0), 1)
    assert len(out) == 1 and len(out[0].moves) == 768 // cfg.stride
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_kernel_sources_present():
    for name in _cuda.KERNEL_SOURCES:
        src = (_cuda.CSRC / f"{name}.cu").read_text()
        assert "Replaces dorado_tpu/ops/" in src and "What bounds it on the H100" in src
    assert {"attention_banded", "w8a8_matmul", "fused_norm", "crf_viterbi_forward"} <= set(
        _cuda.KERNEL_SOURCES)
    assert len(_cuda.KERNEL_SOURCES) == len(list(_cuda.CSRC.glob("*.cu")))
    assert _cuda.library_path("lstm_scan").parent == _cuda.BUILD_DIR


def test_package_imports_no_pyarrow_zstandard_or_ml_dtypes():
    """The port reads POD5 and weight files with its own Arrow reader, a
    ctypes binding of libzstd and torch's bf16: importing every module, the
    CLI included, loads none of the JAX package's file libraries."""
    names = _module_names()
    assert {"dorado_tpu_torch.cli.main", "dorado_tpu_torch.io.arrow_ipc",
            "dorado_tpu_torch.io.vbz", "dorado_tpu_torch.models.load"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'pyarrow', 'zstandard', 'ml_dtypes', 'jax', 'dorado_tpu'})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert not {"pyarrow", "zstandard", "ml_dtypes"} & {
                    w.split(".")[0] for w in words[1:2]
                }, f"{path}: {line}"


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from dorado_tpu_torch.cli import main as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parser_args = ["basecaller", str(tmp_path), str(tmp_path)]
    for extra in ([], ["-x", "auto"], ["-x", "cuda"], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(parser_args + extra)


def test_k15_k16_wrappers_take_plain_version_on_cpu(no_kernels, monkeypatch):
    rs = np.random.RandomState(2)
    calls = []
    _spy(monkeypatch, calls, lstm, "lstm_scan_int8_plain")
    _spy(monkeypatch, calls, lstm, "lstm_fused_plain")
    w = torch.from_numpy(rs.randn(16, 64).astype(np.float32))
    wq, scale = lstm.quantize_lstm_weights(w)
    x = torch.from_numpy(rs.randn(5, 2, 64).astype(np.float32))
    assert lstm.lstm_scan_time_major_int8(x, wq, scale, reverse=True).shape == (5, 2, 16)
    x = torch.from_numpy(rs.randn(5, 2, 16).astype(np.float32)).bfloat16()
    out = lstm.lstm_fused_time_major(x, w.bfloat16(), w.bfloat16(), torch.zeros(64))
    assert out.shape == (5, 2, 16) and out.dtype == torch.bfloat16
    assert calls == ["lstm_scan_int8_plain", "lstm_fused_plain"]
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_lstm_scan_source_has_k15_and_k16():
    src = (_cuda.CSRC / "lstm_scan.cu").read_text()
    for entry in ("DTT_EXPORT int lstm_scan_bf16(", "DTT_EXPORT int lstm_scan_int8(",
                  "DTT_EXPORT int lstm_fused_bf16("):
        assert entry in src
    for tpu_kernel in ("lstm_scan_time_major_int8", "lstm_fused_time_major"):
        assert f"Replaces dorado_tpu/ops/lstm.py::{tpu_kernel}" in src
    assert "__dp4a" in src


def test_lstm_scan_source_has_k1_float32():
    src = (_cuda.CSRC / "lstm_scan.cu").read_text()
    assert "DTT_EXPORT int lstm_scan_f32(" in src and "mma_3xtf32" in src
    assert "dispatch_nt<float, false>" in src


@pytest.mark.parametrize(
    "family,dtype,fused",
    [("tx", torch.float32, False), ("tx", torch.float32, True), ("tx", torch.bfloat16, True),
     ("lstm", torch.float32, False), ("lstm", torch.bfloat16, False)],
)
def test_cpu_runner_compute_dtypes_launch_no_kernel(no_kernels, family, dtype, fused):
    """``compute_dtype`` on the CPU: the model holds that type and every
    kernel's plain version runs, the float32 forms' included."""
    if family == "tx":
        cfg = _small_sup()
        kw = dict(tx_precision="w8a8", tx_fused_norm=fused)
        model, chunk = TxModel(cfg), 768
    else:
        cfg = hac_v43_config()
        cfg.lstm_size, cfg.convs[2].size, cfg.lstm_layers = 128, 128, 2
        kw = dict(lstm_precision="w8a8")
        model, chunk = LSTMCRFModel(cfg), 1200
    runner = TorchBasecallRunner(cfg, model, chunk_size=chunk, batch_size=2, device="cpu",
                                 compute_dtype=dtype, **kw)
    assert runner.compute_dtype == dtype and runner.score_dtype == torch.float32
    assert all(p.dtype == dtype for p in runner.model.parameters())
    out = runner.call_chunks(runner.make_input_buffer(0), 1)
    assert len(out) == 1 and len(out[0].moves) == chunk // cfg.stride
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_kernel_sources_have_float32_forms():
    """The float32 forms' C entry points, in the sources of their bf16 forms."""
    sources = {name: (_cuda.CSRC / f"{name}.cu").read_text() for name in (
        "w8a8_matmul_fq", "w8a8_matmul", "attention_banded", "fused_norm")}
    assert "DTT_EXPORT int w8a8_matmul_fq(" in sources["w8a8_matmul_fq"]
    assert "launch<float, float>" in sources["w8a8_matmul_fq"]
    assert "k13::launch<float>" in sources["w8a8_matmul"]
    assert "DTT_EXPORT int attention_prerotated_f32(" in sources["attention_banded"]
    assert "DTT_EXPORT int matmul_residual_rmsnorm_f32(" in sources["fused_norm"]
    assert "mma_3xtf32_split" in sources["attention_banded"] + sources["fused_norm"]


def test_modbase_caller_defaults_to_cuda_and_runs_plain_on_cpu(no_kernels, monkeypatch):
    """``ModBaseCaller`` takes CUDA unless told otherwise and raises without
    it; on the CPU its model's LSTMs take K1's plain version (float32), and
    no kernel is built or launched."""
    from dorado_tpu_torch.modbase.caller import ModBaseCaller
    from dorado_tpu_torch.modbase.model import init_modbase_params
    from dorado_tpu_torch.models.presets import hac_5mcg_5hmcg_v3_config

    cfg = hac_5mcg_5hmcg_v3_config(16)
    model = init_modbase_params(cfg, torch.Generator().manual_seed(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModBaseCaller([cfg], [model], canonical_stride=6)
    calls = []
    _spy(monkeypatch, calls, lstm, "lstm_scan_plain")
    mc = ModBaseCaller([cfg], [model], canonical_stride=6, device="cpu")
    rs = np.random.RandomState(3)
    seq = "ACGT" * 30 + "CG" * 10
    moves = np.zeros(2 * len(seq), dtype=np.uint8)
    moves[::2] = 1
    res = mc.call_read(seq, moves, rs.randn(12 * len(seq)).astype(np.float32))
    assert res.motif_hits.sum() == 40 and len(calls) % 2 == 0 and calls
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_aligner_builds_from_its_own_source(monkeypatch, tmp_path):
    """The splitter's aligner is ``csrc/align.cpp``, built by g++ into
    ``csrc/build/``; a failed build raises, with no fallback; no module of
    the port names the JAX package's native library or its sources."""
    from dorado_tpu_torch.utils import align

    assert align.SOURCE == _cuda.CSRC / "align.cpp" and align.SOURCE.is_file()
    assert "int dt_align(" in align.SOURCE.read_text()
    assert align.library_path().parent == _cuda.BUILD_DIR
    assert align.library_path().name.startswith("align-")
    calls = []

    def failing_gxx(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, stdout="", stderr="error: planted")

    monkeypatch.setattr(align, "library_path", lambda: tmp_path / "align-missing.so")
    monkeypatch.setattr(align.subprocess, "run", failing_gxx)
    with pytest.raises(RuntimeError, match="(?s)g[+][+] failed .*planted"):
        align.build()
    assert calls and calls[0][0] == "g++" and str(align.SOURCE) in calls[0]
    assert {"-O3", "-std=c++17", "-shared", "-fPIC"} <= set(calls[0])
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for name in ("dorado_tpu/native", "dorado_tpu.native", "libdorado_native"):
            assert name not in text, f"{path} names {name}"


@pytest.fixture
def one_thread():
    """One intra-op thread, as ``tests/test_torch_cli.py`` runs: the runner's
    many small operators crawl at their thread-pool barriers when the test
    workers oversubscribe the CPU (0.4 s alone, 70-86 s in the whole run)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_wide_k1_and_k11a_f32_wrappers_take_plain_version_on_cpu(no_kernels, monkeypatch,
                                                                 one_thread):
    """K1's wide forms (at widths no cluster holds, reached from K1's and K1
    float32's wrappers too) and K11a at float32 run their plain versions on
    CPU tensors and count no launch."""
    rs = np.random.RandomState(1)
    calls = []
    _spy(monkeypatch, calls, lstm, "lstm_scan_plain")
    _spy(monkeypatch, calls, attention, "windowed_attention_halfperm_plain")
    for h in (516, 768):
        x = torch.from_numpy(rs.randn(2, 3, 4 * h).astype(np.float32))
        w = torch.from_numpy(rs.randn(h, 4 * h).astype(np.float32) / h)
        for fn in (lstm.lstm_scan_time_major, lstm.lstm_scan_time_major_f32,
                   lstm.lstm_scan_time_major_wide, lstm.lstm_scan_time_major_wide_f32):
            fn(x, w)
        lstm.lstm_scan_time_major(x.bfloat16(), w.bfloat16())
    cos, sin = attention.rope_tables(7, 64, 10000.0)
    qkv = torch.from_numpy(rs.randn(2, 7, 3 * 64).astype(np.float32))
    attention.windowed_attention_halfperm_f32(qkv, cos, sin, 1, 127, 128)
    attention.windowed_attention_halfperm(qkv, cos, sin, 1, 127, 128)
    assert calls == ["lstm_scan_plain"] * 10 + ["windowed_attention_halfperm_plain"] * 2
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


@pytest.mark.parametrize("decoder,dtype", [("viterbi", torch.float32), ("beam", torch.float32),
                                           ("viterbi", torch.bfloat16)])
def test_cpu_lstm_sup_runner_launches_no_kernel(no_kernels, one_thread, decoder, dtype):
    """The LSTM-sup preset (1024 states) narrowed to LSTM width 128 and two
    layers, W8A8: on the CPU every kernel's plain version runs."""
    cfg = lstm_sup_config()
    cfg.lstm_size, cfg.convs[2].size, cfg.lstm_layers = 128, 128, 2
    runner = TorchBasecallRunner(cfg, LSTMCRFModel(cfg), chunk_size=1200, batch_size=2,
                                 device="cpu", decoder=decoder, lstm_precision="w8a8",
                                 compute_dtype=dtype)
    assert cfg.num_states == 1024 and hasattr(runner.model.lstms[0], "w_ih_q")
    out = runner.call_chunks(runner.make_input_buffer(0), 1)
    assert len(out) == 1 and len(out[0].moves) == 1200 // cfg.stride
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_kernel_sources_have_the_wide_k1_and_k11a_f32():
    """K1's wide forms in K1's source, K11a at float32 in the attention's."""
    lstm_src = (_cuda.CSRC / "lstm_scan.cu").read_text()
    attn_src = (_cuda.CSRC / "attention_banded.cu").read_text()
    assert "DTT_EXPORT int lstm_scan_wide_bf16(" in lstm_src
    assert "DTT_EXPORT int lstm_scan_wide_f32(" in lstm_src
    assert "KIND_K1FW" in lstm_src and "load_a_l2" in lstm_src
    assert "DTT_EXPORT int attention_halfperm_f32(" in attn_src



def _narrow_duplex_models(width, head_gain=12.0):
    """hac v4.3 and the stereo preset at LSTM width ``width`` and 2 layers,
    random weights with the CRF heads scaled so that both call bases."""
    from dorado_tpu_torch.models.crf_model import init_lstm_crf_params
    from dorado_tpu_torch.models.presets import stereo_config

    out = []
    for cfg in (hac_v43_config(), stereo_config()):
        cfg.lstm_size, cfg.convs[2].size, cfg.lstm_layers = width, width, 2
        model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(3))
        with torch.no_grad():
            model.linear1_w.mul_(head_gain)
        out += [cfg, model]
    return out


def test_duplex_pipeline_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from dorado_tpu_torch.cli import main as cli
    from dorado_tpu_torch.duplex import DuplexPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models = _narrow_duplex_models(16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DuplexPipeline(*models)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DuplexPipeline(*models, device="cuda")
    pipe = DuplexPipeline(*models, device="cpu")
    assert pipe.simplex.runner.device.type == pipe.stereo_runner.device.type == "cpu"
    args = ["duplex", str(tmp_path), str(tmp_path), "--stereo-model", str(tmp_path)]
    for extra in ([], ["-x", "auto"], ["-x", "cuda"], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(args + extra)


@pytest.mark.parametrize("decoder", ["viterbi", "beam"])
def test_cpu_duplex_run_launches_no_kernel(no_kernels, one_thread, decoder):
    """A duplex run on the CPU with W8A8 projections (both models at LSTM
    width 128): a forced pair is called by the stereo model, and every
    kernel's plain version runs."""
    from dorado_tpu_torch.duplex import DuplexPipeline
    from dorado_tpu_torch.duplex.pairing import PairingResult
    from dorado_tpu_torch.io.pod5 import Pod5Read, RunInfo
    from tests.torch_duplex import ForcedPairer

    pipe = DuplexPipeline(*_narrow_duplex_models(128), chunk_size=1200, batch_size=4,
                          device="cpu", decoder=decoder, lstm_precision="w8a8")
    assert hasattr(pipe.stereo_runner.model.lstms[0], "w_ih_q")
    pipe.pairer = ForcedPairer(PairingResult)
    rs = np.random.RandomState(1)
    info = RunInfo(sample_rate=5000, protocol_run_id="run0")
    reads = [Pod5Read(
        read_id=f"read-{i}", signal=rs.normal(460, 113, 2000).astype(np.int16), read_number=i,
        start_sample=2100 * i, median_before=200.0, channel=1, well=1, pore_type="not_set",
        calibration_offset=0.0, calibration_scale=0.2, end_reason="signal_positive",
        end_reason_forced=False, open_pore_level=float("nan"), num_reads_since_mux_change=0,
        time_since_mux_change=0.0, num_minknow_events=0, tracked_scaling_scale=float("nan"),
        tracked_scaling_shift=float("nan"), predicted_scaling_scale=float("nan"),
        predicted_scaling_shift=float("nan"), run_info=info) for i in range(2)]
    written = []
    stats = pipe.run_reads(reads, type("W", (), {"write": lambda self, r: written.append(r)})())
    assert stats.pairs == 1 and stats.duplex_reads == 1 and stats.simplex_reads == 2
    assert [r.qname for r in written] == ["read-0;read-1", "read-0", "read-1"]
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_chain_builds_from_its_own_source(monkeypatch, tmp_path):
    """The mapper's chaining is ``csrc/chain.cpp``, built by g++ into
    ``csrc/build/`` with the aligner's flags; a failed build raises, with no
    fallback."""
    from dorado_tpu_torch.utils import chain

    assert chain.SOURCE == _cuda.CSRC / "chain.cpp" and chain.SOURCE.is_file()
    assert "int dt_chain(" in chain.SOURCE.read_text()
    assert chain.library_path().parent == _cuda.BUILD_DIR
    assert chain.library_path().name.startswith("chain-")
    calls = []

    def failing_gxx(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, stdout="", stderr="error: planted")

    monkeypatch.setattr(chain, "library_path", lambda: tmp_path / "chain-missing.so")
    monkeypatch.setattr(subprocess, "run", failing_gxx)
    with pytest.raises(RuntimeError, match="(?s)g[+][+] failed .*planted"):
        chain.build()
    assert calls and calls[0][0] == "g++" and str(chain.SOURCE) in calls[0]
    assert {"-O3", "-std=c++17", "-shared", "-fPIC"} <= set(calls[0])


def _polish_inputs(tmp_path):
    from dorado_tpu_torch.secondary.model import init_gru_model
    from tests.torch_polish import polish_inputs, write_fasta, write_fastq

    draft, _, reads = polish_inputs(3, 1200, 8, (300, 900))
    return (write_fasta(tmp_path / "d.fa", [("ctg", draft)]),
            write_fastq(tmp_path / "r.fastq", reads),
            init_gru_model(torch.Generator().manual_seed(1), gru_size=16))


def test_polish_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from dorado_tpu_torch.cli import main as cli
    from dorado_tpu_torch.secondary.polish import PolishPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fasta, fastq, gru = _polish_inputs(tmp_path)
    for kw in ({}, {"device": "cuda"}, {"device": "auto"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PolishPipeline(gru, **kw)
    assert PolishPipeline(gru, device="cpu").device.type == "cpu"
    for extra in ([], ["-x", "cuda"], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["polish", str(fastq), str(fasta), *extra])


@pytest.mark.parametrize("kind", ["counts", "read_level"])
def test_cpu_polish_run_launches_no_kernel(no_kernels, one_thread, tmp_path, kind):
    """A polish run on the CPU: the LatentSpaceLSTM's four LSTM directions a
    window run K1 float32's plain version; no kernel is built or launched."""
    from dorado_tpu_torch.alignment import Mapper, ReferenceIndex
    from dorado_tpu_torch.secondary import architectures
    from dorado_tpu_torch.secondary.pileup import AlignedRead
    from dorado_tpu_torch.secondary.polish import PolishPipeline
    from dorado_tpu_torch.utils.sequence import reverse_complement

    fasta, fastq, model = _polish_inputs(tmp_path)
    if kind == "read_level":
        model = architectures.model_factory("LatentSpaceLSTM", {
            "num_classes": 5, "lstm_size": 16, "cnn_size": 8, "kernel_sizes": [1, 5]})
    mapper = Mapper(ReferenceIndex.build(fasta))
    reads = []
    for line in fastq.read_text().splitlines()[1::4]:
        for a in mapper.map(line):
            seq = reverse_complement(line) if a.is_reverse else line
            reads.append(AlignedRead(a.ref_start, a.cigar, seq, a.is_reverse, mapq=a.mapq))
    pipe = PolishPipeline(model, window_len=600, window_overlap=100, feature_kind=kind,
                          device="cpu")
    (name, seq), = pipe.run(fasta, {"ctg": reads})
    assert name == "ctg" and seq and pipe.stats.windows == 3
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


@pytest.mark.parametrize("decoder", ["viterbi", "beam"])
def test_cpu_rna_run_launches_no_kernel(no_kernels, one_thread, decoder):
    """A direct-RNA run on the CPU (the RNA stand-in, narrow): the RNA split,
    the adapter trim and the reversal on the host, every kernel's plain
    version on the device side; none is built or launched."""
    from dorado_tpu_torch.io.pod5 import Pod5Read, RunInfo
    from dorado_tpu_torch.models.presets import rna004_hac_config
    from tests.torch_rna import rna_signals

    cfg = rna004_hac_config()
    cfg.lstm_size = cfg.convs[2].size = 16
    pipe = BasecallerPipeline(cfg, LSTMCRFModel(cfg), chunk_size=1200, batch_size=4,
                              device="cpu", decoder=decoder, estimate_poly_a=True)
    assert pipe.rna_splitter is not None and pipe.read_splitter is None
    info = RunInfo(acquisition_id="a", sample_rate=4000, protocol_run_id="run")
    reads = [Pod5Read(
        read_id=f"rna-{i}", signal=sig, read_number=i, start_sample=0, median_before=200.0,
        channel=1, well=1, pore_type="not_set", calibration_offset=0.0, calibration_scale=0.2,
        end_reason="signal_positive", end_reason_forced=False, open_pore_level=float("nan"),
        num_reads_since_mux_change=0, time_since_mux_change=0.0, num_minknow_events=0,
        tracked_scaling_scale=float("nan"), tracked_scaling_shift=float("nan"),
        predicted_scaling_scale=float("nan"), predicted_scaling_shift=float("nan"),
        run_info=info, filename="rna.pod5") for i, sig in enumerate(rna_signals(3, [6000, 9000]))]

    class Keep:
        records = []

        def write(self, rec):
            self.records.append(rec)

    out = Keep()
    pipe.run_reads(reads, out)
    assert {r.qname.split(":")[0] for r in out.records} == {"rna-0", "rna-1"}
    assert len(out.records) == 3  # the second read splits at its spike
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_rna_pipeline_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from dorado_tpu_torch.models.presets import rna004_hac_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = rna004_hac_config()
    cfg.lstm_size = cfg.convs[2].size = 16
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BasecallerPipeline(cfg, LSTMCRFModel(cfg), **kw)
