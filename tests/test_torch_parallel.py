"""Several devices on the CPU: the port's sharded step (``parallel.
sharding``) against the JAX package's ``make_sharded_basecall_step`` (the
conftest gives JAX 8 CPU devices; the port's meshes are grids of CPU
devices), and the runner's replicas, the pipelines and the command line with
one replica against several.

The sharded step: the cases of ``tests/test_parallel.py``, a 4 x 1 data
mesh, a 2 x 2 mesh whose head splits over the "model" axis, and the beam
decoder, on a narrow hac model and white-noise signal (queue 3's Viterbi
near-ties on random models). States and moves are equal; the posteriors,
scores and backward scores are held within 1e-4 of their largest value
(both sides' float32 sums run in other orders).

Replicas compute each row as one replica does: the same ``DecodedChunk``s
and records for 2 and 3 replicas (the 3 of uneven shares) as for one, on the
narrow hac model (float32) and the small transformer (W8A8), with each
decoder.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.parallel import make_mesh as jax_make_mesh
from dorado_tpu.parallel import make_sharded_basecall_step as jax_make_step
from dorado_tpu.parallel import shard_params as jax_shard_params
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner, resolve_devices
from dorado_tpu_torch.cli.main import main
from dorado_tpu_torch.duplex import DuplexPipeline
from dorado_tpu_torch.duplex import pairing
from dorado_tpu_torch.io import pod5
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config, sup_v50_config
from dorado_tpu_torch.models.tx_model import tx_params_from_jax
from dorado_tpu_torch.parallel import make_mesh, make_sharded_basecall_step, shard_params
from dorado_tpu_torch.pipeline import BasecallerPipeline
from tests.test_torch_duplex import _lengths
from tests.test_torch_duplex import _reads as duplex_reads
from tests.test_torch_cli import inputs  # noqa: F401  (a fixture)
from tests.test_torch_hygiene import _narrow_duplex_models
from tests.test_torch_pipeline import _reads as simplex_reads
from tests.test_torch_runner import _narrow_hac, jax_params_with_moves
from tests.test_torch_tx_model import jax_tx_params, small_sup
from tests.torch_duplex import ForcedPairer

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SIGNAL = 600  # samples: 100 decode steps at hac's stride of 6
TOL = 1e-4  # of each output's largest value


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the same float sums whatever the batch's rows."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hac():
    params = jax_params_with_moves(2)
    cfg = _narrow_hac(hac_v43_config())
    return _narrow_hac(jax_hac_config()), params, cfg, params_from_jax(params, cfg)


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("data,model,decoder,n", [
    (4, 1, "viterbi", 16), (2, 2, "viterbi", 8), (4, 1, "beam", 8), (2, 2, "beam", 8),
])
def test_sharded_step_matches_jax(hac, data, model, decoder, n):
    jcfg, params, cfg, tmodel = hac
    sig = np.random.RandomState(data * model + n).randn(n, SIGNAL).astype(np.float32)
    jmesh = jax_make_mesh(data * model, model=model)
    ref = jax_make_step(jcfg, jmesh, decoder=decoder)(
        jax_shard_params(params, jmesh, jcfg), jnp.asarray(sig))
    mesh = make_mesh(devices=[CPU] * (data * model), model=model)
    assert mesh.shape == {"data": data, "model": model}
    sharded = shard_params(tmodel, mesh, cfg)
    if model > 1:  # each device holds its own rows of the head
        rows = tmodel.linear1_w.shape[0]
        assert [c.linear1_w.shape[0] for c in sharded.cells[0]] == [rows // model] * model
    out = make_sharded_basecall_step(cfg, mesh, decoder=decoder)(sharded, sig)
    t_out = SIGNAL // cfg.stride
    if decoder == "viterbi":
        states, moves, posts = out
        assert states.shape == moves.shape == (n, t_out)
        np.testing.assert_array_equal(states.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(moves.numpy(), np.asarray(ref[1]))
        assert 0 < moves.float().mean() < 1
        _close(posts, ref[2], "posts")
    else:
        scores, bwd, posts = out
        assert scores.shape == (n, t_out, cfg.outsize)
        assert bwd.shape == (n, t_out + 1, cfg.num_states)
        for got, want, what in zip(out, ref, ("scores", "bwd", "posts")):
            _close(got, want, what)


def test_split_head_equals_the_unsplit_step(hac):
    """A 1 x 2 mesh (the head over two devices) gives the 1 x 1 step's
    outputs bit for bit: the split changes no sum."""
    _, _, cfg, tmodel = hac
    sig = np.random.RandomState(3).randn(4, SIGNAL).astype(np.float32)
    outs = []
    for model in (1, 2):
        mesh = make_mesh(devices=[CPU] * model, model=model)
        outs.append(make_sharded_basecall_step(cfg, mesh)(shard_params(tmodel, mesh, cfg), sig))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kwargs", [
    dict(devices=[CPU] * 4, data=3), dict(devices=[CPU] * 3, model=2),
    dict(devices=[CPU] * 2, n_devices=4, data=4), dict(devices=[CPU], model=2),
])
def test_mesh_that_does_not_match_raises(kwargs):
    with pytest.raises(ValueError, match="mesh"):
        make_mesh(**kwargs)


def test_rows_the_data_axis_does_not_divide_raise(hac):
    _, _, cfg, tmodel = hac
    mesh = make_mesh(devices=[CPU] * 4)
    step = make_sharded_basecall_step(cfg, mesh)
    with pytest.raises(ValueError, match="do not split"):
        step(shard_params(tmodel, mesh, cfg), np.zeros((6, SIGNAL), np.float32))
    with pytest.raises(ValueError, match="do not split"):  # head rows over 3 devices
        shard_params(tmodel, make_mesh(devices=[CPU] * 3, model=3), cfg)


def test_step_at_another_dtype_than_the_placed_model_raises(hac):
    """``shard_params`` casts each cell once; a step of another compute type
    refuses the cells rather than casting them again."""
    _, _, cfg, tmodel = hac
    mesh = make_mesh(devices=[CPU] * 2, model=2)
    sharded = shard_params(tmodel, mesh, cfg, compute_dtype=torch.bfloat16)
    assert sharded.dtype == torch.bfloat16
    assert all(c.linear1_w.dtype == torch.bfloat16 for row in sharded.cells for c in row)
    with pytest.raises(ValueError, match="placed in"):
        make_sharded_basecall_step(cfg, mesh)(sharded, np.zeros((2, SIGNAL), np.float32))


def test_device_lists_resolve():
    assert resolve_devices("cpu") == [CPU]
    assert resolve_devices([CPU, "cpu", CPU]) == [CPU] * 3
    with pytest.raises(ValueError, match="no devices"):
        resolve_devices([])


# ---- the runner's replicas --------------------------------------------------------


def _runner(hac, family, decoder, device):
    if family == "lstm":
        _, _, cfg, model = hac
        return TorchBasecallRunner(cfg, model, chunk_size=1200, batch_size=4, device=device,
                                   decoder=decoder)
    cfg = small_sup(sup_v50_config())
    return TorchBasecallRunner(cfg, tx_params_from_jax(jax_tx_params(3), cfg), chunk_size=1152,
                               batch_size=2, device=device, decoder=decoder, tx_precision="w8a8")


@pytest.mark.parametrize("family,decoder", [
    ("lstm", "viterbi"), ("lstm", "beam"), ("tx", "viterbi"), ("tx", "beam"),
])
def test_replicas_call_what_one_replica_calls(hac, family, decoder):
    one = _runner(hac, family, decoder, "cpu")
    buf = one.make_input_buffer(0)
    rows = buf.shape[0]
    sig = np.random.RandomState(4).randn(3 * rows, buf.shape[1]).astype(np.float16)
    want = one.call_chunks(sig[:rows], rows) + one.call_chunks(sig[rows:2 * rows], rows)
    want += one.call_chunks(sig[2 * rows:], rows - 1)
    assert any(c.sequence for c in want)
    for count in (2, 3):
        runner = _runner(hac, family, decoder, [CPU] * count)
        assert len(runner.replicas) == count
        assert runner.make_input_buffer(0).shape[0] == count * rows
        assert runner.replicas[1].model is not runner.replicas[0].model
        # every replica's share of a batch: 3 replicas split 3 rows - 1 unevenly
        n = 3 * rows - 1
        shares = [hi - lo for _, lo, hi in runner.shares(n)]
        assert sum(shares) == n and max(shares) - min(shares) <= 1
        buffer = np.zeros((count * rows, sig.shape[1]), np.float16)
        got = []
        for lo in range(0, n, count * rows):
            take = min(count * rows, n - lo)
            buffer[:take] = sig[lo : lo + take]
            got += runner.call_chunks(buffer, take)
        assert [(c.sequence, c.qstring) for c in got] == [(c.sequence, c.qstring) for c in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.moves, b.moves)
        # the runner's counts sum its replicas'
        assert runner.stats.chunks_called == n
        assert runner.stats.batches_called == sum(r.stats.batches_called for r in runner.replicas)
        assert all(r.stats.batches_called > 0 for r in runner.replicas)
        with pytest.raises(AttributeError):  # the sum is read-only
            runner.stats.chunks_called += 1


# ---- the pipelines and the command line --------------------------------------------


class _Collect:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


def _same_records(a, b) -> None:
    assert [r.qname for r in a] == [r.qname for r in b]
    for x, y in zip(a, b):
        assert (x.seq, x.qual) == (y.seq, y.qual), x.qname
        assert [(t.tag, str(t.value)) for t in x.tags] == [(t.tag, str(t.value)) for t in y.tags]


@pytest.mark.parametrize("decoder", ["viterbi", "beam"])
def test_run_reads_with_two_replicas_writes_what_one_writes(hac, decoder):
    _, _, cfg, model = hac
    outs = []
    for device in ("cpu", [CPU, CPU]):
        pipe = BasecallerPipeline(dataclasses.replace(cfg), model, chunk_size=1200, batch_size=4,
                                  device=device, decoder=decoder, emit_moves=True)
        out = _Collect()
        stats = pipe.run_reads(simplex_reads(pod5), out)
        outs.append(out.records)
        assert stats.reads_called == len(out.records) > 0
    _same_records(*outs)


def test_duplex_pipeline_with_two_replicas_writes_what_one_writes():
    outs = []
    reads = duplex_reads(pod5, _lengths(3, 2), 2)
    for device in ("cpu", [CPU, CPU]):
        pipe = DuplexPipeline(*_narrow_duplex_models(32), chunk_size=1200, batch_size=4,
                              device=device)
        assert pipe.stereo_runner.devices == pipe.simplex.runner.devices
        pipe.pairer = ForcedPairer(pairing.PairingResult)
        out = _Collect()
        stats = pipe.run_reads(reads, out)
        assert stats.duplex_reads > 0
        outs.append(sorted(out.records, key=lambda r: r.qname))
    _same_records(*outs)


def test_cli_on_the_cpu_is_one_replica(inputs, tmp_path, capsys):
    model, data = inputs
    out = tmp_path / "calls.sam"
    args = ["basecaller", str(model), str(data), "-c", "1200", "-b", "8", "--emit-sam"]
    hook = sys.excepthook
    assert main([*args, "-x", "cpu", "-o", str(out)]) == 0
    assert sys.excepthook is hook  # the crash hook is the command line's only
    err = capsys.readouterr().err
    assert "> Devices: 1 (cpu)" in err and "> Reads basecalled: 5" in err
    reads = list(pod5.Pod5File(next(data.glob("*.pod5"))).reads())
    pipe = BasecallerPipeline(*_cfg_model(model), chunk_size=1200, batch_size=8, device="cpu")
    mine = _Collect()
    pipe.run_reads(reads, mine)
    assert [l.split("\t")[:11] for l in out.read_text().splitlines() if not l.startswith("@")] \
        == [r.to_sam_line().split("\t")[:11] for r in mine.records]


def _cfg_model(model_dir):
    from dorado_tpu_torch.models.load import build_model, load_model

    cfg, params = load_model(model_dir)
    return cfg, build_model(cfg, params)


def test_cli_without_cuda_exits_1(inputs):
    """``-x cuda`` on a machine without CUDA: exit code 1, the message, and
    the crash handler's device line."""
    model, data = inputs
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "dorado_tpu_torch", "basecaller", str(model), str(data),
         "-x", "cuda", "--emit-sam"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 1
    assert "CUDA is not available" in res.stderr
    assert "[dorado_tpu_torch] no CUDA devices" in res.stderr
