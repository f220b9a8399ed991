"""The conv + LSTM models wider than one cluster (the LSTM-sup class, H = 768,
1024 states) on the CPU.

- K1's wide form, the kernel's host side: which widths take it, the
  resident form's answers unchanged where it served, the resident columns
  and streamed fragments (``wide_w_hh``) rebuilding W_hh exactly, and its
  shared memory within a CTA's 232,448 bytes.
- The wide wrappers' plain version at H = 768 against the JAX
  ``lstm_scan_time_major`` in interpret mode.
- A narrow conv + LSTM model with ``state_len`` 5 (1024 states) through the
  port's runner against the JAX runner (Viterbi and beam), and through both
  CLIs on white-noise reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.basecall.runner import BasecallRunner
from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.config import load_model_config as jax_load_config
from dorado_tpu.models.crf_model import init_lstm_crf_params as jax_init
from dorado_tpu.models.crf_model import lstm_crf_forward
from dorado_tpu.models.load import save_lstm_params as jax_save_lstm_params
from dorado_tpu.ops import beam as jax_beam
from dorado_tpu.ops import crf_scan as jax_crf_scan
from dorado_tpu.ops.lstm import lstm_scan_time_major as jax_lstm_scan
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
from dorado_tpu_torch.cli.main import main
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import config_toml, lstm_sup_config
from dorado_tpu_torch.ops import crf_scan, lstm
from dorado_tpu_torch.ops.beam import beam_search_plain
from tests.test_torch_cli import _assert_records_match, _records
from tests.test_torch_runner import BATCH, CHUNK, _assert_calls_match
from tests.torch_pod5_writer import make_reads, run_info, write_pod5

SMEM_MAX = 232448


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as ``tests/test_torch_cli.py`` runs: the runs are
    many small operators, whose thread-pool barriers crawl when the test
    workers oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the wide form's plan and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "h,elem_bytes,wide",
    [(512, 2, False), (516, 2, True), (768, 2, True), (1024, 2, True),
     (384, 4, False), (388, 4, True), (448, 4, True), (768, 4, True)],
)
def test_k1_form_by_width(h, elem_bytes, wide):
    """The resident form up to what a cluster of 16 holds (bf16 512, float32
    384), the wide form above it."""
    assert lstm.k1_needs_wide(h, elem_bytes) == wide


# the resident form's answers on the parent tree: (H, elem_bytes, its cluster
# shape, its plans for (N, clusters at once) of RESIDENT_BATCHES)
RESIDENT_BATCHES = [(128, 15), (512, 15), (100, 7), (1024, 8), (1, 1)]
RESIDENT = [
    (384, 2, (8, 48, 12), [(16, 8), (40, 13), (16, 7), (40, 26), (8, 1)]),
    (96, 2, (1, 96, 12), [(16, 8), (40, 13), (16, 7), (48, 22), (8, 1)]),
    (512, 2, (16, 32, 8), [(16, 8), (32, 16), (16, 7), (32, 32), (8, 1)]),
    (32, 2, (1, 32, 8), [(16, 8), (40, 13), (16, 7), (48, 22), (8, 1)]),
    (256, 4, (8, 32, 8), [(16, 8), (32, 16), (16, 7), (32, 32), (8, 1)]),
    (384, 4, (16, 24, 6), [(16, 8), (16, 32), (16, 7), (16, 64), (8, 1)]),
]


@pytest.mark.parametrize("h,elem_bytes,shape,plans", RESIDENT)
def test_resident_form_unchanged(h, elem_bytes, shape, plans):
    """At the widths the resident form served, its cluster shape and rows a
    cluster are the parent tree's."""
    assert not lstm.k1_needs_wide(h, elem_bytes)
    assert lstm.k1_cluster_shape(h, elem_bytes=elem_bytes) == shape
    for (n, active), (rows, clusters) in zip(RESIDENT_BATCHES, plans):
        plan = lstm.k1_plan(h, n, active, elem_bytes=elem_bytes)
        assert tuple(plan) == (*shape, rows, clusters)


def _rebuild(res, frag, plan, hidden, elem_bytes):
    """W_hh [H, 4H] from the wide form's resident columns and fragments,
    independently of ``wide_w_hh``: a CTA's slice row 4 j + gate and depth
    k hold W_hh[k, gate * H + c * U + j]; fragment (m-tile, k-tile, lane l)
    holds, in 32-bit words, rows l // 4 and l // 4 + 8 at word l % 4, then
    the same rows at word 4 + l % 4 of the k-tile's 8."""
    c, u = plan.cluster, plan.units
    pair = 64 // elem_bytes
    kp = plan.pairs * pair
    sl = torch.full((c, 4 * u, kp), float("nan"), dtype=torch.float64)
    sl[:, :, plan.reg * pair:plan.resident * pair] = res.double()
    kept = list(range(2 * plan.reg)) + list(range(2 * plan.resident, 2 * plan.pairs))
    words = frag.contiguous().view(torch.int32)  # [C, U / 4, kept, 32, 4]
    assert words.shape == (c, u // 4, len(kept), 32, 4)
    wide = torch.zeros(c, 4 * u, kp * elem_bytes // 4, dtype=torch.int32)
    for i, kt in enumerate(kept):
        for lane in range(32):
            r, w = lane // 4, lane % 4
            for e, (dr, dw) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
                wide[:, (torch.arange(u // 4) * 16 + r + dr), kt * 8 + w + dw] = \
                    words[:, :, i, lane, e]
    streamed = wide.view(res.dtype).double()
    for kt in kept:
        cols = slice(kt * pair // 2, (kt + 1) * pair // 2)
        sl[:, :, cols] = streamed[:, :, cols]
    assert not torch.isnan(sl).any()
    # slice -> W_hh: row 4 j + gate of CTA c, k
    w = sl.reshape(c, u, 4, kp).permute(3, 2, 0, 1).reshape(kp, 4, c * u)
    assert not w[hidden:].any() and not w[:, :, hidden:].any()  # zeros past H
    return w[:hidden, :, :hidden].reshape(hidden, 4 * hidden)


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("h", [768, 1024, 772])
@pytest.mark.parametrize("n,active", [(128, 7), (8, 1)])
def test_wide_parts_rebuild_w_hh(h, elem_bytes, n, active):
    """The resident columns and the streamed (and register) fragments hold
    every weight of W_hh once, exactly, at the plan's split, with zeros
    where the unit or k is past H (772: no multiple of the cluster's 16
    CTAs or of a CTA's units)."""
    dtype = torch.float32 if elem_bytes == 4 else torch.bfloat16
    rs = np.random.RandomState(h + elem_bytes)
    w = torch.from_numpy(rs.randn(h, 4 * h).astype(np.float32)).to(dtype)
    plan = lstm.k1_wide_plan(h, n, active, elem_bytes)
    res, frag = lstm.wide_w_hh(w, plan)
    assert res.dtype == frag.dtype == dtype
    assert torch.equal(_rebuild(res, frag, plan, h, elem_bytes), w.double())


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_wide_plan_fits_shared_memory(elem_bytes):
    """At every width the wide form takes, up to 1024, and at batches from 1
    to 2000 rows: clusters of 16 whose units cover H in whole k-tiles of h,
    m-tiles split one or two a warp over at most 12 warps, rows a multiple
    of 8 up to 48 covering the batch, register pairs within the kernel's and
    the pairs' count, and the shared memory of a CTA within 232,448 bytes."""
    first = 516 if elem_bytes == 2 else 388
    for h in range(first, 1025, 4):
        for n, active in ((1, 7), (100, 7), (128, 7), (512, 7), (2000, 7), (128, 1)):
            p = lstm.k1_wide_plan(h, n, active, elem_bytes)
            assert p.cluster == 16 and p.units % (32 // elem_bytes) == 0
            assert p.cluster * p.units >= h > p.cluster * (p.units - 32 // elem_bytes)
            tiles = p.units // 4
            assert p.warps <= 12 and tiles % p.warps == 0 and tiles // p.warps <= 2
            assert p.rows % 8 == 0 and 8 <= p.rows <= 48
            assert p.rows * p.clusters >= n > p.rows * (p.clusters - 1)
            assert p.reg % 2 == 0 and 0 <= p.reg <= p.resident <= p.pairs
            assert p.pairs * 64 == lstm._k1_depth(16, p.units, elem_bytes) * elem_bytes
            smem = lstm._k1_wide_smem(p.units, 16, p.rows, p.resident - p.reg, elem_bytes)
            assert smem <= SMEM_MAX
            # as many resident pairs as fit: one more would not
            if p.resident < p.pairs:
                assert lstm._k1_wide_smem(
                    p.units, 16, p.rows, p.resident - p.reg + 1, elem_bytes) > SMEM_MAX


def test_wide_plan_at_the_lstm_sup_width():
    """H = 768 at N = 128 over 7 clusters at once: 24 rows a cluster, one
    wave of 6 clusters; two pairs in registers, 11 resident, 11 streamed of
    24 (bf16); float32 keeps 4 of 48 resident."""
    assert tuple(lstm.k1_wide_plan(768, 128, 7)) == (16, 48, 12, 24, 6, 2, 13, 24)
    assert tuple(lstm.k1_wide_plan(768, 128, 7, 4)) == (16, 48, 12, 24, 6, 0, 4, 48)


# ---------------------------------------------------------------------------
# the wide wrappers' plain version against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("wrapper", ["wide", "wide_f32", "time_major"])
def test_wide_scan_matches_pallas(wrapper, reverse):
    """At H = 768 (small T and N) the wrappers on CPU tensors run the plain
    version, against the JAX ``lstm_scan_time_major`` in interpret mode:
    float32 both sides, only the order of h @ W's 768-term sums differs
    (atol 1e-5, as at H = 32 in ``tests/test_torch_lstm.py``). No launch is
    counted."""
    t, n, h = 4, 3, 768
    rs = np.random.RandomState(31)
    xproj = (rs.randn(t, n, 4 * h) * 0.8).astype(np.float32)
    w_hh_t = (rs.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    ref = np.asarray(
        jax_lstm_scan(jnp.asarray(xproj), jnp.asarray(w_hh_t), reverse=reverse, interpret=True)
    )
    fn = {"wide": lstm.lstm_scan_time_major_wide, "wide_f32": lstm.lstm_scan_time_major_wide_f32,
          "time_major": lstm.lstm_scan_time_major}[wrapper]
    out = fn(torch.from_numpy(xproj), torch.from_numpy(w_hh_t), reverse=reverse)
    assert out.dtype == torch.float32 and out.shape == (t, n, h)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert lstm.lstm_scan_time_major_wide.launches == 0
    assert lstm.lstm_scan_time_major_wide_f32.launches == 0


# ---------------------------------------------------------------------------
# a narrow conv + LSTM model with 1024 states through both runners and CLIs
# ---------------------------------------------------------------------------


def _narrow_sup(cfg):
    """``lstm_sup_config`` at LSTM width 32 (1024 states kept)."""
    cfg.lstm_size = 32
    cfg.convs[2].size = 32
    return cfg


def _jax_config(tmp_path):
    """The JAX package's config of the narrow model, read from the
    ``config.toml`` the port writes."""
    d = tmp_path / "narrow_sup"
    d.mkdir()
    (d / "config.toml").write_text(config_toml(_narrow_sup(lstm_sup_config())))
    return jax_load_config(d)


def _jax_params(jcfg, seed=2, gain=12.0):
    """Random weights whose CRF head is scaled up so that both decoders emit
    bases (unscaled random weights mostly stay)."""
    params = jax.tree_util.tree_map(np.array, jax_init(jcfg, jax.random.PRNGKey(seed)))
    params["linear1"]["w"] *= gain
    return params


def _runners(tmp_path, decoder):
    """Both runners in float32 on the CPU over the same random weights of
    the narrow 1024-state model."""
    jcfg = _jax_config(tmp_path)
    cfg = _narrow_sup(lstm_sup_config())
    assert cfg.num_states == jcfg.num_states == 1024 and cfg.outsize == 4096
    params = _jax_params(jcfg)
    jr = BasecallRunner(jcfg, params, chunk_size=CHUNK, batch_size=BATCH, decoder=decoder,
                        compute_dtype=jnp.float32)
    tr = TorchBasecallRunner(cfg, params_from_jax(params, cfg), chunk_size=CHUNK,
                             batch_size=BATCH, device="cpu", decoder=decoder)
    assert tr.model.linear1_w.shape == (4096, 32)
    return jcfg, jr, tr


@pytest.mark.parametrize("lane", [0, 1])
def test_state_len_5_lstm_viterbi_matches_jax(tmp_path, lane):
    """One batch of white-noise chunks of each lane through both runners with
    the Viterbi decoder: sequences and moves equal, qual chars a step apart
    at under 1% (the runner tests' rule)."""
    _, jr, tr = _runners(tmp_path, "viterbi")
    _assert_calls_match(jr, tr, lane, 50)


def test_state_len_5_lstm_beam_near_jax(tmp_path):
    """The beam decoder at 1024 states, held part by part as
    ``tests/test_torch_runner.py`` holds the W8A8 beam on other weights: the
    beam amplifies its inputs' last bits, and the two packages' float32 sums
    run in another order. (a) The models' scores agree to float32 rounding
    (mean under 1e-5, max under 1e-3; measured 1.8e-7 and 1.7e-6); (b) on
    the same scores the backward scores differ by under 1e-3; (c) on the
    same scores and either package's back guide the two beams agree
    exactly; so (d) the runners' moves are bounded: no more than 10% of
    positions (the W8A8 beam test's bound; measured 4 of 600)."""
    jcfg, jr, tr = _runners(tmp_path, "beam")
    buf = tr.make_input_buffer(0)
    buf[:] = np.random.RandomState(0).randn(*buf.shape).astype(np.float16)
    n = 3  # of the batch's 8 rows: the JAX beam at 1024 states is slow on the CPU
    jax_scores = np.array(lstm_crf_forward(
        jr.params, jnp.asarray(buf[:n]).astype(jnp.float32), jcfg, time_major=True))
    with torch.inference_mode():
        scores = tr.model(torch.from_numpy(buf[:n]))
    err = np.abs(scores.numpy() - jax_scores)
    assert err.mean() < 1e-5 and err.max() < 1e-3  # (a)

    blank = float(tr.options.blank_score)
    width, cut = int(tr.options.beam_width), float(tr.options.beam_cut)
    jax_back_guide = np.array(jax_crf_scan.backward_scores(jnp.asarray(jax_scores), blank))
    back_guide = crf_scan.backward_scores(torch.from_numpy(jax_scores), blank).numpy()
    assert np.abs(back_guide - jax_back_guide).max() < 1e-3  # (b)
    for g in (jax_back_guide, back_guide):  # (c)
        want = jax_beam.beam_search_device(
            jnp.asarray(jax_scores), jnp.asarray(g), width, cut, blank)
        got = beam_search_plain(torch.from_numpy(jax_scores), torch.from_numpy(g), width, cut,
                                blank)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    ref, out = jr.call_chunks(buf.copy(), n), tr.call_chunks(buf.copy(), n)  # (d)
    different = sum(int((x.moves != y.moves).sum()) for x, y in zip(ref, out))
    positions = sum(len(x.moves) for x in ref)
    assert sum(int(y.moves.sum()) for y in out) > 50 * n  # the path emits bases
    assert different <= 0.10 * positions, (different, positions)


def test_state_len_5_lstm_cli_matches_jax_cli(tmp_path):
    """Both CLIs on the narrow 1024-state model's directory (named as the
    preset) over white-noise reads, as ``tests/test_torch_cli.py`` runs them,
    SAM with moves: records, sequences, moves and tags equal, qual chars as
    the pipeline tests hold them."""
    cfg = _narrow_sup(lstm_sup_config())
    model = tmp_path / cfg.model_name
    model.mkdir()
    (model / "config.toml").write_text(config_toml(cfg))
    jcfg = jax_load_config(model)
    jax_save_lstm_params(jcfg, _jax_params(jcfg), model)
    data = tmp_path / "pod5"
    data.mkdir()
    infos = [run_info(3)]
    write_pod5(data / "calls.pod5",
               make_reads(7, [3000, 890, 5200, 1700, 2500], infos, noise=True), infos)
    common = ["-c", "1200", "-b", "8", "--emit-moves", "--emit-sam", "-x", "cpu"]
    ours, theirs = tmp_path / "ours.sam", tmp_path / "theirs.sam"
    assert jax_main(["basecaller", str(model), str(data), *common, "--dtype", "float32",
                     "-o", str(theirs)]) == 0
    assert main(["basecaller", str(model), str(data), *common, "-o", str(ours)]) == 0
    rg_ref, ref = _records(theirs, "sam")
    rg_out, out = _records(ours, "sam")
    assert rg_out == rg_ref and f"basecall_model={cfg.model_name}" in rg_out[0]
    _assert_records_match(ref, out)
