"""The compute type (``compute_dtype``, the CLI's ``--dtype``) on the CPU,
the kernels' float32 forms and the runner: the port at float32 and at bf16
against the JAX package at the same type. ``tests/test_torch_dtype_paths.py``
holds the pipeline and the command line at each type.

- The float32 forms of K2, K13, K10, K14 and K11a (``w8a8_matmul_fq_f32``,
  ``w8a8_matmul_f32``, ``windowed_attention_prerotated_f32``,
  ``matmul_residual_rmsnorm_f32``, ``windowed_attention_halfperm_f32``),
  which take their plain versions on a CPU tensor, against the JAX
  functions at float32: the Pallas bodies in interpret mode.
- ``quantize_tx_head_w8a8`` and the quantised head against the JAX
  package's.
- ``TorchBasecallRunner`` against the JAX runner for a narrow LSTM preset and
  the two-layer transformer of ``tests/test_torch_tx_model.py`` (also on the
  ``"hp"`` route at float32); the models' bf16 scores and each route's.
- ``bytes_per_chunk_timestep`` at 4 bytes, the ``compute_dtype`` argument,
  and every attention route at either type.

At float32 the two packages compute one function with float32 sums in
another order, and the runner tests' tolerances hold (sequences and moves
equal, qual chars a step apart at under 1%). At bf16 each package rounds the
stream at its own places (XLA on the CPU keeps some intermediates in float32
that the port rounds, and the reverse): the two packages' bf16 scores are as
far apart as each package's bf16 scores are from its own float32 ones
(``test_bf16_scores_match_jax``, the tight bound). On white noise the narrow
random models' Viterbi paths turn on near-ties that such differences break
either way, so at bf16 the calls are held only to MIN_BF16_IDENTITY.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorado_tpu.basecall import batch_size as jax_batch_size
from dorado_tpu.basecall.runner import BasecallRunner
from dorado_tpu.models.crf_model import lstm_crf_forward
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.models.presets import sup_v50_config as jax_sup_config
from dorado_tpu.models.tx_model import quantize_tx_head_w8a8 as jax_quantize_head
from dorado_tpu.models.tx_model import rope_ext_tables, tx_forward
from dorado_tpu.ops import attention as jax_attention
from dorado_tpu.ops import int8_matmul as jax_int8
from dorado_tpu.ops.fused_norm import matmul_residual_rmsnorm as jax_fused
from dorado_tpu_torch.basecall import batch_size
from dorado_tpu_torch.basecall.runner import TorchBasecallRunner, resolve_compute_dtype
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config, sup_v50_config
from dorado_tpu_torch.models.tx_model import (
    ATTENTION_ROUTES,
    quantize_tx_head_w8a8,
    tx_params_from_jax,
    with_routes,
)
from dorado_tpu_torch.ops import attention, fused_norm, int8_matmul
from dorado_tpu_torch.utils.align import align
from tests.test_torch_runner import (
    BATCH,
    CHUNK,
    TX_CHUNK,
    _narrow_hac,
    assert_qstrings_close,
    jax_params_with_moves,
)
from tests.test_torch_tx_model import (
    _scores,
    _signal,
    jax_tx_params,
    small_sup,
    with_drawn_biases,
)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# bf16 runs and the fixture's calls: the identity of the port's calls to the
# JAX package's (``_identity``; measured at bf16 on the runner's batch: 0.994
# for the narrow LSTM, 0.967 for the transformer, where the JAX package's own
# bf16 calls are 0.9985 and 0.944 from its float32 ones)
MIN_BF16_IDENTITY = 0.9
# bf16 scores: the port's against the JAX package's, over the larger of each
# package's bf16 scores against its own float32 ones (mean abs differences;
# measured 0.86 and 1.1)
MAX_BF16_SCORE_RATIO = 1.5


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


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the float32 forms' plain versions against the Pallas bodies at float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,o", [(21, 256, 384), (40, 512, 1536)])
def test_fq_f32_form_matches_pallas_interpret(m, k, o):
    """K2 on float32 rows writing float32 (rows that are no multiple of the
    interpret run's 8-row blocks; one row of zeros): the int32 sums are exact
    and each float step one rounding in both, so they agree to 1e-5 (the JAX
    body divides where the port multiplies by the reciprocal)."""
    rs = np.random.RandomState(m)
    x = rs.randn(m, k).astype(np.float32)
    x[5] = 0.0
    wq_t, ws = jax_int8.quantize_weight(rs.randn(o, k).astype(np.float32))
    bias = rs.randn(o).astype(np.float32)
    ref = np.asarray(jax_int8.w8a8_matmul_fq(
        jnp.asarray(x), wq_t, ws, bias=jnp.asarray(bias), block_m=8, block_n=128,
        out_dtype=jnp.float32, interpret=True,
    ))
    launches = int8_matmul.w8a8_matmul_fq_f32.launches
    out = int8_matmul.w8a8_matmul_fq_f32(torch.from_numpy(x), _t(wq_t), _t(ws),
                                         torch.from_numpy(bias))
    assert int8_matmul.w8a8_matmul_fq_f32.launches == launches  # a CPU tensor launches nothing
    assert out.shape == (m, o) and out.dtype == torch.float32
    # the public wrapper takes the same plain version
    assert torch.equal(out, int8_matmul.w8a8_matmul_fq(
        torch.from_numpy(x), _t(wq_t), _t(ws), torch.from_numpy(bias), out_dtype=torch.float32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,o", [(21, 256, 128), (40, 2048, 512)])
def test_w8a8_f32_form_matches_pallas_interpret(m, k, o):
    """K13 writing float32: exact int32 sums and two float32 roundings in
    both, so equal."""
    rs = np.random.RandomState(m + k)
    xq = rs.randint(-127, 128, (m, k)).astype(np.int8)
    xs = (rs.rand(m, 1) * 0.01).astype(np.float32)
    wq_t, ws = jax_int8.quantize_weight(rs.randn(o, k).astype(np.float32))
    ref = jax_int8.w8a8_matmul(
        jnp.asarray(xq), jnp.asarray(xs), wq_t, ws, block_m=8, out_dtype=jnp.float32,
        interpret=True,
    )
    launches = int8_matmul.w8a8_matmul_f32.launches
    out = int8_matmul.w8a8_matmul_f32(_t(xq), _t(xs), _t(wq_t), _t(ws))
    assert int8_matmul.w8a8_matmul_f32.launches == launches
    assert out.shape == (m, o) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("t_len", [100, 700])
def test_prerotated_f32_form_matches_pallas_interpret(t_len):
    """K10 at float32 on sup's window, through ``windowed_attention_ext`` (the
    JAX float32 stream's route into ``_banded_attention_call``): 1e-5
    absolute, the bf16 test's bound for its float32 plain version."""
    h, d = 2, 64
    qkv = np.random.RandomState(t_len).randn(2, t_len, 3 * h * d).astype(np.float32)
    ct, st, perm = rope_ext_tables(t_len, d, h, 10000.0)
    ext = np.concatenate([qkv, qkv[..., : 2 * h * d][..., perm]], axis=-1)
    ref = jax_attention.windowed_attention_ext(jnp.asarray(ext), ct, st, h, 127, 128,
                                               interpret=True)
    cos, sin = attention.rope_tables(t_len, d, 10000.0)
    qkv_t = torch.from_numpy(qkv)
    launches = attention.windowed_attention_prerotated_f32.launches
    out = attention.windowed_attention_prerotated_f32(
        attention.rope_qk(qkv_t, cos, sin, h), qkv_t, h, 127, 128
    )
    assert attention.windowed_attention_prerotated_f32.launches == launches
    assert out.shape == (2, t_len, h * d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t_len", [100, 700])
def test_halfperm_f32_form_matches_pallas_interpret(t_len):
    """K11a at float32 on sup's window: the projection with its q and k rows
    halves-major, JAX's [2, T, H*D] tables against the port's [T, D/2] ones,
    the JAX kernel fed float32 (the float32 stream on the "hp" route): 1e-5
    absolute, as K10's float32 form above."""
    h, d = 2, 64
    qkv = np.random.RandomState(5000 + t_len).randn(2, t_len, 3 * h * d).astype(np.float32)
    hp = np.ascontiguousarray(qkv[..., attention.wqkv_halfperm_rows(h, h * d)])
    ref = jax_attention.windowed_attention_halfperm(
        jnp.asarray(hp), jax_attention.rope_half_tables(t_len, d, h, 10000.0), h, 127, 128,
        interpret=True)
    cos, sin = attention.rope_tables(t_len, d, 10000.0)
    launches = attention.windowed_attention_halfperm_f32.launches
    out = attention.windowed_attention_halfperm_f32(torch.from_numpy(hp), cos, sin, h, 127, 128)
    assert attention.windowed_attention_halfperm_f32.launches == launches
    assert out.shape == (2, t_len, h * d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # the bf16 wrapper routes a float32 projection to it
    assert torch.equal(
        attention.windowed_attention_halfperm(torch.from_numpy(hp), cos, sin, h, 127, 128), out)


@pytest.mark.parametrize("k,bias", [(512, True), (2048, False)])
def test_fused_norm_f32_form_matches_pallas_interpret(k, bias):
    """K14 at float32 at both of sup's sites, with a bias and a norm weight
    drawn from the seed: 2e-5 relative and absolute, the JAX package's own
    test's tolerance."""
    rs = np.random.RandomState(k)
    x = rs.randn(2, 90, k).astype(np.float32)
    w = (rs.randn(512, k) / np.sqrt(k)).astype(np.float32)
    b = rs.randn(512).astype(np.float32) if bias else None
    res = rs.randn(2, 90, 512).astype(np.float32)
    nw = (1.0 + 0.3 * rs.randn(512)).astype(np.float32)
    alpha = 2.4494897
    ref = jax_fused(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                    jnp.asarray(res), jnp.asarray(nw), alpha, interpret=True)
    launches = fused_norm.matmul_residual_rmsnorm_f32.launches
    out = fused_norm.matmul_residual_rmsnorm_f32(
        torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b),
        torch.from_numpy(res), torch.from_numpy(nw), alpha,
    )
    assert fused_norm.matmul_residual_rmsnorm_f32.launches == launches
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the quantised head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
def test_quantised_head_matches_jax(seed):
    """``quantize_tx_head_w8a8`` on the carried float model holds the int8
    weights and scales that ``tx_params_from_jax`` carries from the JAX
    package's, and the scores of the quantised head (float32 here) match
    ``tx_forward``'s on those parameters: the upsample's output is quantised
    again per row inside the CRF head's K2, so a float32 sum in front of a
    rounding boundary moves an int8 step now and then, as in the W8A8
    encoder test of ``tests/test_torch_tx_model.py``: mean under 2e-3 and
    max under 0.5 on scores of size 30, and far inside the quantisation's
    own error."""
    jcfg, tcfg = small_sup(jax_sup_config()), small_sup(sup_v50_config())
    params = jax_tx_params(seed)
    qp = jax.tree_util.tree_map(np.array, jax_quantize_head(params))
    sig = _signal(seed)
    ref = np.asarray(tx_forward(qp, jnp.asarray(sig), jcfg))
    full = np.asarray(tx_forward(params, jnp.asarray(sig), jcfg))
    carried = tx_params_from_jax(qp, tcfg)
    own = quantize_tx_head_w8a8(tx_params_from_jax(params, tcfg))
    assert carried.head_quantised and own.head_quantised
    assert not hasattr(own, "crf_w") and not hasattr(own, "upsample_w")
    for name in ("upsample_w", "crf_w"):
        assert torch.equal(getattr(own, name + "_q"), getattr(carried, name + "_q"))
        np.testing.assert_allclose(getattr(own, name + "_s").numpy(),
                                   getattr(carried, name + "_s").numpy(), rtol=1e-7, atol=0)
    out = _scores(carried, sig)
    err = np.abs(out - ref)
    assert err.mean() < 2e-3 and err.max() < 0.5, (err.mean(), err.max())
    assert err.mean() < 0.1 * np.abs(ref - full).mean()
    np.testing.assert_array_equal(_scores(own, sig), out)
    # quantising twice changes nothing; a bf16 copy keeps its head constants
    # in float32 once frozen
    assert torch.equal(quantize_tx_head_w8a8(own).crf_w_q, own.crf_w_q)
    own.freeze_constants()
    own.to(torch.bfloat16)
    assert own._frozen_head["crf_s"].dtype == torch.float32
    with torch.inference_mode():
        bf16 = own(torch.from_numpy(sig), score_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and bf16.shape == out.transpose(1, 0, 2).shape


# ---------------------------------------------------------------------------
# the runner and the pipeline at each compute type
# ---------------------------------------------------------------------------


def _identity(ref_seqs, out_seqs) -> tuple[float, float]:
    """(1 - the reads' summed edit distance over their summed lengths, the
    longer of each pair's; the share of equal calls), the distances from the
    port's aligner."""
    dist = sum(align(a, b).distance for a, b in zip(ref_seqs, out_seqs))
    total = sum(max(len(a), len(b)) for a, b in zip(ref_seqs, out_seqs))
    equal = np.mean([a == b for a, b in zip(ref_seqs, out_seqs)])
    return 1.0 - dist / max(total, 1), float(equal)


def _assert_calls_close(ref, out, dtype, qstrings=True):
    """float32: sequences and moves equal, qual chars a step apart at under
    1% of positions (the runner tests' rule); bf16: MIN_BF16_IDENTITY."""
    ref_seqs, out_seqs = [r.sequence for r in ref], [r.sequence for r in out]
    assert sum(map(len, ref_seqs)) > 100 * len(ref)  # the path emits bases
    if dtype == "bfloat16":
        assert [len(r.moves) for r in out] == [len(r.moves) for r in ref]
        ratio, _ = _identity(ref_seqs, out_seqs)
        assert ratio >= MIN_BF16_IDENTITY, ratio
        return
    counts = [0, 0]
    for x, y in zip(ref, out):
        assert y.sequence == x.sequence
        np.testing.assert_array_equal(y.moves, x.moves)
        if qstrings:
            assert_qstrings_close(y.qstring, x.qstring, counts)
    assert counts[0] <= 0.01 * counts[1]


@functools.lru_cache(maxsize=None)
def _runners(family, dtype):
    if family == "lstm":
        params = jax_params_with_moves(2)
        jcfg, cfg = _narrow_hac(jax_hac_config()), _narrow_hac(hac_v43_config())
        model, chunk = params_from_jax(params, cfg), CHUNK
    else:
        params = jax_tx_params(3)
        jcfg, cfg = small_sup(jax_sup_config()), small_sup(sup_v50_config())
        model, chunk = tx_params_from_jax(params, cfg), TX_CHUNK
    jr = BasecallRunner(jcfg, params, chunk_size=chunk, batch_size=BATCH, decoder="viterbi",
                        compute_dtype=JAX_DTYPES[dtype])
    tr = TorchBasecallRunner(cfg, model, chunk_size=chunk, batch_size=BATCH, device="cpu",
                             compute_dtype=TORCH_DTYPES[dtype])
    return jr, tr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["lstm", "tx"])
def test_runner_matches_jax(family, dtype):
    """One batch of white-noise chunks through both runners at the same
    compute type; the port's model holds that type and decodes float32
    scores on the CPU, as the JAX runner's CPU path does."""
    jr, tr = _runners(family, dtype)
    assert tr.compute_dtype == TORCH_DTYPES[dtype] and tr.score_dtype == torch.float32
    assert next(tr.model.parameters()).dtype == TORCH_DTYPES[dtype]
    buf = tr.make_input_buffer(0)
    buf[:] = np.random.RandomState(21).randn(*buf.shape).astype(np.float16)
    n = buf.shape[0] - 1
    ref = jr.call_chunks(buf.copy(), n)
    out = tr.call_chunks(buf.copy(), n)
    assert len(out) == len(ref) == n
    # the transformer's qual chars at float32: the tolerance of the runner
    # tests' transformer cases (up to 3 steps at phred 40 and above)
    _assert_calls_close(ref, out, dtype, qstrings=family == "lstm")


@pytest.mark.parametrize("family", ["lstm", "tx"])
def test_bf16_scores_match_jax(family):
    """The models' scores at bf16 (the JAX model on bf16 parameters, the
    port's cast to bf16) on the same white-noise chunks: the two packages
    apart by at most MAX_BF16_SCORE_RATIO times the larger of each
    package's own bf16-to-float32 difference; at float32 by 1e-5 of the
    mean abs score (measured 2e-7 and 9e-7)."""
    if family == "lstm":
        params = jax_params_with_moves(2)
        jcfg, model = _narrow_hac(jax_hac_config()), params_from_jax(
            params, _narrow_hac(hac_v43_config()))
        chunk = CHUNK
    else:
        params = jax_tx_params(3)
        jcfg, model = small_sup(jax_sup_config()), tx_params_from_jax(
            params, small_sup(sup_v50_config()))
        chunk = TX_CHUNK
    sig = np.random.RandomState(21).randn(7, chunk).astype(np.float16).astype(np.float32)
    forward = lstm_crf_forward if family == "lstm" else tx_forward
    scores = {}
    for dtype in ("float32", "bfloat16"):
        cast = jax.tree_util.tree_map(lambda x: jnp.asarray(x, JAX_DTYPES[dtype]), params)
        scores["jax", dtype] = np.asarray(
            forward(cast, jnp.asarray(sig, JAX_DTYPES[dtype]), jcfg).astype(jnp.float32))
        with torch.inference_mode():
            out = model.to(TORCH_DTYPES[dtype])(torch.from_numpy(sig)).float().numpy()
        scores["port", dtype] = out.transpose(1, 0, 2)  # time-major -> the JAX layout

    def rel(a, b):
        return float(np.abs(scores[a] - scores[b]).mean() / np.abs(scores[b]).mean())

    assert rel(("port", "float32"), ("jax", "float32")) <= 1e-5
    across = rel(("port", "bfloat16"), ("jax", "bfloat16"))
    own = max(rel(("jax", "bfloat16"), ("jax", "float32")),
              rel(("port", "bfloat16"), ("port", "float32")))
    assert 0 < across <= MAX_BF16_SCORE_RATIO * own, (across, own)


@functools.lru_cache(maxsize=None)
def _bf16_route_reference():
    """(the JAX parameters with biases and norm weights drawn from the seed,
    the signal, tx_forward's bf16 and float32 scores)."""
    params = with_drawn_biases(jax_tx_params(5), 5)
    jcfg = small_sup(jax_sup_config())
    sig = _signal(5)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cast = jax.tree_util.tree_map(lambda x: jnp.asarray(x, JAX_DTYPES[dtype]), params)
        out[dtype] = np.asarray(
            tx_forward(cast, jnp.asarray(sig, JAX_DTYPES[dtype]), jcfg).astype(jnp.float32))
    return params, sig, out["bfloat16"], out["float32"]


@pytest.mark.parametrize(
    "attention,fused_norm", list(itertools.product(("extf", "ext", "hp"), (False, True)))
)
def test_bf16_routes_match_jax(attention, fused_norm):
    """Each attention and norm route in bf16 on the CPU, with biases and norm
    weights drawn from the seed, against ``tx_forward`` in bf16 on the same
    parameters: apart by at most MAX_BF16_SCORE_RATIO times the JAX bf16
    scores' own difference from its float32 ones (measured 1.12 on every
    route: on the CPU the routes give the same scores; the float32 routes
    are held in ``tests/test_torch_tx_model.py``)."""
    params, sig, ref, full = _bf16_route_reference()
    model = with_routes(tx_params_from_jax(params, small_sup(sup_v50_config())), attention,
                        fused_norm).to(torch.bfloat16)
    with torch.inference_mode():
        out = model(torch.from_numpy(sig)).float().numpy().transpose(1, 0, 2)
    across = np.abs(out - ref).mean() / np.abs(ref).mean()
    own = np.abs(ref - full).mean() / np.abs(full).mean()
    assert across <= MAX_BF16_SCORE_RATIO * own, (across, own)


# ---------------------------------------------------------------------------
# sizing, arguments and routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["hac", "sup"])
def test_bytes_per_chunk_timestep_at_4_bytes(family):
    ours = {"hac": hac_v43_config, "sup": sup_v50_config}[family]()
    theirs = {"hac": jax_hac_config, "sup": jax_sup_config}[family]()
    for compute_bytes in (2, 4):
        assert batch_size.bytes_per_chunk_timestep(ours, compute_bytes) == (
            jax_batch_size.bytes_per_chunk_timestep(theirs, compute_bytes))
    assert batch_size.bytes_per_chunk_timestep(ours, 4) > batch_size.bytes_per_chunk_timestep(ours)
    gb = 80 * 1024**3
    assert batch_size.max_safe_batch_size(ours, 10_000, gb, compute_bytes=4) <= (
        batch_size.max_safe_batch_size(ours, 10_000, gb))


def test_compute_dtype_argument():
    cpu = torch.device("cpu")
    assert resolve_compute_dtype(None, cpu) == torch.float32
    assert resolve_compute_dtype(None, torch.device("cuda")) == torch.bfloat16
    assert resolve_compute_dtype(torch.bfloat16, cpu) == torch.bfloat16
    for bad in (torch.float16, "float32", jnp.float32):
        with pytest.raises(ValueError, match="unknown compute_dtype"):
            resolve_compute_dtype(bad, cpu)
    cfg = _narrow_hac(hac_v43_config())
    model = params_from_jax(jax_params_with_moves(2), cfg)
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        TorchBasecallRunner(cfg, model, device="cpu", compute_dtype=torch.float64)


@pytest.mark.parametrize("fused_norm", [False, True])
def test_hp_float32_runner_matches_jax(fused_norm):
    """The ``"hp"`` route at float32 (K11a's float32 form on the card, its
    plain version here), with and without the fused norms, against the JAX
    runner at float32 on the same batch: the float32 transformer's
    tolerance of ``test_runner_matches_jax``."""
    jr, _ = _runners("tx", "float32")
    cfg = small_sup(sup_v50_config())
    tr = TorchBasecallRunner(cfg, tx_params_from_jax(jax_tx_params(3), cfg), chunk_size=TX_CHUNK,
                             batch_size=BATCH, device="cpu", tx_attention="hp",
                             tx_fused_norm=fused_norm, compute_dtype=torch.float32)
    assert tr.model.attention == "hp" and tr.model.fused_norm == fused_norm
    buf = tr.make_input_buffer(0)
    buf[:] = np.random.RandomState(21).randn(*buf.shape).astype(np.float16)
    n = buf.shape[0] - 1
    ref = jr.call_chunks(buf.copy(), n)
    out = tr.call_chunks(buf.copy(), n)
    assert len(out) == len(ref) == n
    _assert_calls_close(ref, out, "float32", qstrings=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ATTENTION_ROUTES)
def test_every_route_runs_at_each_dtype(route, dtype):
    """Every attention route takes either compute type (none is refused: on
    the card ``"hp"`` runs K11a's float32 form at float32): the runner holds
    its route and type and calls a chunk."""
    cfg = small_sup(sup_v50_config())
    runner = TorchBasecallRunner(cfg, tx_params_from_jax(jax_tx_params(3), cfg), device="cpu",
                                 chunk_size=TX_CHUNK, batch_size=BATCH, tx_attention=route,
                                 compute_dtype=TORCH_DTYPES[dtype])
    assert runner.model.attention == route and runner.compute_dtype == TORCH_DTYPES[dtype]
    assert next(runner.model.parameters()).dtype == TORCH_DTYPES[dtype]
    assert len(runner.call_chunks(runner.make_input_buffer(1), 1)) == 1
