#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dorado_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the four CUDA kernels from ``dorado_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel).
3. Runs each kernel and its plain PyTorch version on the card at hac v4.3
   shapes (chunk 9996 -> T = 1666, batch N = 128, H = 384, S = 256, bf16),
   holds them against each other (K1 also at the short lane's shape and a
   512-row batch, so each of its rows-per-block variants and both
   directions are held) and times both, beside cuDNN's LSTM as a
   yardstick for the recurrence (cuDNN's time includes the input projection,
   which the kernel leaves to a matmul; the port never calls cuDNN's LSTM).
4. Drives the simplex pipeline (``BasecallerPipeline.run_reads`` into a
   ``BamWriter``) at hac v4.3's full width over 16 synthetic reads (14 of
   20k-60k samples, 2 of 3k-7k for the short-chunk lane) with seeded random
   weights, with every kernel launch counter at 0 before the run, and
   requires every kernel to have been launched by it.
5. Checks the device decode against the CPU's plain decode on the same
   scores (sequences and moves exactly) and the bf16 model on the card
   against the float32 model on the CPU.
6. Profiles one more full batch of the device step and prints its device
   time by kernel and the device's busy share.
7. Prints one JSON line of per-kernel numbers and, last, the device line.

No phase catches its own failure: any fault exits non-zero. Without CUDA, or
outside a checkout of the repository, it exits non-zero before printing a
result.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1234
T, N, H, S = 1666, 128, 384, 256  # hac v4.3 at chunk 9996, batch 128
STAY = 2.0
N_READS = 16
# random weights either stay on every step or move on most of them; this
# gain on the CRF head's weights makes the path emit bases
HEAD_GAIN = 64.0
# published H100 SXM peaks (dense): bf16 tensor cores, non-tensor f32, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12
# kernel vs plain version on the card, both in bf16 (max abs error):
# K1: the f32 sums of h @ W_hh run in another order, so h can round to the
#     neighbouring bf16 value (2^-8 at |h| < 1) and feed that to later steps
TOL_LSTM = 0.05
# K1 is also held at the other shapes the pipeline gives it, one per
# rows-per-block variant the wrapper picks on a 132-SM card: (T, N, reverse)
# of the short-chunk lane (chunk 7494 -> T = 1249, 256 rows: 2 a block,
# forward, as every second layer runs) and of a 512-row batch (4 a block;
# short T keeps the plain version's step loop quick)
LSTM_SHAPES = [(T, N, True), (1249, 2 * N, False), (64, 4 * N, True)]
# K3: the carry's f32 LSE sums run in another order; rows are bf16, whose
#     spacing is 2^-7 relative: |err| <= 0.05 + 2^-7 * |value|
TOL_BETA_ABS, TOL_BETA_REL = 0.05, 2.0**-7
# K4: posts in [0, 1] stored as bf16, from LSE sums in another order: one
#     bf16 step apart at most, which is <= 2^-7 of the value, plus slack
#     for the f32 sums near the smallest values:
#     |err| <= 1e-5 + 2^-7 * |value|, elementwise; choices and the final
#     carry must be identical
TOL_POSTS_ABS, TOL_POSTS_REL = 1e-5, 2.0**-7


def bound_ms(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    """Least time for the work: the larger of operations over the peak rate
    for their type and bytes (inputs read once, outputs written once) over
    the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    if not (ROOT / "dorado_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
    from dorado_tpu_torch.io.pod5 import Pod5Read, RunInfo
    from dorado_tpu_torch.io.sam import BamWriter
    from dorado_tpu_torch.models.crf_model import init_lstm_crf_params
    from dorado_tpu_torch.models.presets import hac_v43_config
    from dorado_tpu_torch.ops import _cuda, crf_cuda, lstm
    from dorado_tpu_torch.pipeline import BasecallerPipeline

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _cuda.build_kernels()
    print(f"built {len(libs)} kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    rows = []

    def report(name, source, replaces, err, ms, plain_ms, ops, peak, nbytes, library_ms,
               library_what=""):
        b_ms, b_by = bound_ms(ops, peak, nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        })
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms {library_what}"
        print(
            f"{name}: max_abs_err {err:.3g}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
            f"  bound {b_ms:.3f} ms ({b_by})  library {lib}  [{card}]",
            flush=True,
        )

    # ---- K1: LSTM recurrence ---------------------------------------------
    with torch.inference_mode():
        w_hh_t = ((torch.rand(H, 4 * H, generator=gen, device=dev) * 2 - 1) / H**0.5).bfloat16()
        err = 0.0
        for t_len, n, reverse in LSTM_SHAPES:
            xproj = (torch.randn(t_len, n, 4 * H, generator=gen, device=dev) * 0.8).bfloat16()
            out_k = lstm.lstm_scan_time_major(xproj, w_hh_t, reverse=reverse)
            out_p = lstm.lstm_scan_plain(xproj, w_hh_t, reverse=reverse)
            torch.cuda.synchronize()
            e = (out_k.float() - out_p.float()).abs().max().item()
            print(f"lstm_scan T={t_len} N={n} reverse={reverse} "
                  f"({lstm._rows_per_block(n, dev)} rows a block): max abs error {e:.3g}",
                  flush=True)
            if not e <= TOL_LSTM:
                raise AssertionError(f"lstm_scan at T={t_len} N={n}: max abs error {e} > {TOL_LSTM}")
            err = max(err, e)
        del out_k, out_p
        # the timed shape: hac's long lane, reversed as the first layer runs
        xproj = (torch.randn(T, N, 4 * H, generator=gen, device=dev) * 0.8).bfloat16()
        cudnn = torch.nn.LSTM(H, H, device=dev, dtype=torch.bfloat16)
        cudnn.flatten_parameters()
        x_in = torch.randn(T, N, H, generator=gen, device=dev).bfloat16()
        report(
            "lstm_scan", "dorado_tpu_torch/csrc/lstm_scan.cu", "dorado_tpu/ops/lstm.py:65",
            err,
            time_ms(lambda: lstm.lstm_scan_time_major(xproj, w_hh_t, reverse=True), 3),
            time_ms(lambda: lstm.lstm_scan_plain(xproj, w_hh_t, reverse=True), 1),
            2.0 * T * N * H * 4 * H, PEAK_BF16, 2 * (T * N * 4 * H + H * 4 * H + T * N * H),
            time_ms(lambda: cudnn(x_in), 3),
            "(cuDNN nn.LSTM, one layer, incl. its input projection)",
        )
        del xproj, cudnn, x_in

        # ---- K3: backward LSE scan, shifted ------------------------------
        scores = (torch.randn(T, N, 4 * S, generator=gen, device=dev) * 2).clamp(-5, 5).bfloat16()
        beta_k = crf_cuda.backward_scores_shifted(scores, STAY)
        beta_p = crf_cuda.backward_scores_shifted_plain(scores, STAY)
        torch.cuda.synchronize()
        diff = (beta_k.float() - beta_p.float()).abs()
        if not bool((diff <= TOL_BETA_ABS + TOL_BETA_REL * beta_p.float().abs()).all()):
            raise AssertionError(f"crf_lse_backward: max abs error {diff.max().item()}")
        report(
            "crf_lse_backward", "dorado_tpu_torch/csrc/crf_lse_backward.cu",
            "dorado_tpu/ops/crf_pallas.py:461", diff.max().item(),
            time_ms(lambda: crf_cuda.backward_scores_shifted(scores, STAY), 3),
            time_ms(lambda: crf_cuda.backward_scores_shifted_plain(scores, STAY), 1),
            17.0 * T * N * S, PEAK_F32, 2 * T * N * 4 * S + 2 * T * N * S, None,
        )

        # ---- K4: fused forward pass -------------------------------------
        posts_k, ch_k, fin_k = crf_cuda.fused_forward_decode(scores, beta_k, STAY)
        posts_p, ch_p, fin_p = crf_cuda.fused_forward_decode_plain(scores, beta_k, STAY)
        torch.cuda.synchronize()
        if not torch.equal(ch_k, ch_p) or not torch.equal(fin_k, fin_p):
            bad = (ch_k != ch_p).sum().item()
            raise AssertionError(f"crf_fused_forward: {bad} choices differ (or the final carry)")
        diff = (posts_k.float() - posts_p.float()).abs()
        if not bool((diff <= TOL_POSTS_ABS + TOL_POSTS_REL * posts_p.float().abs()).all()):
            raise AssertionError(f"crf_fused_forward: posts max abs error {diff.max().item()}")
        err = diff.max().item()
        report(
            "crf_fused_forward", "dorado_tpu_torch/csrc/crf_fused_forward.cu",
            "dorado_tpu/ops/crf_pallas.py:937", err,
            time_ms(lambda: crf_cuda.fused_forward_decode(scores, beta_k, STAY), 3),
            time_ms(lambda: crf_cuda.fused_forward_decode_plain(scores, beta_k, STAY), 1),
            30.0 * T * N * S, PEAK_F32,
            2 * T * N * 4 * S + 2 * T * N * S + 2 * T * N * S + T * N * S + 4 * N * S, None,
        )

        # ---- K5: traceback ----------------------------------------------
        last = torch.argmax(fin_k, dim=-1).to(torch.int32)
        st_k, mv_k = crf_cuda.viterbi_traceback(ch_k, last)
        st_p, mv_p = crf_cuda.viterbi_traceback_plain(ch_k, last)
        torch.cuda.synchronize()
        if not torch.equal(st_k, st_p) or not torch.equal(mv_k, mv_p):
            raise AssertionError("crf_traceback: states or moves differ from the plain version")
        err = max((st_k - st_p).abs().max().item(),
                  (mv_k.int() - mv_p.int()).abs().max().item())
        report(
            "crf_traceback", "dorado_tpu_torch/csrc/crf_traceback.cu",
            "dorado_tpu/ops/crf_pallas.py:762", float(err),
            time_ms(lambda: crf_cuda.viterbi_traceback(ch_k, last), 3),
            time_ms(lambda: crf_cuda.viterbi_traceback_plain(ch_k, last), 1),
            # one choice byte read per step and row, states and moves written
            4.0 * T * N, PEAK_F32, T * N * (1 + 4 + 1) + 4 * N, None,
        )
        del scores, beta_k, beta_p, diff, posts_k, posts_p, ch_k, ch_p, st_k, st_p
    torch.cuda.empty_cache()

    # ---- main path: the simplex pipeline at hac v4.3's full width ----------
    cfg = hac_v43_config()
    cfg.normalise_basecaller_params()
    model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.linear1_w.mul_(HEAD_GAIN)
    pipe = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True)
    if pipe.runner.chunk_size // cfg.stride != T:
        raise AssertionError(f"chunk size {pipe.runner.chunk_size} does not give T = {T}")

    rs = np.random.RandomState(SEED)
    run_info = RunInfo(
        acquisition_id="smoke", sample_rate=5000, flow_cell_id="FAB00000",
        flow_cell_product_code="FLO-PRO114M", protocol_run_id="smoke-run",
        acquisition_start_time_ms=1_700_000_000_000, sample_id="smoke",
    )

    reads = []
    for i in range(N_READS):
        # two short reads send chunks to the short-chunk lane too
        n = int(rs.randint(3_000, 7_001) if i < 2 else rs.randint(20_000, 60_001))
        # raw ADC around hac's standardisation mean (91.88 pA at 0.2 pA/ADC)
        signal = np.clip(rs.normal(460, 113, n), -32768, 32767).astype(np.int16)
        reads.append(Pod5Read(
            read_id=f"read-{i}", signal=signal, read_number=i, start_sample=0,
            median_before=200.0, channel=i + 1, well=1, pore_type="not_set",
            calibration_offset=0.0, calibration_scale=0.2, end_reason="signal_positive",
            end_reason_forced=False, open_pore_level=float("nan"),
            num_reads_since_mux_change=0, time_since_mux_change=0.0,
            num_minknow_events=0, tracked_scaling_scale=float("nan"),
            tracked_scaling_shift=float("nan"), predicted_scaling_scale=float("nan"),
            predicted_scaling_shift=float("nan"), run_info=run_info,
            filename="smoke.pod5",
        ))

    class Discard:
        def write(self, rec):
            pass

    # a first run over the same reads pays the one-time set-up of each new
    # batch shape (cuDNN and cuBLAS plans), which the measured run then reuses
    t0 = time.perf_counter()
    pipe.run_reads(reads, Discard())
    torch.cuda.synchronize()
    print(f"first run, incl. per-shape set-up: {time.perf_counter() - t0:.3f} s", flush=True)
    bam = io.BytesIO()
    writer = BamWriter(bam, pipe.build_header([run_info]))
    wrappers = {
        "lstm_scan": lstm.lstm_scan_time_major,
        "crf_lse_backward": crf_cuda.backward_scores_shifted,
        "crf_fused_forward": crf_cuda.fused_forward_decode,
        "crf_traceback": crf_cuda.viterbi_traceback,
    }
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = pipe.run_reads(reads, writer)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    writer.close()

    data = bam.getvalue()
    if stats.reads_called != N_READS or writer.records_written != N_READS:
        raise AssertionError(f"{writer.records_written} of {N_READS} reads written")
    if data[:4] != b"\x1f\x8b\x08\x04":
        raise AssertionError("output does not start with the BGZF magic")
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched by the main path")
    samples = sum(len(r.signal) for r in reads)
    print(
        f"pipeline: {N_READS} reads, {samples} samples, {stats.batches} batches, "
        f"{stats.bases_called} bases in {elapsed:.3f} s = {samples / elapsed:.0f} samples/s "
        f"(hac v4.3, batch {N}, bf16) [{card}]; launches {launches}; "
        f"device idle {stats.device_idle_s:.3f} s, host blocked in dispatch "
        f"{stats.dispatch_wait_s:.3f} s and in finish {stats.finish_wait_s:.3f} s",
        flush=True,
    )

    # ---- outputs against a reference on a small input ----------------------
    runner = pipe.runner
    cpu_runner = TorchBasecallRunner(cfg, model, batch_size=N, device="cpu")
    sig = np.stack([
        pipe.scaler.scale_read(r.signal, read_scale=0.2)[0][10 : 10 + runner.chunk_size]
        for r in reads[2:6]  # long reads: each fills a whole chunk
    ]).astype(np.float16)
    with torch.inference_mode():
        scores = runner.model(torch.from_numpy(sig).to(dev))
        ref_scores = cpu_runner.model(torch.from_numpy(sig))
        if scores.shape != (T, 4, cfg.outsize) or not bool(torch.isfinite(scores).all()):
            raise AssertionError("model scores are not finite or of the wrong shape")
        score_err = (scores.cpu() - ref_scores).abs()
        if not score_err.mean() <= 0.02 * ref_scores.abs().mean():
            raise AssertionError(f"bf16 model vs float32 model: mean abs error {score_err.mean()}")
        scores = scores.to(torch.bfloat16)
        on_card = runner.decode_scores(scores).cpu().numpy()
        on_cpu = cpu_runner.decode_scores(scores.float().cpu()).numpy()
    if not (np.array_equal(on_card[0], on_cpu[0]) and np.array_equal(on_card[2], on_cpu[2])):
        raise AssertionError("device decode: sequences or moves differ from the CPU decode")
    emit = on_card[2].astype(bool)
    q = on_card[1][emit].astype(np.int32) - 33
    if emit.sum() == 0 or q.min() < 1 or q.max() > 50:
        raise AssertionError("device decode: no bases, or qual chars out of [1, 50]")
    print(
        f"reference check: bf16 scores vs float32 mean abs {score_err.mean():.4f} "
        f"(max {score_err.max():.4f}); {int(emit.sum())} bases equal to the CPU decode, "
        f"qual chars differing at {np.mean(on_card[1][emit] != on_cpu[1][emit]):.3%}",
        flush=True,
    )

    # ---- where the device step's time goes (one full batch, profiled) ------
    from torch.profiler import ProfilerActivity, profile

    buf = runner.make_input_buffer(0)
    buf[:] = rs.randn(*buf.shape)
    runner.call_chunks(buf, buf.shape[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.call_chunks(buf, buf.shape[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = sorted(
        ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    busy_ms = sum(ms for _, ms in by_kernel)
    print(
        f"device step (batch {buf.shape[0]}): wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}) [{card}]",
        flush=True,
    )
    for key, ms in by_kernel[:8]:
        print(f"  {ms:9.3f} ms {ms / busy_ms:6.1%}  {key[:90]}")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
