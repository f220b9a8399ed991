"""Automatic batch-size selection (``basecaller -b 0``).

Port of ``dorado_tpu/basecall/batch_size.py``. The reference sizes batches
per GPU from available memory plus a benchmark sweep at 288*stride-sample
chunks, cached per (device, model) (CudaCaller::determine_batch_dims,
CudaCaller.cpp:371-520):

  - an analytic per-(chunk, timestep) activation estimate caps the batch to
    what fits the card's free memory;
  - the sweep runs the runner's device step (model and decoder) at the same
    288*stride benchmark chunk for doubling batch sizes, picks the fastest
    per sample, and caches the result in
    ``~/.cache/dorado_tpu_torch/batch_benchmarks.json`` (or under
    ``$DORADO_TPU_TORCH_CACHE_DIR``) keyed by (card name, model name, chunk
    size, compute dtype).

With several cards (``device`` as ``TorchBasecallRunner`` takes it), the
sweep sizes the first card alone, and every replica gets that batch: the
runner's ``batch_size`` is each replica's.

Where it differs from the JAX module, on purpose: the memory is the card's
(``torch.cuda.mem_get_info``), not a TPU constant; only
``torch.cuda.OutOfMemoryError`` ends the sweep (any other fault is raised);
no table of benchmarked batch sizes ships with it; the cache key is the
card's name; and the sweep times the whole device step, not the model
alone.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

GB = 1024**3
BATCH_GRANULARITY = 64
MEMORY_LIMIT_FRACTION = 0.85
MAX_AUTO_BATCH = 4096


def bytes_per_chunk_timestep(config, compute_bytes: int = 2) -> int:
    """Dominant per-(chunk, output-timestep) activation footprint: LSTM gate
    buffers, CRF scores, decode scans and beam history, with a 1.5x slack
    for temporaries."""
    insize = getattr(config, "lstm_size", 0) or getattr(config, "d_model", 0) or 512
    if insize < 0:  # a transformer's config holds its width elsewhere
        insize = config.tx.tx.d_model
    act = (
        # pre-projected gates (double-buffered) + layer activations
        2 * 4 * insize * compute_bytes
        + 4 * insize * compute_bytes
        # scores [C] f32 + fwd/bwd/posts scans [S] f32
        + config.outsize * 4
        + 3 * config.num_states * 4
        # beam history: state i32 + parent i8 + stay u8 per beam elem (32)
        + 32 * 6
    )
    return int(act * 1.5)


def max_safe_batch_size(
    config,
    chunk_size: int,
    memory_bytes: int,
    limit_fraction: float = MEMORY_LIMIT_FRACTION,
    compute_bytes: int = 2,
) -> int:
    """The largest multiple of 64 rows whose activations fit ``memory_bytes``
    (less 1 GB for weights and the runtime), at least 64; ``compute_bytes``
    is the compute dtype's element size (2 for bf16, 4 for float32)."""
    t_out = chunk_size // config.stride
    per_chunk = bytes_per_chunk_timestep(config, compute_bytes) * t_out
    budget = int(memory_bytes * limit_fraction) - 1 * GB
    n = max(budget // per_chunk, BATCH_GRANULARITY)
    return int(n - (n % BATCH_GRANULARITY))


def _cache_path() -> Path:
    root = os.environ.get("DORADO_TPU_TORCH_CACHE_DIR") or os.path.expanduser(
        "~/.cache/dorado_tpu_torch"
    )
    return Path(root) / "batch_benchmarks.json"


def auto_batch_size(
    config,
    model,
    chunk_size: int,
    device: torch.device | str | None = None,
    decoder: str = "viterbi",
    max_batch: int | None = None,
    use_cache: bool = True,
    timings: list | None = None,
    compute_dtype: torch.dtype | None = None,
) -> int:
    """Benchmark sweep at 288*stride samples (the reference's benchmark
    chunk), doubling batch sizes from 64 up to the memory cap (or
    ``max_batch``); returns the batch with the best per-sample time.
    ``timings``, when given, receives (batch, seconds per step) of each
    size swept. ``compute_dtype`` is the runner's (None: its default). The
    sweep runs on ``device``'s first card (``resolve_device``). On
    the CPU, ``max_batch`` must be given: there is no card memory to size
    against."""
    from dorado_tpu_torch.basecall.runner import (
        TorchBasecallRunner,
        resolve_compute_dtype,
        resolve_device,
    )

    dev = resolve_device(device)
    dtype = resolve_compute_dtype(compute_dtype, dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    key = f"{kind}|{config.model_name}|{chunk_size}|{str(dtype).removeprefix('torch.')}"
    cp = _cache_path()
    cache = {}
    if use_cache and cp.exists():
        try:
            cache = json.loads(cp.read_text())
        except (OSError, ValueError):
            cache = {}  # an unreadable cache is swept again and rewritten
        if key in cache:
            return int(cache[key])

    if max_batch is None:
        if dev.type != "cuda":
            raise ValueError("auto_batch_size on the CPU needs max_batch")
        free, _total = torch.cuda.mem_get_info(dev)
        max_batch = min(
            max_safe_batch_size(config, chunk_size, free, compute_bytes=dtype.itemsize),
            MAX_AUTO_BATCH,
        )
    bench_chunk = 288 * config.stride_inner
    runner = TorchBasecallRunner(
        config, model, chunk_size=bench_chunk, batch_size=max_batch, device=dev, decoder=decoder,
        compute_dtype=dtype,
    )
    replica = runner.replicas[0]
    rs = np.random.RandomState(0)
    best = (float("inf"), BATCH_GRANULARITY)
    n = BATCH_GRANULARITY
    while n <= max_batch:
        sig = torch.from_numpy(rs.randn(n, bench_chunk).astype(np.float16)).to(dev)
        try:
            runner._device_step(sig, replica)  # the first step at a shape sets up its plans
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                out = runner._device_step(sig, replica)
            out.cpu()  # waits for the device
            step_s = (time.perf_counter() - t0) / reps
        except torch.cuda.OutOfMemoryError:
            break
        if timings is not None:
            timings.append((n, step_s))
        per_sample = step_s / (n * bench_chunk)
        if per_sample < best[0]:
            best = (per_sample, n)
        n *= 2
    chosen = best[1]
    del runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the sweep's buffers, for the run that follows
    if use_cache:
        cp.parent.mkdir(parents=True, exist_ok=True)
        cache[key] = chosen
        cp.write_text(json.dumps(cache, indent=1))
    return chosen
