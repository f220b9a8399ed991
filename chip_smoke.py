#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dorado_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the eleven CUDA kernel sources of ``dorado_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and prints their register and spill
   reports; fails if ptxas serialised the ``wgmma`` of any kernel. Builds
   the read splitter's aligner (``csrc/align.cpp``, host C++) with ``g++``
   and prints the compiler's version.
3. Runs each kernel and its plain PyTorch version on the card at hac v4.3
   shapes (chunk 9996 -> T = 1666, batch N = 128, H = 384, S = 256), holds
   them against each other and times both, beside a PyTorch call that
   computes the same function where there is one (the port never calls it):
   K1 (LSTM recurrence, W_hh resident in a thread-block cluster) at the
   pipeline's shapes, at each rows-a-cluster choice and at three other
   widths, both directions, timed at N = 128 and 512 each beside cuDNN's
   LSTM at the same N, with its split and microseconds a step; K15 (the
   recurrence with int8 W_hh, on K1's kernel with int8 elements), both
   directions, at hac's shapes, ragged batches, T = 1 and 3 and two other
   widths, timed at N = 128 and 512 on its split and on clusters of 4, with its
   split and microseconds a step, on no path; K16 (the input
   projection inside the recurrence, on K1's kernel) at K1's widths and
   batches in both directions, timed at N = 128 and 512 beside cuDNN's LSTM
   with its split, on no path; K1 float32 (K1's kernel with float32
   elements and 3xTF32 products: the modbase models' LSTMs) in both
   directions at the modbase shape (T = 32, H = 256) at N = 128 and 1024 and
   at hac's H and T at N = 128, each timed beside cuDNN's float32 LSTM with
   TF32 off, and at two ragged shapes launched into outputs filled with NaN
   first; K2 (W8A8 projection) bit for bit at three row
   counts and at 357 rows of its widest (K = 768, O = 3072) and narrowest
   (128, 128) weights, beside the bf16 matmul it replaces and
   ``torch._int_mm`` with separate quantise and dequantise passes; K3, K4, K5 (the Viterbi path's
   scans and traceback; K3 and K4 also at the fast model's 64 states, K4
   timed at its full chunk, and at T and N that are no multiple of their
   rings or warps, at 64, 256 and 1024 states, each with K7's choices equal
   to K4's, launched into choices filled with a sentinel first, and so at
   one step of one row at each state count); K6 (full-history LSE scans) in
   each direction and both in one
   launch (the runner's call; also at those T and N), timed beside a float64
   operation bound; K7a
   (the Viterbi forward pass alone, also at 64 states), equal to K4's choices,
   with ``viterbi_path`` equal to K4 + K5's path; K8 (K4's pass on float32
   streams and the unshifted beta, also at 64 states), its choices equal to
   K7a's and, on K4's inputs, its posts a bf16 step from K4's; K17 (beam
   search) on outcomes against the plain beam at the full T (and at 64
   states at a short T, and at T below its ring's depth and ragged T and N
   at 64, 256 and 1024 states), and its traceback exactly. K5 and the beam
   traceback are also held at T = 1, T one below and one above their rings'
   depths and N of 1, 3 and 37 (K5 at 64, 256 and 1024 states on K7's
   choices, timed at the fast model's 64 states), each written into outputs
   filled with a sentinel first, so that every position must be written;
   each prints the design floor of streaming its whole history beside its
   bound. The two tracebacks take about as long as a host launch, so their
   times are the profiler's device times.
   Then the same at sup v5.0 shapes (chunk 12288 -> T' = 1024 tokens and
   T = 2048 decode steps, batch N = 128, d_model 512, 8 heads, ffn 2048,
   S = 1024): the banded attention on each layout, beside
   ``scaled_dot_product_attention`` with the same mask: K9 (RoPE inside) at
   T' = 1024 and 700, K10 (q and k rotated beforehand), K11a (halves-major q
   and k rows, RoPE inside), K11b (separate q, k, v; also at window
   (200, 256)); K14 (matmul + bias + scaled residual + RMS norm) at out_proj
   and at fc2, each at three row counts, beside the unfused passes; K12 (fc1 + SwiGLU
   + requantisation) and K13 (int8 fc2, bit for bit) at four row counts,
   beside ``torch._int_mm`` routes, K13 also at three other weight shapes
   (clusters of 1 and 2 CTAs, K = 128), each against the plain version and
   the ``torch._int_mm`` route, printing its plan, K12 also at its narrowest shape, at one
   that takes its two-pass form, and in the two-pass form at sup's shape
   (timed beside the one pass), and its branch-free reciprocal against
   ``__frcp_rn`` at every float of its range; K2 at sup's qkv shape bit for bit; K3,
   K4, K5 at 1024 states; the full-history scans at 1024 states (K3's
   forward and unshifted backward outputs); K7b, with the cross-checks of
   K7a; K8, its choices equal to K7b's; K17 and its traceback at 1024 states on the sup model's float32
   scores, against the plain beam on all 128 rows at the full T.
   Then the float32 forms (``float32_kernels``): K2 at float32 (float32 rows
   in, float32 gates out) at hac's projection and sup's qkv, K13 writing
   float32 at sup's fc2 (both bit for bit), K10 on float32 q, k and v at sup's
   shape (within TOL_ATTN_F32) and K14 at float32 at out_proj and fc2
   (within TOL_NORM_F32), each also at a ragged shape launched into an output
   filled with NaN first, and timed beside its bound, its plain version and
   float32 ``F.linear``, ``torch._int_mm`` + dequantise, SDPA in float32 or
   the unfused float32 passes. Then ``wide_kernels``: K1's wide form (the
   LSTM recurrence at widths no cluster of 16 CTAs holds: W_hh split into
   register, shared-memory and L2-streamed pairs of k-tiles) in bf16 at H =
   768 and 1024 and in float32 at 768 and 448, both directions, at T = 1666,
   N = 128 and at ragged batches, into NaN-filled outputs, each timed beside
   its bound and cuDNN's LSTM (float32: TF32 off), printing its split; and
   K11a at float32 (halves-major q and k rotated while staged, the float32
   body) at sup's shape and a ragged one, beside SDPA in float32.
   Then ``duplex_kernels``: K1 in bf16 and float32 at the stereo runner's
   shapes (T = 2000, H = 384, N = 1, 3 and 32, both directions, into
   NaN-filled outputs), each timed beside cuDNN's LSTM, and K2 at the rows
   of 3 and 32 stereo chunks bit for bit, beside the ``torch._int_mm`` route
   (``stereo_*`` keys of their rows).
4. Drives the simplex pipeline (``BasecallerPipeline.run_reads`` into a
   ``BamWriter``, splitting reads, the default: every read must have its
   record or its subreads' records) at hac v4.3's full width over 16 synthetic reads (14 of
   20k-60k samples, 2 of 3k-7k for the short-chunk lane) with seeded random
   weights, once with the Viterbi decoder and once with the beam decoder,
   both with W8A8 input projections (the default on the card). Every launch
   counter is set to 0 before each run, and each run must have launched every
   kernel of its path. Then the same pipeline at sup v5.0's full width (18
   layers, batch 128, chunk 12288, W8A8 encoder matmuls, Viterbi) over 15
   reads (12 of 140k samples, which fill a batch, and 3 short ones for the
   9216 lane), three times: on the default attention route, where it must
   launch K2, K9, K12 and K13 18 times a batch, K3, K4 and K5 once a batch,
   and no other kernel; with ``tx_attention="hp", tx_fused_norm=True``, where
   K11a and K14 take K9's place and the norms' (18 times a batch each); and
   with ``decoder="beam"``, where the full-history scans (both directions
   in one launch), K17 and the beam traceback take K3's, K4's and K5's place
   (once a batch each). K7a, K7b and K8 are on no path (``"on_path": false``).
   Then modified-base calling (``modbase_phase``) with the 5mCG_5hmCG@v3
   model at full width (H = 256, random weights and kmer levels from the
   seed, written as a model directory): ``ModBaseCaller`` on the card and on
   the CPU over 24 synthetic reads of 2-8 kb (MM equal, ML within 1 and equal
   at 99.9% of values), with the host ms a read of ``prepare_read`` and the
   device ms of a batch of 128 chunks; and ``run_reads`` at hac v4.3 with the
   caller (the finish pool's scheduler on), which must launch the hac path's
   kernels and K1 float32 and write MN, MM and ML on every record, ML
   entries on some.
   Then the command line, ``dorado_tpu_torch.cli.main`` in this process, on
   the committed POD5 fixture (16 reads, 502k samples) with model
   directories the port writes (hac v4.3 and sup v5.0 at full width, the
   weights above), splitting reads (the default): hac with the defaults
   (Viterbi, BAM), with ``--decoder beam --emit-fastq``, with
   ``--emit-sam``, with ``--emit-sam --disable-read-splitting``, and with
   ``--emit-sam --max-reads 8 --min-qscore q`` (q halfway through the qs of
   those eight reads' records, so that it drops some), hac with
   ``--emit-sam --modified-bases-models`` (the modbase directory), and sup
   with ``--emit-sam``. Each run starts with the counters at 0, must launch
   every kernel of its path, and must write what ``run_reads`` writes for
   the reads of the port's ``Pod5File`` with the same weights, options and
   header (the modbase case: ML within 1 at all but 0.1% of its values).
   The same for fast v4.0 SAM, hac SAM and sup SAM with ``--dtype float32``,
   and hac SAM with ``--dtype bfloat16``, which must write the default's SAM
   but for @PG. One ``python -m dorado_tpu_torch basecaller ... --emit-sam``
   subprocess must write the in-process SAM but for @PG. Then hac with
   ``--reference`` (a FASTA of four of the hac run's calls), ``--bed-file``
   and ``--emit-summary`` (path ``cli reference``): its mapped records carry
   NM, AS and bh and are otherwise the first run's, ``summary`` over its BAM
   gives the emitted rows, and ``aligner`` over the hac SAM writes a sorted
   BAM whose ``.bai`` ``fetch_region`` reads; samples/s with and without
   ``--reference``. Then the ``-b 0``
   sweep at hac with its cache off: each batch size's device step and the
   chosen one.
   Before the modbase phase, float32 compute on the card
   (``float32_paths``, ``compute_dtype=torch.float32``): ``run_reads`` at hac
   v4.3 (Viterbi and beam, W8A8: K2 and K1 at float32, the decode on bf16
   scores as on the bf16 paths) and at sup v5.0 (K2, K10, K12, K13: 18 a
   batch each), one device step of sup with the fused norms (K14 at float32),
   each path's launches held; the scores on the card against the CPU's
   float32 models on the same chunks (hac, and unquantised sup over all 18
   layers, within MAX_F32_SCORE_REL; W8A8 sup within MAX_F32_W8A8_SHALLOW
   over its first 2 layers and the bf16 limit over all 18), the Viterbi
   decode of the card's scores equal to the CPU's, and one profiled step
   each. Then fast v4.0 at full width (``fast_phase``: H = 96, 64 states,
   chunk 10000, batch 128, unquantised projections): K1 at H = 96 in bf16
   and float32, K3, the full-history scans and K17 at 64 states timed at its
   shapes (``fast_*`` keys of their rows), and ``run_reads`` in bf16 (Viterbi
   and beam) and in float32, held as above. Then the LSTM-sup class at full
   width (``lstm_sup_phase``: ``presets.lstm_sup_config``, 5 LSTM layers of
   768 on K1's wide form, 1024 states, chunk 9996, batch 128, W8A8) over 12
   reads that fill a batch: ``run_reads`` in bf16 (Viterbi and beam) and in
   float32, each path's launches held (K1's wide form and K2 5 times a batch),
   its scores against the CPU's float32 model on two chunks, its Viterbi
   decode against the CPU's, its beam against the CPU's plain beam on the
   same back guide, and one profiled step each; and, in ``float32_paths``,
   sup at float32 on the "hp" route (K11a at float32, 18 launches a batch),
   its scores equal to the default route's on the card. The CLI phase runs
   the LSTM-sup directory too (``cli lstm sup``).
   Then duplex calling (``duplex_phase``, after the modbase phase):
   ``DuplexPipeline.run_reads`` over the committed duplex fixture (21
   template-complement pairs on shared channels and muxes and 2 lone reads
   of 20-30k samples, in channel order; a full simplex batch and a partial
   one) with hac v4.3 and the stereo preset (``presets.stereo_config``, its
   head's bias drawn), W8A8, pairs forced by ``tests/torch_duplex.py``'s
   ``ForcedPairer`` (random calls pass no pairing gate): bf16 with the
   Viterbi and the beam decoder, float32, and with the 5mCG_5hmCG@v3 model.
   Each run must write every read, the duplex records first (``t;c``, dx 1),
   dx -1 on each parent and 0 on the rest, and launch K1 and K2 five times
   and the decode once a simplex or stereo batch; with the mod model each
   duplex MM holds '+' channels on C and '-' on G with an ML value a call.
   The real ``DuplexPairer``'s verdicts on the same candidates are printed;
   the stereo model's scores on two feature chunks are held against the
   CPU's float32 model (hac's limits), its decodes against the CPU's; one
   stereo step of each kind is profiled; a pair's host ms of alignment and
   stereo features is printed beside its stereo call's device ms. Then
   ``duplex_cli``: ``duplex`` in process with pairs forced (its SAM equal to
   ``DuplexPipeline.run``'s), ``python -m dorado_tpu_torch duplex`` (the real
   pairer; its SAM equal to the in-process run's but for @PG) and ``duplex
   basespace --pairs`` on the forced run's SAM.
   Then draft polishing (``polish_phase``): the port's mapper aligns 200
   seeded FASTQ reads of 8-12 kb (8% errors, both strands, 100x) to a 30 kb
   draft on every host core; ``PolishPipeline`` (windows of 10,000
   overlapping by 1,000, 100 reads a read-matrix column) runs the counts
   GRUModel (cuDNN ``nn.GRU``, gru 128) and the read-level LatentSpaceLSTM
   (its four LSTM directions a window on K1 float32) with seeded random
   weights on the card; the counts pipeline again on the CPU over the same
   windows (the host features computed once), the read-level one's forward
   on the CPU on the longest window: logits within TOL_POLISH_LOGITS, argmax
   equal but at near ties, the counts sequences equal but at near-tie
   columns; paths ``polish counts`` (no
   hand-written kernel) and ``polish rl`` (K1 float32, 4 a window); each
   window's host features (pileup, read matrix) beside its device forward
   (CUDA events, one profiled forward by kernel); K1 float32 at a window's
   shape (T = its columns, N = 1, H = 128), both directions into
   NaN-filled outputs, timed beside its bound, the plain version and
   cuDNN's float32 LSTM (``polish_*`` keys of its row); and ``python -m
   dorado_tpu_torch polish reads.fastq draft.fa -m <gru dir>``, whose FASTA
   must equal ``run()``'s.
   Then variant calling (``variant_phase``): 150 seeded reads of two
   haplotypes of that draft (homozygous and heterozygous SNPs and short
   indels), mapped by the port; ``VariantCaller`` with the slot preset and
   its LSTMs over the whole draft (path ``variant slot``: K1 float32 at H =
   256, 4 a window), the perceiver preset over one full default window (path
   ``variant perceiver``: the decoder LSTM on K1 float32, 1 a window; the
   attention on the memory-efficient backend, shown by the profiler), timed
   by CUDA events with its peak memory; both on the card and on the CPU over
   a reduced region each (outputs within TOL_VARIANT, records equal but at
   near ties); the phasing pass's host time; K1 float32 at the slot window's
   shape into NaN-filled outputs beside its bound, plain version and cuDNN
   (``variant_*`` keys of its row); and ``python -m dorado_tpu_torch variant
   reads.fastq draft.fa --model-config <slot.toml> -o <dir>``, whose VCF must
   equal ``VariantCaller.run``'s.
   Then read correction (``correct_phase``): 24 seeded reads of 8-12 kb at
   8% errors from both strands of a 24 kb genome, all-vs-all overlaps by
   the port's mapper, ``ReadCorrector(use_nn=True)`` with the command's
   model (dim 128, depth 4, windows of 4096; path ``correct nn``: cuBLAS,
   no hand-written kernel) on the card; the first index block again on the
   CPU (logits within TOL_CORRECT_LOGITS, corrected reads equal but at near
   ties); host seconds a window beside the device forward's ms; ``python -m
   dorado_tpu_torch correct --nn`` against the function, ``--to-paf`` then
   ``--from-paf``, and a HERRO-contract TorchScript module through
   ``--model-path`` on the card against the CPU.
   Then barcoding (``demux_phase``): ``run_reads`` at hac v4.3 over 96
   reads of 40-60k samples without and with SQK-NBD114-24 (a 12-barcode
   sample sheet), ``--trim all``'s trimmer and poly(A) estimation, in turns
   (path ``demux hac``: K1 and K2 5 a batch, K3-K5 one), each record with
   the options equal to the plain run's with the port's classifier, poly(A)
   calculator and trimmer applied on the host; samples/s and the idle share
   of each pass, each stage's thread-seconds beside ``host_finish_s``, the
   host ms a read of ``classify`` at 24 and 96 barcodes, of the adapter and
   primer search and of ``calculate_num_bases``; the basecaller command
   with those options on the fixture (path ``cli demux``); and ``python -m
   dorado_tpu_torch demux`` and ``trim`` over a BAM of 2,000 planted reads
   of 1-10 kb (``tests/torch_demux.py``), each equal to its functions, the
   classified share held against the planted barcodes, each command's
   reads/s.
   Then direct RNA and CRAM (``rna_cram_phase``): the RNA stand-in
   (``presets.rna004_hac_config``: hac v4.3's widths, RNA004 at 4 kHz) at
   full width, batch 128, W8A8, through ``run_reads`` with ``estimate_poly_a``
   over 128 seeded reads of 40-60k samples (``tests/torch_rna.py``: a DNA
   adapter step, an open-pore spike in a third, a flat poly(A) stretch in
   half), with the Viterbi and the beam decoder (paths ``rna viterbi`` and
   ``rna beam``: K1 and K2 5 a batch, K3-K5 or the scans, K17 and the beam
   traceback one), every read written, each Viterbi record its stitched
   call reversed with the host calculator's pt/pa; the scores and decode
   against the CPU's (hac's tolerance), one profiled step, and 6 reads
   through the CPU pipeline on the card model's scores, its records equal
   to the card's; the records as BAM and as CRAM with rANS and with gzip
   (MB/s and records/s of each writer; each CRAM read back equal to the
   BAM); a reference-based CRAM of the ``aligner`` command read back through
   its contig, which ``read_records`` refuses; hac's samples/s writing
   ``.cram`` against ``.bam`` with the idle share of each pass; and the
   commands: ``basecaller <rna dir> rna.pod5 --estimate-poly-a -o x.cram``
   (path ``cli rna cram``, equal to ``run_reads``), ``summary``, ``trim
   --rna`` and ``aligner`` on it equal to the same on its BAM, and
   ``--resume-from`` a cut CRAM.
   Last, several devices (``multi_gpu_phase``, after every other phase), at
   hac v4.3 full width: ``torch.cuda.device_count()`` and
   ``describe_devices()``; ``run_reads`` over 192 reads of 40-60k samples with
   one replica and with a replica on every visible card (two on card 0 when
   there is one card), Viterbi and beam, the records held against the one
   replica's and each replica's launches counted for each of its batches
   (paths ``replicas viterbi``, ``replicas beam``), ``DeviceMonitor`` on card
   0 sampled during the run (bytes in use, the card's total as its limit);
   the sharded step (``parallel.make_sharded_basecall_step``, unquantised
   bf16, N = 128, chunk 9996) on a 2 x 1 and a 1 x 2 mesh over those
   devices, its states and moves held against the 1 x 1 step's over the
   same rows and its scores within a bf16 step over all rows, launching
   K1, K6, K7a and K5 (paths ``sharded 2x1``, ``sharded 1x2``: K7a's only
   paths); two processes on card 0 (``parallel.distributed``, gloo over
   127.0.0.1, each with its own time limit) basecalling their shares of the
   four committed POD5 shards (``tests/data/torch_port/shards``), summing
   their stats, passing barriers and merging their BAMs, the merged records
   held against one process's, host 0's first; ``basecaller -x cuda
   --dump-stats-file`` with ``basecaller.`` and ``device.`` columns; and the
   rates, each over 3 passes of ``run_reads`` (every pass's rate printed):
   of one replica and of the replicas over the 192 reads, of each of the two
   processes over 96 reads of its own (timed together, their windows'
   overlap printed), and of one process over both processes' 192, each on a
   line of its own beside the card's name and power limit.
5. Checks the outputs: the model on the card against the float32 model on
   the CPU, the W8A8 model against the bf16 model, the device decode against
   the CPU's plain decode of the same scores (the beam also with the card's
   back guide on both sides), and the beam decoder against the Viterbi decoder on
   scores with a planted path. For sup: the W8A8 model on the card against
   the float32 W8A8 model on the CPU, W8A8 against bf16 on the card, the
   other routes against the default route on the same weights ("hp" at
   W8A8 and "ext" unquantised bit for bit over all layers; with the fused
   norms over the first two layers, where two planted faults must fail), the
   int8 model against the CPU's and against bf16, the device decode against
   the CPU's plain decode (sequences and moves exact, low qual chars within
   a step), the beam decode against the CPU's plain beam decode (on the
   card's back guide and on each side's own), and the Viterbi decoder on a
   planted path at 1024 states, which the beam decoder must follow.
6. Profiles one more full batch of each decoder's device step, and of each
   sup route's device step (the default, "hp" with the fused norms, the beam
   decoder, "ext" with the fused norms unquantised, int8), and prints its
   device time by
   kernel and by operator and the device's busy share. The "ext" and int8
   steps are those routes' main paths: their launches are counted as the
   pipelines' are (K10 18 times and K14 36 times a batch; K9 18 times).
7. Runs the read splitter on the card's host (``splitter_phase``) over 8
   planted concatemers of 2-4 strands of 5-15 kb in simplex and in duplex
   mode, which must cut at each planted base, and prints its host ms a read
   beside the profiled hac Viterbi step's device ms for as many samples.
8. Prints one JSON line of per-kernel numbers (the float32 forms of K2, K13,
   K10, K14 and K11a and K1's two wide forms in rows of their own; K1
   float32's row also at the polish and variant shapes) and, last, the
   device line.

No phase catches its own failure: any fault exits non-zero. Without CUDA, or
outside a checkout of the repository, it exits non-zero before printing a
result.
"""

from __future__ import annotations

import copy
import difflib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1234
T, N, H, S = 1666, 128, 384, 256  # hac v4.3 at chunk 9996, batch 128
# sup v5.0 at chunk 12288, batch 128: tokens, decode steps, states, widths
SUP_TOK, SUP_T, SUP_S, SUP_D, SUP_HEADS, SUP_FFN = 1024, 2048, 1024, 512, 8, 2048
SUP_M = N * SUP_TOK  # rows of each encoder matmul
SUP_WINDOW = (127, 128)
SUP_LONG_READS, SUP_SHORT_READS = 12, 3
W = 32  # beam width
BEAM_CUT = 100.0
STAY = 2.0
N_READS = 16
# the splitter phase: planted concatemers of 2-4 strands of 5-15 kb
SPLIT_READS = 8
SPLIT_STRAND_BASES = (5_000, 15_001)
# random weights either stay on every step or move on most of them; this
# gain on the CRF head's weights makes the path emit bases
HEAD_GAIN = 64.0
# published H100 SXM peaks (dense): int8 and bf16 tensor cores, non-tensor
# f32, HBM3
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# dense TF32 on the tensor cores: K1 float32 issues three such products
# (3xTF32) for each float32 one, so its float32 rate is at most a third
PEAK_TF32 = 495e12
PEAK_F64 = 34e12  # float64 outside the tensor cores
HBM_BYTES_S = 3.35e12
# kernel vs plain version on the card (max abs error):
# K1: the f32 sums of h @ W_hh run in another order, so h can round to the
#     neighbouring bf16 value (2^-8 at |h| < 1) and feed that to later steps
TOL_LSTM = 0.05
# K1 is also held at the other shapes the pipeline gives it and at the
# wrapper's other split choices (rows a cluster follow N over the clusters the
# card runs at once, 15 of 8 on an H100: 16, 24 and 40 rows here, and 8 on a
# ragged batch of 100): (T, N, reverse) of the short-chunk lane (chunk 7494 ->
# T = 1249, 256 rows, forward, as every second layer runs), of a 512-row
# batch and of a ragged one (short T keeps the plain version's step loop
# quick); and at other widths (H, N) at T = 64 in both directions: fast's
# 96 (one CTA, two m-tiles a warp), 512 (a cluster of 16) and 36 (units and
# depth padded)
LSTM_SHAPES = [(T, N, True), (1249, 2 * N, False), (64, 4 * N, True), (64, 100, False)]
LSTM_WIDTHS = [(96, N), (512, N), (36, 37)]
# K1 is timed at these batches, each beside cuDNN's LSTM at the same batch
LSTM_TIMED_N = [N, 4 * N]
# K15 (int8 W_hh): the int32 sums are exact and the float steps after them
#     are the plain version's operation for operation, but CUDA's expf and
#     tanhf and PyTorch's may differ in the last bit; h * 127 near a rounding
#     tie can then quantise the other way and later steps carry the change:
#     outputs more than one bf16 step (of the larger of the two values) apart
#     at under 0.1% of positions
MAX_INT8_LSTM_SHARE_OFF = 1e-3
# K15 is held in both directions at (T, N, H) of hac's chunk and batch, of
# batches that are no multiple of the mma's 8 rows nor of any rows a cluster
# (37, 100), of T = 1 and 3 (the exchange's first phases alone), and of the
# fast model's width and the widest the wrapper takes (a cluster of one CTA,
# of 8 with two m-tiles a warp); and timed at LSTM_TIMED_N
K15_SHAPES = [(T, N, H), (64, 37, H), (64, 100, H), (1, 5, H), (3, 37, H), (64, N, 96),
              (64, N, 512)]
# K15 runs on K1's clusters; it is also timed on the smallest cluster that
# holds its int8 slices at hac's H (4 CTAs of 96 units, two m-tiles a warp;
# the card runs 30 such clusters at once) at the rows that gives: 8 at N =
# 128, 24 at 512
K15_SMALL_CLUSTER, K15_SMALL_ROWS = (4, 96, 12), {N: 8, 4 * N: 24}
# K1 float32 (the modbase models' LSTMs): float32 sums of 3xTF32 products
#     (about 2^-21 of each product) in another order, and CUDA's expf and
#     tanhf a last bit off PyTorch's, carried over the steps: within 1e-4,
#     half the JAX package's own tolerance for its float32 kernel against
#     lax.scan (2e-4; measured 7e-7 at T = 1666)
TOL_LSTM_F32 = 1e-4
# its shapes (T, N, H): the modbase models' (a chunk of 192 samples at stride
# 6 -> T = 32, H = 256) at their batch of 128 chunks and at 1024, and hac's H
# and chunk at N = 128 (clusters of 16); each in both directions. Then ragged
# shapes launched into outputs filled with NaN first (every position must be
# written): T, N no multiple of anything the kernel works in, at H = 256 and at
# a padded width in one CTA
K1F_SHAPES = [(32, N, 256), (32, 8 * N, 256), (T, N, H)]
K1F_RAGGED = [(5, 37, 256), (7, 3, 36)]
# the modbase phase: synthetic reads of 2-8 kb through ModBaseCaller at full
# width on the card and on the CPU; their uint8 probabilities are floor(p *
# 256), so float32 sums in another order can move one a step: ML equal at
# 99.9% of positions, never more than 1 apart; MM equal
MODBASE_READS = 24
MODBASE_BASES = (2_000, 8_001)
MIN_MODBASE_ML_EQUAL = 0.999
# K16 (input projection inside): held as K1 (TOL_LSTM), at K1's widths and
# batches in both directions
# K2: bit for bit (the int32 sums are exact and every float step is a single
#     rounded operation in the kernel and in the plain version), at the long
#     lane's rows, the short lane's, and a count that is no multiple of the
#     kernel's 128-row tile; and (rows, K, O) at the widest weight the kernel
#     takes (the LSTM width of sup, one A buffer) and the narrowest
W8A8_ROWS = [T * N, 1249 * 2 * N, 5 * 128 + 37]
W8A8_OTHER = [(357, 768, 3072), (357, 128, 128)]
# K3: the carry's f32 LSE sums run in another order; rows are bf16, whose
#     spacing is 2^-7 relative: |err| <= 0.05 + 2^-7 * |value|
TOL_BETA_ABS, TOL_BETA_REL = 0.05, 2.0**-7
# K4: posts in [0, 1] stored as bf16, from LSE sums in another order: one
#     bf16 step apart at most, which is <= 2^-7 of the value, plus slack
#     for the f32 sums near the smallest values:
#     |err| <= 1e-5 + 2^-7 * |value|, elementwise; choices and the final
#     carry must be identical
# K4 is also held, with K7 on the same score values, at (T, N, S) whose T and
# N are no multiples of anything the kernel works in (its register ring of
# eight rows, four at 1024 states; its warps), at T below the ring's depth,
# and at the fast model's 64 states and full chunk (timed there)
K4_SHAPES = [(301, 37, 64), (3, 5, 64), (77, 5, 256), (33, 3, 1024), (T, N, 64)]
TOL_POSTS_ABS, TOL_POSTS_REL = 1e-5, 2.0**-7
# K6: float32 history; the four-term sums and exp/log run in another order
#     and through other library functions over up to 2048 chained steps:
#     |err| <= 1e-3 + 1e-5 * |value| (values reach about 1e4). The same at
#     1024 states (K3's full-history outputs)
TOL_LSE_ABS, TOL_LSE_REL = 1e-3, 1e-5
# their float64 operations a state and step (a DFMA two, a DADD or DMUL
# one), from the source of crf_lse_scan.cu: five exps (10 DFMA, 1 DADD, 1
# DMUL each: four of the scores, one of the carry), one log (12 DFMA, 1 DMUL,
# 1 DADD), the sum's four FMAs, the stay's multiply and four adds
LSE_F64_FLOPS = 5 * (10 * 2 + 1 + 1) + (12 * 2 + 1 + 1) + 4 * 2 + 1 + 4
# K7 (K7a, K7b): choices and final carry identical to the plain version's
#     (single f32 adds in the same order, maxima exact) and to K4's on the
#     same score values. Its operations per state and step: four adds, three
#     compares, the stay's add and compare, the row max
VITERBI_OPS = 10.0
# K8: choices and final carry identical to the plain version's and to K7's;
#     posts (float32) held as K4's (TOL_POSTS_*): alpha's sums run in another
#     order over up to 2048 steps, and a post is an exp of their difference
# K17: held on outcomes, at the full T the pipeline gives it. CUDA's
#     log1pf/expf and PyTorch's differ in the last bit, so a merged score can
#     differ in its last bit and a near-tie in the merge, the cutoff or the
#     selection can go the other way, after which that row's beams differ.
#     On the same scores and the same back guide every run so far gave identical
#     states and moves on every row; the limits leave room for one such tie:
#     at most one row of the batch may differ, at no more than 2% of its
#     steps (a tie moves a stretch of one path, not the rest of the row).
BEAM_MAX_ROWS_DIFFERENT = 1
BEAM_MAX_ROW_SHARE_DIFFERENT = 0.02
# K17 is also held at T below its ring's depth (16 steps, 8 at 1024 states)
# and at T and N that are no multiple of anything it works in; the beam
# traceback, on each of these histories, also at T = 1 and one step below
# and above its ring of 4 chunks of 32 steps
BEAM_SHAPES = [(3, 5, 64), (77, 37, 256), (33, 3, 1024), (1, 1, 64), (127, 3, 256),
               (129, 37, 1024)]
# K5 (exact, on K7's choices from random scores) at T = 1, T one below and one
# above its ring's depth (4 chunks of 32 steps, 3 at 1024 states), T that is no
# multiple of its 32-step chunk, N of 1, 3 and 37, at 64, 256 and 1024 states,
# and at the fast model's full chunk (timed there)
TRACEBACK_SHAPES = [(1, 1, 64), (127, 37, 64), (129, 3, 256), (1, 37, 256), (33, 1, 256),
                    (95, 3, 1024), (97, 37, 1024), (T, N, 64)]
# written into both tracebacks' outputs before a launch: no state is negative
# and every move is 0 or 1
SENTINEL_STATE, SENTINEL_MOVE = -7, 0xAB
# written into K7's choices before a launch (every choice is 0 to 4), and NaN
# into its final carry; K7 is held so at K4_SHAPES and at one step of one row
# at each state count
SENTINEL_CHOICE = -7
K7_EDGE_SHAPES = [(1, 1, 64), (1, 1, 256), (1, 1, 1024)]
# the beam decode on the card against the plain beam on the CPU, over four
# chunks. With the card's back guide copied over, the limits are K17's above
# (every run: no step differs). With the CPU's own back guide, any difference
# between the guides moves near-ties, which the beam search amplifies (the
# JAX beam does the same when it is handed the other back guide:
# tests/test_torch_runner.py). K6 and its plain version compute each step's
# log-sum-exp in float64 and round it to float32, so the two guides are
# equal (every run so far) and so are the decodes. (In float32 they stood a
# step apart at values of thousands; this sample gave 96.86% of positions
# equal, and a float32-arithmetic guide moves the plain beam by 4-31% of
# positions on the ten further samples below: measured on an H100 80GB
# HBM3.) The limit stays where it was set then: 96.86% less two points
MIN_BEAM_CPU_POSITIONS_EQUAL = 0.95
# the decoders against each other (lowest sequence similarity of a row, on
# scores with a planted path) and the precisions against each other
MIN_BEAM_VITERBI_IDENTITY = 0.8
# the Viterbi decoder at 1024 states against the path planted in its scores,
# and the beam decoder against the Viterbi decoder there (at 256 states the
# two gave 0.999-1.000 on a planted path in every run)
MIN_PLANTED_IDENTITY = 0.95
MIN_SUP_BEAM_VITERBI_IDENTITY = 0.999
MAX_W8A8_REL_ERR, MIN_W8A8_ARGMAX_AGREE = 0.02, 0.98
# K9: the output is bf16 and the sums of the logits, of p and of p @ v run
#     in another order than the plain version's: one bf16 step apart at most,
#     |err| <= 1e-5 + 2^-7 * |value|, elementwise
TOL_ATTN_ABS, TOL_ATTN_REL = 1e-5, 2.0**-7
# K9 is also held at a T' that is no multiple of its 64-query blocks nor of
# the TPU kernel's 256-query strips (N, T')
ATTN_SHAPES = [(N, SUP_TOK), (8, 700)]
# K10, K11a, K11b: the same arithmetic and tolerance as K9, on their layouts;
# K11b also at a window above the others' 128 keys a side (its limit is 256)
WIDE_WINDOW = (200, 256)
# K14: the product's float32 sums run in another order than the plain
#     version's, so now and then a sum near a bf16 rounding boundary rounds
#     the other way. That moves h = bf16(bf16(acc) + bf16(res * alpha)) by a
#     step of the product, which can flip h's own rounding by a step of h
#     (one step of the output, since out ~ h * rstd * weight); the rounded
#     h * rstd and the output may then each round the other way too. So an
#     output stays within two bf16 steps of its value plus two steps at 1 (a
#     step of the product, scaled by the row's rstd and weight, is under one
#     at 1 here): |err| <= 2^-6 * (|value| + 1), elementwise, and at most
#     0.1% of the outputs differ at all (measured on an H100 80GB HBM3 at
#     sup's shapes: 0.0103 of that scale at most, 0.026% differing)
TOL_NORM_REL, MAX_NORM_SHARE_DIFFERENT = 2.0**-6, 1e-3
# K14 is held at sup's rows, at a count that is no multiple of its 128-row
# tiles, and at one that is a multiple of them but not of a cluster's two
# (the cluster's second CTA then has no rows in its last tile)
K14_ROWS = [5 * 64 + 37, 3 * 128, SUP_M]
# the sup model's fused norms on the card against the unfused route on the
# same weights (biases and norm weights drawn from the seed), over the first
# SUP_SHALLOW_DEPTH layers (mean abs difference over the mean abs score): K14
# rounds where the unfused operators do, but sums the product in another
# order (measured on an H100 80GB HBM3: 1.2e-3 and 1.3e-3; the two planted
# faults of the check 1.2e-2 and 7.8e-3)
MAX_SUP_ROUTE_MEAN_ERR = 2.0**-8
# K12: expf and PyTorch's exp may differ in the last bit, which can move a
#     value across an int8 rounding boundary: row scales within 1e-6
#     relative, the int8 output equal but for +-1 at under 0.1% of elements
# K13 is also held at (rows, K, O) of the other cluster sizes (O = 128 and
# 384, whose 128-channel tiles no cluster of 2 or 4 divides, and 768, in
# clusters of 2) and at K = 128, one stage a tile
K13_OTHER = [(360, 128, 128), (1000, 2048, 384), (680, 256, 768)]
# K13: bit for bit, like K2. Both at sup's rows, at counts that are no
#     multiple of the 128-row tile and at one row; K12 also at (rows, K, F)
#     of its narrowest shape and of one that takes its two-pass form (F / 64
#     = 11 has no divisor up to 8 that leaves at most 4 tiles a CTA), and in
#     the two-pass form at sup's shape (timed beside the one-pass form)
TOL_SWIGLU_SCALE_REL, MAX_SWIGLU_SHARE_OFF_BY_ONE = 1e-6, 1e-3
FFN_ROWS = [SUP_M, 5 * 128 + 37, 357, 1]
SWIGLU_OTHER = [(357, 128, 64), (1000, 256, 704)]
# the sup model: bf16 on the card against float32 on the CPU, both W8A8
# (mean abs error over the mean abs score; the head has no tanh or clamp, so
# the scores are of size 4 on average and the bf16 residual stream's
# rounding passes through 18 layers: measured 0.031), and W8A8 against bf16
# on the card. Over the first 2 layers the relative norm error is under K2's
# limit above and the argmax over the 4096 unclamped transitions agrees at
# 0.95 or more, the limit of the JAX package's own test of its quantised
# transformer at that depth (measured 0.012 and 0.972); over all 18 layers of
# random weights each layer's int8 noise of about 0.8% adds in quadrature
# (measured 0.035 and 0.923)
MAX_SUP_BF16_MEAN_ERR = 0.06
MAX_SUP_W8A8_REL_ERR, MIN_SUP_W8A8_ARGMAX_AGREE = 0.06, 0.88
SUP_SHALLOW_DEPTH, MIN_SUP_SHALLOW_ARGMAX_AGREE = 2, 0.95
# the sup decode's qual chars on the card against the CPU's are held (one
# step apart at most) where the CPU's phred is under this
SUP_QUAL_HELD_BELOW = 20


def smoke_run_info():
    from dorado_tpu_torch.io.pod5 import RunInfo

    return RunInfo(
        acquisition_id="smoke", sample_rate=5000, flow_cell_id="FAB00000",
        flow_cell_product_code="FLO-PRO114M", protocol_run_id="smoke-run",
        acquisition_start_time_ms=1_700_000_000_000, sample_id="smoke",
    )


def smoke_read(i, n, gen, run_info):
    """Read ``i``: ``n`` samples of raw ADC drawn from ``gen`` around the
    models' standardisation mean (92-94 pA at 0.2 pA/ADC)."""
    import numpy as np

    from dorado_tpu_torch.io.pod5 import Pod5Read

    signal = np.clip(gen.normal(460, 113, n), -32768, 32767).astype(np.int16)
    return Pod5Read(
        read_id=f"read-{i}", signal=signal, read_number=i, start_sample=0,
        median_before=200.0, channel=i + 1, well=1, pore_type="not_set",
        calibration_offset=0.0, calibration_scale=0.2, end_reason="signal_positive",
        end_reason_forced=False, open_pore_level=float("nan"),
        num_reads_since_mux_change=0, time_since_mux_change=0.0,
        num_minknow_events=0, tracked_scaling_scale=float("nan"),
        tracked_scaling_shift=float("nan"), predicted_scaling_scale=float("nan"),
        predicted_scaling_shift=float("nan"), run_info=run_info,
        filename="smoke.pod5",
    )


def bound_ms(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    """Least time for the work: the larger of operations over the peak rate
    for their type and bytes (inputs read once, outputs written once) over
    the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def cli_phase(cfg, model, sup_cfg, sup_model, wrappers, check_launches, path_kernels, launches,
              card, mod_dir, fast, lstm_sup) -> None:
    """``python -m dorado_tpu_torch basecaller`` on the card: model
    directories written by the port (hac v4.3 and sup v5.0 at full width,
    this run's seeded weights), the committed POD5 fixture, read splitting on
    (the default) but in one case. Each in-process run starts with every
    launch counter at 0 and must launch every kernel of its path
    (``check_launches``); its output must equal, record for record,
    ``BasecallerPipeline.run_reads`` on the reads the port's ``Pod5File``
    returns, with the same weights, options and header, and hold a record of
    every read (the read filters' case: of every read it admits, less those
    under ``--min-qscore``). The modbase case (``--modified-bases-models
    mod_dir``) is held on ML within 1 at all but 0.1% of its values, and
    every other field equal: its caller's batches hold other chunks together
    in the two runs. fast v4.0 and the LSTM-sup class (``fast``, ``lstm_sup``:
    each its config and model) and hac and sup with ``--dtype float32`` run
    as the rest; hac with ``--dtype
    bfloat16`` must write the default's SAM but for @PG. One more run in a
    subprocess must write the in-process run's SAM but for @PG."""
    import contextlib
    import gzip
    import shlex

    import numpy as np
    import torch

    from dorado_tpu_torch.cli.main import main as cli_main
    from dorado_tpu_torch.io import vbz
    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.io.pod5 import Pod5File
    from dorado_tpu_torch.io.sam import BamWriter, FastqWriter, SamWriter
    from dorado_tpu_torch.modbase.caller import ModBaseCaller
    from dorado_tpu_torch.modbase.config import load_modbase_config
    from dorado_tpu_torch.models.load import build_model, load_model, save_model
    from dorado_tpu_torch.pipeline import BasecallerPipeline

    fixture = ROOT / "tests" / "data" / "torch_port" / "fixture.pod5"
    print(f"libzstd: {vbz.libzstd_version()}", flush=True)
    t0 = time.perf_counter()
    fixture_reads = list(Pod5File(fixture).reads(strict=True))
    decode_s = time.perf_counter() - t0
    samples = sum(len(r.signal) for r in fixture_reads)
    read_ids = [r.read_id for r in fixture_reads]
    print(f"POD5 decode of {fixture.name}: {len(fixture_reads)} reads, {samples} samples, "
          f"{fixture.stat().st_size} bytes in {decode_s:.4f} s (host) [{card}]", flush=True)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        hac_dir = save_model(cfg, model, tmp / cfg.model_name)
        sup_dir = save_model(sup_cfg, sup_model, tmp / sup_cfg.model_name)
        fast_dir = save_model(fast[0], fast[1], tmp / fast[0].model_name)
        lstm_sup_dir = save_model(lstm_sup[0], lstm_sup[1], tmp / lstm_sup[0].model_name)
        print(f"model directories written in {time.perf_counter() - t0:.1f} s", flush=True)
        loaded = {}
        for kind, path in (("hac", hac_dir), ("sup", sup_dir), ("fast", fast_dir),
                           ("lstm sup", lstm_sup_dir)):
            config, params = load_model(path)
            loaded[kind] = (config, build_model(config, params))

        def run_case(path, model_dir, kind, extra, fmt, launch_path, pipe_kw, admitted):
            """One in-process run, held against run_reads with ``pipe_kw``;
            ``admitted`` are the reads the options let in."""
            out = tmp / f"{path.replace(' ', '_')}.{fmt}"
            argv = ["basecaller", str(model_dir), str(fixture), *extra, "-o", str(out)]
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"{path}: exit code {rc}")
            launches[path] = {name: w.launches for name, w in wrappers.items()}
            path_kernels[path] = path_kernels[launch_path]
            check_launches(path, launches[path], 1)
            # the same reads through run_reads with the same weights, options and header
            config, ref_model = loaded[kind]
            pipe = BasecallerPipeline(config, ref_model, decoder="beam" if "beam" in path
                                      else "viterbi", **pipe_kw)
            header = pipe.build_header([fixture], cli_line=shlex.join(["dorado_tpu_torch", *argv]))
            buf = io.StringIO() if fmt != "bam" else io.BytesIO()
            writer = {"sam": SamWriter, "fastq": FastqWriter, "bam": BamWriter}[fmt](buf, header)
            reads = list(Pod5File(fixture).reads(strict=True))
            for r in reads:
                r.filename = fixture.name
            stats = pipe.run_reads(reads, writer)
            writer.close()
            got = out.read_bytes()
            want = buf.getvalue()
            if fmt == "bam":
                got, want = gzip.decompress(got), gzip.decompress(want)
            else:
                want = want.encode()
            ml_counts = [0, 0]
            if got != want and "modbase" in path:
                # the modbase batches of the two runs hold other chunks
                # together (the scheduler's timing), and a float32 product
                # over another row count can move a probability a step: ML
                # within 1, at most 0.1% of values off; all else equal
                g, w = got.decode().splitlines(), want.decode().splitlines()
                for a, b in zip(g, w):
                    fa, fb = a.split("\t"), b.split("\t")
                    ml = [(x, y) for x, y in zip(fa, fb) if x.startswith("ML:B:C")]
                    if (len(g) != len(w) or len(fa) != len(fb)
                            or [x for x in fa if not x.startswith("ML:B:C")]
                            != [y for y in fb if not y.startswith("ML:B:C")]
                            or not all(ml_close(np.array(x.split(",")[1:], dtype=np.int32),
                                                np.array(y.split(",")[1:], dtype=np.int32),
                                                ml_counts) for x, y in ml)):
                        raise AssertionError(f"{path}: a record differs from run_reads' (not "
                                             f"only in ML, or ML by more than 1)")
                if ml_counts[0] > (1 - MIN_MODBASE_ML_EQUAL) * ml_counts[1]:
                    raise AssertionError(f"{path}: {ml_counts[0]} of {ml_counts[1]} ML values "
                                         f"differ from run_reads'")
            elif got != want:
                g, w = got.splitlines(), want.splitlines()
                bad = sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))
                raise AssertionError(f"{path}: output differs from run_reads' at {bad} lines")
            # every admitted read has a record (or its subreads have), but for
            # those the qscore filter dropped
            if fmt == "fastq":
                names = [line[1:].split("\t")[0] for line in out.read_text().splitlines()[::4]]
                parents = {n.split(":")[0] for n in names}
            else:
                records = read_records(out)[1]
                names = [r.qname for r in records]
                parents = {next((t.value for t in r.tags if t.tag == "pi"), r.qname)
                           for r in records}
            n_records = stats.reads_called
            if (len(names) != n_records or stats.bases_called == 0
                    or not parents <= set(admitted)
                    or len(names) + pipe.reads_filtered < len(admitted)
                    or (not pipe.reads_filtered and parents != set(admitted))):
                raise AssertionError(f"{path}: {len(names)} records of {len(parents)} of the "
                                     f"{len(admitted)} reads admitted, {pipe.reads_filtered} "
                                     f"filtered, {stats.bases_called} bases")
            runs[path] = (out, wall)
            if "--min-qscore" in extra and not pipe.reads_filtered:
                raise AssertionError(f"{path}: --min-qscore filtered no read")
            split = sum(":" in n for n in names)
            print(f"{path}: {' '.join(argv[3:-2])} -> {fmt}; {n_records} records ({split} of "
                  f"them subreads) of {len(admitted)} reads admitted, {pipe.reads_filtered} "
                  f"filtered by qscore, {samples} samples in the file, in {wall:.3f} s wall "
                  f"(incl. the runner's set-up: quantisation, first batch shapes) = "
                  f"{samples / wall:.0f} samples/s [{card}]; output equal to run_reads' "
                  f"({len(got)} bytes{' decompressed' if fmt == 'bam' else ''}"
                  f"{f'; ML: {ml_counts[0]} of {ml_counts[1]} values a step apart' if ml_counts[1] else ''}"
                  f"); host finish "
                  f"{stats.host_finish_s:.3f} thread-s; launches "
                  f"{ {k: v for k, v in launches[path].items() if v} }", flush=True)

        cases = [
            # (path, model directory, kind, extra arguments, format, launch path,
            #  run_reads' options)
            ("cli hac", hac_dir, "hac", [], "bam", "viterbi", {}),
            ("cli beam", hac_dir, "hac", ["--decoder", "beam", "--emit-fastq"], "fastq", "beam",
             {}),
            ("cli hac sam", hac_dir, "hac", ["--emit-sam"], "sam", "viterbi", {}),
            ("cli hac no split", hac_dir, "hac", ["--emit-sam", "--disable-read-splitting"],
             "sam", "viterbi", {"split_reads": False}),
            ("cli sup", sup_dir, "sup", ["--emit-sam"], "sam", "sup viterbi", {}),
            ("cli fast", fast_dir, "fast", ["--emit-sam"], "sam", "fast viterbi", {}),
            ("cli lstm sup", lstm_sup_dir, "lstm sup", ["--emit-sam"], "sam", "lstm sup viterbi",
             {}),
            ("cli hac f32", hac_dir, "hac", ["--emit-sam", "--dtype", "float32"], "sam",
             "hac f32 viterbi", {"compute_dtype": torch.float32}),
            ("cli sup f32", sup_dir, "sup", ["--emit-sam", "--dtype", "float32"], "sam",
             "sup f32", {"compute_dtype": torch.float32}),
            ("cli hac bf16", hac_dir, "hac", ["--emit-sam", "--dtype", "bfloat16"], "sam",
             "viterbi", {"compute_dtype": torch.bfloat16}),
            ("cli hac modbase", hac_dir, "hac", ["--emit-sam", "--modified-bases-models",
                                                 str(mod_dir)], "sam", "modbase",
             {"modbase_caller": ModBaseCaller([load_modbase_config(mod_dir)],
                                              canonical_stride=cfg.stride)}),
        ]
        for case in cases:
            run_case(*case, admitted=read_ids)

        def body(text):
            return [line for line in text.splitlines() if not line.startswith("@PG")]

        # --dtype bfloat16 is the card's default
        if body(runs["cli hac bf16"][0].read_text()) != body(runs["cli hac sam"][0].read_text()):
            raise AssertionError("cli hac bf16: --dtype bfloat16 differs from the default")
        print("cli hac bf16: --dtype bfloat16 wrote the default's SAM but for @PG", flush=True)
        # --max-reads 8 and a --min-qscore halfway through the qs of those
        # eight reads' records in the hac SAM, so that it drops some
        records = read_records(runs["cli hac sam"][0])[1]
        qs = sorted({next(t.value for t in r.tags if t.tag == "qs") for r in records
                     if next((t.value for t in r.tags if t.tag == "pi"), r.qname)
                     in read_ids[:8]})
        if len(qs) < 2:
            raise AssertionError(f"cli hac sam: the first 8 reads' records have one qs, {qs}")
        min_qscore = (qs[len(qs) // 2 - 1] + qs[len(qs) // 2]) / 2
        run_case("cli hac filters", hac_dir, "hac",
                 ["--emit-sam", "--max-reads", "8", "--min-qscore", repr(min_qscore)], "sam",
                 "viterbi", {"max_reads": 8, "min_qscore": min_qscore}, admitted=read_ids[:8])
        # one real subprocess: python -m dorado_tpu_torch, SAM on stdout
        argv = ["basecaller", str(hac_dir), str(fixture), "--emit-sam"]
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "dorado_tpu_torch", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"python -m dorado_tpu_torch: exit {res.returncode}\n{res.stderr}")

        in_process = runs["cli hac sam"][0].read_text()
        if body(res.stdout) != body(in_process) or not body(in_process):
            raise AssertionError("python -m dorado_tpu_torch: SAM differs from the in-process run's")
        print(f"python -m dorado_tpu_torch {' '.join(argv[3:])}: {wall:.3f} s wall (a fresh "
              f"process: imports, CUDA context, runner set-up); SAM equal to the in-process run's "
              f"but for @PG; its summary: "
              f"{[l for l in res.stderr.splitlines() if l.startswith('> ')][:2]}", flush=True)

        # ---- inline alignment, the summary and the aligner ----------------------
        # the reference: four of the hac run's calls (the second reverse
        # complemented, the fourth trimmed); random weights call nothing that
        # maps elsewhere
        from dorado_tpu_torch.io.bam_reader import fetch_region
        from dorado_tpu_torch.utils.sequence import reverse_complement

        first = read_records(runs["cli hac"][0])[1]
        calls = sorted((r.seq for r in first if r.seq != "*"), key=len, reverse=True)[:4]
        contigs = [("c0", calls[0]), ("c1", reverse_complement(calls[1])), ("c2", calls[2]),
                   ("c3", calls[3][len(calls[3]) // 10:])]
        ref = tmp / "ref.fa"
        ref.write_text("".join(f">{n}\n{s}\n" for n, s in contigs))
        bed = tmp / "ref.bed"
        bed.write_text("".join(f"{n}\t0\t{len(s) // 2}\t{n}a\t0\t+\n{n}\t{len(s) // 3}\t{len(s)}"
                               f"\t{n}b\t0\t.\n" for n, s in contigs))
        ref_dir = tmp / "reference"
        ref_dir.mkdir()
        out = ref_dir / "calls.bam"
        argv = ["basecaller", str(hac_dir), str(fixture), "--reference", str(ref), "--bed-file",
                str(bed), "--emit-summary", "-o", str(out)]
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli_main(argv) != 0:
            raise AssertionError("cli reference: a non-zero exit code")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["cli reference"] = {name: w.launches for name, w in wrappers.items()}
        path_kernels["cli reference"] = path_kernels["viterbi"]
        check_launches("cli reference", launches["cli reference"], 1)
        header, got = read_records(out)
        if [l for l in header.splitlines() if l.startswith("@SQ")] != [
                f"@SQ\tSN:{n}\tLN:{len(s)}" for n, s in contigs]:
            raise AssertionError("cli reference: the header's @SQ lines are not the reference's")
        if [r.qname for r in got] != [r.qname for r in first]:
            raise AssertionError("cli reference: other records than the run without a reference")
        align_tags = ("NM", "AS", "bh")
        mapped = 0
        for a, b in zip(first, got):
            seq, qual = b.seq, b.qual
            if not b.flag & 4:
                mapped += 1
                if not set(align_tags) <= {t.tag for t in b.tags} or b.rname == "*":
                    raise AssertionError(f"cli reference: {b.qname} is mapped without NM, AS, bh")
                if b.flag & 16:
                    seq, qual = reverse_complement(seq), qual[::-1]
            elif b.flag != a.flag | 4:
                raise AssertionError(f"cli reference: {b.qname} flag {b.flag}")
            tags = [(t.tag, t.type, str(t.value)) for t in b.tags if t.tag not in align_tags]
            if (seq, qual) != (a.seq, a.qual) or tags != [(t.tag, t.type, str(t.value))
                                                          for t in a.tags]:
                raise AssertionError(f"cli reference: {b.qname} differs from the run without "
                                     f"a reference beyond its alignment")
        # random weights call periodic repeats, which the mapper places for
        # some of the reads only (two of 16 of these weights' calls on the CPU)
        if not mapped:
            raise AssertionError("cli reference: no record mapped")
        emitted = (ref_dir / "sequencing_summary.txt").read_text()
        summary_out = io.StringIO()
        with contextlib.redirect_stdout(summary_out), contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["summary", str(out)])
        rows = [[line.split("\t") for line in text.splitlines()]
                for text in (summary_out.getvalue(), emitted)]

        def close(a: str, b: str) -> bool:
            """Equal, or floats a float32 rounding apart: the BAM holds the
            float tags (qs, du) as float32, the emitted rows the record's."""
            if a == b:
                return True
            try:
                return abs(float(a) - float(b)) <= 1e-6 * max(abs(float(b)), 1.0)
            except ValueError:
                return False

        # the summary command reads no model stride (as the JAX command's): its
        # event counts come from mv tags, which this run does not write
        events = rows[1][0].index("num_events_template")
        if rc != 0 or len(rows[0]) != len(rows[1]) or len(rows[0]) != len(got) + 1 or any(
                len(a) != len(b) or not all(map(close, a[:events] + a[events + 1:],
                                                b[:events] + b[events + 1:]))
                for a, b in zip(rows[0], rows[1])):
            raise AssertionError("summary: its rows differ from the basecaller's --emit-summary")
        aligned = tmp / "aligned.bam"
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["aligner", str(ref), str(runs["cli hac sam"][0]), "-o", str(aligned)])
        aligner_records = read_records(aligned)[1]
        contig = next((r.rname for r in aligner_records if not r.flag & 4), None)
        on_contig = [r.qname for r in aligner_records if r.rname == contig]
        fetched = [r.qname for r in fetch_region(aligned, contig, 0, len(dict(contigs)[contig]))
                   ] if contig else []
        if rc != 0 or not on_contig or fetched != on_contig:
            raise AssertionError(f"aligner: exit code {rc}; fetch_region through its .bai gave "
                                 f"{len(fetched)} of the {len(on_contig)} records on {contig}")
        plain_wall = runs["cli hac"][1]
        print(f"cli reference: {' '.join(argv[3:-2])}: {mapped} of {len(got)} records mapped "
              f"(NM, AS, bh), the rest equal to the run without a reference; summary over the "
              f"BAM equal to --emit-summary but for event counts ({len(rows[0]) - 1} rows); "
              f"aligner -> sorted BAM + "
              f".bai, fetch_region on {contig} gave its {len(on_contig)} records; "
              f"{samples / wall:.0f} "
              f"samples/s with --reference ({wall:.3f} s wall) against {samples / plain_wall:.0f}"
              f" without ({plain_wall:.3f} s, the first run: set-up included) [{card}]",
              flush=True)


def splitter_phase(stride, smi, hac_step) -> None:
    """The read splitter on the card's host, in simplex mode (the basecaller's
    finder chain) and duplex mode (every finder), at pA-scaled settings (hac's
    pore threshold), over planted concatemers (``tests/torch_concatemers.py``)
    at the model's stride: 8 reads of 2-4 strands of 5-15 kb, the odd ones
    duplex (each strand the reverse complement of the one before, up to 10%
    edits), where a read of 3 or 4 strands has one junction without an
    adapter. Simplex mode must cut at the spacer base of every junction with
    an adapter, duplex mode at every junction. Prints the host ms a read of
    each mode beside the device ms of the hac Viterbi step for as many samples
    (``hac_step``: its profiled busy ms and samples)."""
    import numpy as np

    from dorado_tpu_torch.splitter import DuplexReadSplitter, DuplexSplitSettings
    from tests.torch_concatemers import concatemer

    rs = np.random.RandomState(SEED)
    reads = []
    for i in range(SPLIT_READS):
        n = int(rs.randint(2, 5))
        duplex = i % 2 == 1
        reads.append(concatemer(rs, list(rs.randint(*SPLIT_STRAND_BASES, n)), stride, duplex,
                                adapter_free=(1,) if duplex and n > 2 else ()))
    bases = sum(len(c.seq) for c in reads)
    samples = sum(len(c.signal) for c in reads)
    step_ms, step_samples = hac_step
    device_ms = step_ms * samples / step_samples / len(reads)
    for simplex in (True, False):
        splitter = DuplexReadSplitter(DuplexSplitSettings.for_pa_scaling())
        splitter.settings.simplex_mode = simplex
        times, cuts = [], 0
        for c in reads:
            t0 = time.perf_counter()
            subs = splitter.split(c.seq, c.qstring, c.moves, c.signal, stride)
            times.append(time.perf_counter() - t0)
            want = [b for b, adapter in zip(c.junctions, c.with_adapter) if adapter or not simplex]
            if [sr.seq for sr in subs] != c.pieces(want):
                raise AssertionError(
                    f"splitter ({'simplex' if simplex else 'duplex'}): {len(subs)} subreads, not "
                    f"the {len(want) + 1} that cutting at the planted bases {want} leaves")
            cuts += len(want)
        mode = "simplex" if simplex else "duplex"
        print(f"read splitter, {mode} mode: {SPLIT_READS} reads of {bases} bases, {samples} "
              f"samples, cut at all {cuts} planted bases; host {1e3 * np.mean(times):.2f} ms a "
              f"read (max {1e3 * max(times):.2f}, {1e6 * sum(times) / bases:.3f} ms a kb) beside "
              f"{device_ms:.2f} ms a read of the hac Viterbi device step for as many samples "
              f"[{smi}]", flush=True)


def modbase_reads(rs, stride, n=MODBASE_READS):
    """Synthetic reads for the modbase callers, made with numpy: (sequence of
    random bases, CG at about one in sixteen positions; a move table at
    ``stride``, one move a base over 2.2 steps a base; the scaled signal,
    white noise) triples."""
    import numpy as np

    reads = []
    for _ in range(n):
        bases = int(rs.randint(*MODBASE_BASES))
        seq = "".join(rs.choice(list("ACGT"), bases))
        steps = int(bases * 2.2)
        moves = np.zeros(steps, dtype=np.uint8)
        moves[0] = 1
        moves[np.sort(rs.choice(np.arange(1, steps), bases - 1, replace=False))] = 1
        reads.append((seq, moves, rs.randn(stride * steps).astype(np.float32)))
    return reads


def ml_close(got: np.ndarray, want: np.ndarray, counts: list) -> bool:
    """ML values of one record within 1 of the reference's; counts the
    values that differ and all values."""
    import numpy as np

    if got.shape != want.shape:
        return False
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    counts[0] += int((diff > 0).sum())
    counts[1] += diff.size
    return diff.max(initial=0) <= 1


def modbase_phase(cfg, model, reads, run_info, mod_dir, wrappers, check_launches, launches,
                  smi) -> None:
    """Modified-base calling on the card. (b) ``ModBaseCaller`` with the
    5mCG_5hmCG@v3 model at full width (``mod_dir``: random weights and kmer
    levels from the seed, rescale on) on the card and on the CPU over the
    same synthetic reads (``modbase_reads``): MM strings equal, ML bytes
    within 1 and equal at MIN_MODBASE_ML_EQUAL of positions; prints the host
    ms a read of ``prepare_read`` and the device ms of a batch of chunks. (c)
    ``BasecallerPipeline.run_reads`` at hac v4.3 (``model``, W8A8) with that
    caller, the finish pool's scheduler on (the default): it must launch the
    hac path's kernels and K1 float32 (``launches["modbase"]``), write MN, MM
    and ML after ``me`` on every record, and ML entries on at least one."""
    import numpy as np
    import torch

    from dorado_tpu_torch.io.sam import BamWriter
    from dorado_tpu_torch.modbase.caller import ModBaseCaller
    from dorado_tpu_torch.modbase.config import load_modbase_config
    from dorado_tpu_torch.modbase.tags import generate_modbase_tags, modbase_threshold_uint8
    from dorado_tpu_torch.pipeline import BasecallerPipeline

    mcfg = load_modbase_config(mod_dir)
    card = ModBaseCaller([mcfg], canonical_stride=cfg.stride)
    cpu = ModBaseCaller([mcfg], canonical_stride=cfg.stride, device="cpu")
    if card.scalers[0] is None or card.models[0].config.size != 256:
        raise AssertionError("the modbase model is not 5mCG_5hmCG@v3 at full width with rescale")
    mreads = modbase_reads(np.random.RandomState(SEED), cfg.stride)
    bases = sum(len(r[0]) for r in mreads)
    t0 = time.perf_counter()
    prepared = [card.prepare_read(*r) for r in mreads]
    prep_s = time.perf_counter() - t0
    chunks = sum(p.num_chunks for p in prepared)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = card.call_reads(prepared)
    call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = cpu.call_reads([cpu.prepare_read(*r) for r in mreads])
    cpu_s = time.perf_counter() - t0
    threshold = modbase_threshold_uint8(0.05)
    counts, hits = [0, 0], 0
    for (seq, _, _), a, b in zip(mreads, on_card, on_cpu):
        mm_a, ml_a, _ = generate_modbase_tags(seq, a.base_mod_probs, a.info, a.motif_hits,
                                              threshold)
        mm_b, ml_b, _ = generate_modbase_tags(seq, b.base_mod_probs, b.info, b.motif_hits,
                                              threshold)
        if mm_a != mm_b or not ml_close(ml_a, ml_b, counts):
            raise AssertionError("modbase on the card: MM differs from the CPU's, or ML by more "
                                 "than 1")
        hits += int(a.motif_hits.sum())
    equal = 1 - counts[0] / max(counts[1], 1)
    # a full batch of chunks: the model's forward on the card, and the
    # caller's batch (host staging, copies both ways, forward)
    batch = [(pm, start) for p in prepared for pm in p.models
             for start, _ in pm.chunk_list][: card.batch_size]
    size = mcfg.context.chunk_size
    sig = torch.randn(len(batch), size, device="cuda")
    seq = (torch.rand(len(batch), size, 4 * mcfg.kmer_len, device="cuda") < 0.1).to(torch.int8)
    with torch.inference_mode():
        card.models[0](sig, seq)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            card.models[0](sig, seq)
        end.record()
        end.synchronize()
    fwd_ms = start.elapsed_time(end) / 10
    # where the forward's device time goes, by kernel
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            card.models[0](sig, seq)
        torch.cuda.synchronize()
    by_kernel = sorted(((e.key, e.self_device_time_total / 5e3) for e in prof.key_averages()
                        if e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in by_kernel)
    t0 = time.perf_counter()
    for _ in range(10):
        card._run_batch(0, batch)
    batch_ms = (time.perf_counter() - t0) * 100
    print(f"modbase caller (5mCG_5hmCG@v3, H = 256, rescale on): {len(mreads)} reads, {bases} "
          f"bases, {hits} CG hits, {chunks} chunks in {-(-chunks // card.batch_size)} batches of "
          f"{card.batch_size}; card vs CPU: MM equal on every read, ML {counts[1]} values, "
          f"{equal:.4%} equal, none more than 1 apart; host prepare_read "
          f"{1e3 * prep_s / len(mreads):.2f} ms a read ({1e6 * prep_s / bases:.3f} ms a kb); "
          f"device {fwd_ms:.3f} ms a batch of {len(batch)} chunks (the model's forward), "
          f"{batch_ms:.3f} ms host clock for the caller's batch (staging, copies, forward); "
          f"call_reads {call_s:.3f} s on the card, {cpu_s:.3f} s on the CPU [{smi}]", flush=True)
    print(f"modbase forward (batch {len(batch)}) by kernel: device busy {busy_ms:.3f} ms of "
          f"{fwd_ms:.3f} ms [{smi}]", flush=True)
    for key, ms in by_kernel[:10]:
        print(f"  {ms:9.4f} ms {ms / busy_ms:6.1%}  {key[:90]}")
    if equal < MIN_MODBASE_ML_EQUAL or counts[1] == 0:
        raise AssertionError(f"modbase on the card: ML equal to the CPU's at {equal:.4%}")

    # (c) the pipeline with the caller: hac v4.3 + modbase, scheduler on
    class Records:
        def __init__(self, inner):
            self.inner, self.records = inner, []

        def write(self, rec):
            self.records.append(rec)
            self.inner.write(rec)

    pipe = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True, modbase_caller=card)
    pipe.run_reads(reads, Records(BamWriter(io.BytesIO(), pipe.build_header([run_info]))))
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    writer = Records(BamWriter(io.BytesIO(), pipe.build_header([run_info])))
    t0 = time.perf_counter()
    stats = pipe.run_reads(reads, writer)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches["modbase"] = {name: w.launches for name, w in wrappers.items()}
    check_launches("modbase", launches["modbase"], stats.batches)
    with_ml, ml_values, cg = 0, 0, 0
    for rec in writer.records:
        tags = [t.tag for t in rec.tags]
        if tags[-4:] != ["me", "MN", "MM", "ML"]:
            raise AssertionError(f"modbase pipeline: {rec.qname} has tags {tags[-4:]} last")
        ml = next(t.value for t in rec.tags if t.tag == "ML")
        with_ml += len(ml) > 0
        ml_values += len(ml)
        cg += rec.seq.count("CG")
    print(f"modbase pipeline (hac v4.3 W8A8 + 5mCG_5hmCG@v3, the finish pool's scheduler): "
          f"{len(reads)} reads, {len(writer.records)} records, {stats.bases_called} bases with "
          f"{cg} CG, {with_ml} records carry ML ({ml_values} values), {stats.batches} basecall "
          f"batches in {elapsed:.3f} s; K1 float32 launches {launches['modbase']['lstm_scan_f32']}; "
          f"host finish {stats.host_finish_s:.3f} thread-s [{smi}]", flush=True)
    if with_ml == 0:
        raise AssertionError("modbase pipeline: no record carries ML entries")


def batch_sweep(cfg, model, card) -> None:
    """``-b 0`` at hac: the sweep of ``auto_batch_size`` with the cache off."""
    from dorado_tpu_torch.basecall.batch_size import auto_batch_size

    timings = []
    t0 = time.perf_counter()
    chosen = auto_batch_size(cfg, model, cfg.basecaller.chunk_size, use_cache=False,
                             timings=timings)
    bench = 288 * cfg.stride
    for n, step_s in timings:
        print(f"-b 0 sweep, hac, chunk {bench}: batch {n}: {step_s * 1e3:.3f} ms a device step, "
              f"{n * bench / step_s:.4g} samples/s [{card}]", flush=True)
    print(f"-b 0 sweep chose batch {chosen} (of {[n for n, _ in timings]}) in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if chosen not in [n for n, _ in timings]:
        raise AssertionError(f"-b 0 chose {chosen}, which it did not time")


def draw_biases_and_norms(model, seed) -> None:
    """Draw a transformer's biases (convolutions, out_proj, upsample) and its
    norm weights from ``seed`` in place: the random init leaves them 0 and
    1, where a kernel that dropped or misplaced one would go unseen."""
    import torch

    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for b in (*model.conv_b, *(layer.out_proj_b for layer in model.layers),
                  model.upsample_b):
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
        for layer in model.layers:
            for w in (layer.norm1, layer.norm2):
                w.copy_(1.0 + 0.1 * torch.randn(w.shape, generator=g))


# ---- float32 compute and fast v4.0 ------------------------------------------
# K2 and K13 at float32: bit for bit, as their bf16 forms. K10 at float32:
#     products in 3xTF32 (about 2^-21 of each lost) and __expf where the plain
#     version runs float32 products and exp, the sums in another order:
#     max |err| / max |value| <= 1e-4
# K14 at float32: the product in 3xTF32 on mma.sync, whose float32 sums the
#     tensor cores round in their own way over K terms:
#     |err| <= 1e-4 * (|value| + 1), elementwise
TOL_ATTN_F32 = 1e-4
TOL_NORM_F32 = 1e-4
# each form is also launched at a ragged shape into an output filled with
# NaN first: rows (K2, K13, K14), and (N, T') for K10
F32_RAGGED_ROWS = 5 * 64 + 37
F32_RAGGED_ATTN = (3, 357)
# the float32 models on the card against the same float32 models on the CPU
# on the same chunks (mean abs difference over the mean abs score): only the
# order of float32 sums differs (hac: measured 1.2e-4 on an H100 80GB HBM3).
# Where a sum sits at an int8 rounding boundary of W8A8's activation
# quantisation it moves a step, four quantisations a sup layer, and over
# layers of random weights such steps grow as bf16's roundings do (measured:
# 2.1e-3 over sup's first 2 layers, 0.024 over all 18). So sup at W8A8 is
# held to MAX_F32_W8A8_SHALLOW over its first SUP_SHALLOW_DEPTH layers and
# to the bf16 limit (MAX_SUP_BF16_MEAN_ERR) over all 18; its unquantised
# float32 model, with no int8 rounding, to MAX_F32_SCORE_REL over all 18
# (measured 4.7e-6; 3.8e-4 with quantize_tx_head_w8a8's head, whose row
# quantisation moves a step where the stream sits at a rounding boundary)
MAX_F32_SCORE_REL = 1e-3
MAX_F32_W8A8_SHALLOW = 1e-2
# fast v4.0 in bf16 on the card against float32 on the CPU: the hac check's
# limit
MAX_FAST_BF16_MEAN_ERR = 0.02
FAST_T, FAST_S = 2000, 64  # fast v4.0 at chunk 10000 (stride 5), 64 states
# K1's wide form (widths no cluster of 16 CTAs holds: the LSTM-sup class's H
# = 768, and 1024): in bf16 within TOL_LSTM, in float32 within TOL_LSTM_F32
# (the same sums and cell update as K1's and K1 float32's, over more terms).
# (T, N, H) in both directions: hac's and LSTM-sup's chunk (T = 1666) at the
# batch, and ragged batches (100, 37: the last cluster part full, N no
# multiple of 8) at H = 768 and 1024, the float32 form also at 448 (above
# K1 float32's 384); each launched into an output filled with NaN first
WIDE_SHAPES = [(T, N, 768), (T, N, 1024), (64, 100, 768), (64, 37, 1024)]
WIDE_F32_SHAPES = [(T, N, 768), (T, N, 448), (64, 100, 768), (33, 37, 448)]
# the LSTM-sup class at full width (presets.lstm_sup_config: 5 LSTM layers of
# 768, 1024 states, chunk 9996): 10 reads of 130k samples give 140 chunks, a
# full batch of 128 and a second one, and two short reads go to the 7494
# lane. Its random model's LSTM outputs are smaller than hac's (768 units of
# weights 1/sqrt(768)), so the CRF head takes twice hac's gain for the
# Viterbi path to emit bases (on the CPU: 6 bases over 2 chunks at 64, 3327
# at 128). Its scores are held to hac's limits: bf16 with W8A8 against the
# CPU's float32 model within MAX_LSTM_SUP_BF16_MEAN_ERR (hac's 0.02), float32
# within MAX_F32_SCORE_REL
LSTM_SUP_LONG_READS, LSTM_SUP_SHORT_READS = 10, 2
LSTM_SUP_HEAD_GAIN = 128.0
MAX_LSTM_SUP_BF16_MEAN_ERR = 0.02
# duplex (``duplex_kernels``, ``duplex_phase``): the stereo model
# (presets.stereo_config: 13 features, stride 5, 5 LSTM layers of 384 with
# W8A8 projections, 64 states, a pre-v4 head with its bias) at chunk 10000 ->
# T = 2000 steps, on a runner of a quarter of the simplex batch (32 rows), of
# which one pair's chunks fill 1 to 32. K1 there at N = 1, 3 and 32 in both
# directions, bf16 within TOL_LSTM and float32 within TOL_LSTM_F32, into
# outputs filled with NaN first, each timed beside cuDNN's LSTM at the same
# shape; K2 at the rows of 3 and of 32 chunks (K = 384, O = 1536) bit for
# bit, also into a NaN-filled output, timed beside the torch._int_mm route
STEREO_T = 2000
STEREO_ROWS = N // 4
STEREO_K1_N = (1, 3, STEREO_ROWS)
STEREO_K2_ROWS = (3 * STEREO_T, STEREO_ROWS * STEREO_T)
# the duplex fixture (tests/torch_duplex.py): 21 template-complement pairs and
# 2 lone reads of 20-30k samples, 136 hac chunks, so that a full simplex
# batch and a partial one are dispatched; the stereo model's head takes
# hac's gain and a bias drawn from the seed (a dropped bias shows)
DUPLEX_FIXTURE = ROOT / "tests" / "data" / "torch_port" / "duplex.pod5"
# the stereo model in bf16 on the card against float32 on the CPU, on two
# feature chunks: hac's limit (0.02 of the mean abs score); in float32,
# MAX_F32_SCORE_REL
MAX_STEREO_BF16_MEAN_ERR = 0.02


def float32_kernels(k) -> None:
    """K2, K13, K10 and K14 at float32 on the card, at the main paths' shapes
    and at a ragged shape each (launched into outputs filled with NaN first,
    so that every position must be written), against their plain versions:
    K2 and K13 bit for bit, K10 within TOL_ATTN_F32, K14 within TOL_NORM_F32.
    Each is timed beside its bound, its plain version and one PyTorch call,
    in a row of its own in the ``kernels`` line. ``k`` holds main's helpers."""
    torch, dev, gen = k.torch, k.dev, k.gen
    F = torch.nn.functional
    int8_matmul, attention, fused_norm, tx_model = (
        k.int8_matmul, k.attention, k.fused_norm, k.tx_model)
    time_ms, report, card = k.time_ms, k.report, k.card

    def nan_like(shape):
        return torch.full(shape, float("nan"), device=dev)

    with torch.inference_mode():
        # ---- K2 at float32: hac's input projection, sup's qkv ----------------
        timed = {}
        for what, m, kin, o in (("hac", T * N, H, 4 * H), ("sup qkv", SUP_M, SUP_D, 3 * SUP_D),
                                ("ragged", F32_RAGGED_ROWS, H, 4 * H)):
            x = torch.randn(m, kin, generator=gen, device=dev)
            w = torch.randn(o, kin, generator=gen, device=dev) / kin**0.5
            wq, ws = int8_matmul.quantize_weight_rows(w)
            b = torch.randn(o, generator=gen, device=dev) * 0.1
            out = int8_matmul.w8a8_matmul_fq_f32(x, wq.t(), ws, b)
            into = int8_matmul._fq_launch(x, wq.t(), ws, b, torch.float32, out=nan_like((m, o)))
            ref = int8_matmul.w8a8_matmul_fq_plain(x, wq.t(), ws, b, torch.float32)
            torch.cuda.synchronize()
            if not (out.dtype == torch.float32 and torch.equal(out, ref)
                    and torch.equal(into, ref)):
                raise AssertionError(f"w8a8_matmul_fq_f32 {what} ({m}, {kin}, {o}): "
                                     f"{(out != ref).sum().item()} outputs differ from the plain "
                                     f"version's (or a position was not written)")
            print(f"w8a8_matmul_fq_f32 {what} (M={m} K={kin} O={o}): equal to the plain version, "
                  f"every position written", flush=True)
            if what != "ragged":
                timed[what] = dict(
                    ms=time_ms(lambda: int8_matmul.w8a8_matmul_fq_f32(x, wq.t(), ws, b), 10),
                    plain_ms=time_ms(lambda: int8_matmul.w8a8_matmul_fq_plain(
                        x, wq.t(), ws, b, torch.float32), 2),
                    library_ms=time_ms(lambda: F.linear(x, w, b), 5),
                    ops=2.0 * m * kin * o, nbytes=4 * m * kin + kin * o + 8 * o + 4 * m * o)
            del x, out, into, ref
        hac, sup = timed["hac"], timed["sup qkv"]
        sup_bound, sup_by = bound_ms(sup["ops"], PEAK_INT8, sup["nbytes"])
        report(
            "w8a8_matmul_fq_f32", "dorado_tpu_torch/csrc/w8a8_matmul_fq.cu",
            "dorado_tpu/ops/int8_matmul.py:267", 0.0, hac["ms"], hac["plain_ms"], hac["ops"],
            PEAK_INT8, hac["nbytes"], hac["library_ms"],
            "(float32 F.linear with the bias, TF32 off)", sup_ms=sup["ms"],
            sup_plain_ms=sup["plain_ms"], sup_bound_ms=sup_bound, sup_bound_by=sup_by,
            sup_library_ms=sup["library_ms"],
        )
        print(f"  at sup's qkv (M={SUP_M} K={SUP_D} O={3 * SUP_D}): kernel {sup['ms']:.3f} ms, "
              f"plain {sup['plain_ms']:.3f} ms, bound {sup_bound:.3f} ms ({sup_by}), float32 "
              f"F.linear {sup['library_ms']:.3f} ms [{card}]", flush=True)
        torch.cuda.empty_cache()

        # ---- K13 at float32: sup's fc2 (the timed shape last) -----------------
        for m in (F32_RAGGED_ROWS, SUP_M):
            xq = torch.randint(-127, 128, (m, SUP_FFN), generator=gen, device=dev,
                               dtype=torch.int8)
            xs = torch.rand(m, 1, generator=gen, device=dev) * 0.01
            wq, ws = int8_matmul.quantize_weight_rows(
                torch.randn(SUP_D, SUP_FFN, generator=gen, device=dev))
            out = int8_matmul.w8a8_matmul_f32(xq, xs, wq.t(), ws)
            into = int8_matmul._w8a8_launch(xq, xs, wq.t(), ws, torch.float32,
                                            out=nan_like((m, SUP_D)))
            ref = int8_matmul.w8a8_matmul_plain(xq, xs, wq.t(), ws, torch.float32)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref) and torch.equal(into, ref)):
                raise AssertionError(f"w8a8_matmul_f32 at M={m}: {(out != ref).sum().item()} "
                                     f"outputs differ from the plain version's")
            print(f"w8a8_matmul_f32 M={m} K={SUP_FFN} O={SUP_D}: equal to the plain version, "
                  f"every position written", flush=True)

        def int_mm_route():
            acc = torch._int_mm(xq, wq.t())
            return acc.float() * xs * ws

        report(
            "w8a8_matmul_f32", "dorado_tpu_torch/csrc/w8a8_matmul.cu",
            "dorado_tpu/ops/int8_matmul.py:218", 0.0,
            time_ms(lambda: int8_matmul.w8a8_matmul_f32(xq, xs, wq.t(), ws), 10),
            time_ms(lambda: int8_matmul.w8a8_matmul_plain(xq, xs, wq.t(), ws, torch.float32), 2),
            2.0 * SUP_M * SUP_FFN * SUP_D, PEAK_INT8,
            SUP_M * SUP_FFN + 4 * SUP_M + SUP_FFN * SUP_D + 4 * SUP_D + 4 * SUP_M * SUP_D,
            time_ms(int_mm_route, 10), "(torch._int_mm, then the float32 dequantise pass)",
        )
        del xq, xs, out, into, ref
        torch.cuda.empty_cache()

        # ---- K10 at float32: the float32 stream's attention -----------------
        hd, d_head = SUP_D, SUP_D // SUP_HEADS
        err = 0.0
        for n, t_len in (F32_RAGGED_ATTN, (N, SUP_TOK)):  # the timed shape last
            qkv = torch.randn(n, t_len, 3 * hd, generator=gen, device=dev)
            cos, sin = attention.rope_tables(t_len, d_head, 10000.0, dev)
            qk = attention.rope_qk(qkv, cos, sin, SUP_HEADS)
            out = attention.windowed_attention_prerotated_f32(qk, qkv, SUP_HEADS, *SUP_WINDOW)
            into = attention._prerotated_launch(qk, qkv, SUP_HEADS, *SUP_WINDOW, 12,
                                                out=nan_like((n, t_len, hd)))
            ref = attention.windowed_attention_prerotated_plain(qk, qkv, SUP_HEADS, *SUP_WINDOW)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            e = max((out - ref).abs().max().item(), (into - ref).abs().max().item()) / scale
            print(f"attention_prerotated_f32 N={n} T'={t_len}: max |err| / max |value| {e:.3g} "
                  f"(limit {TOL_ATTN_F32}), every position written", flush=True)
            if not (bool(torch.isfinite(into).all()) and e <= TOL_ATTN_F32):
                raise AssertionError(f"attention_prerotated_f32 at N={n} T'={t_len}: error {e}")
            err = max(err, e)
        q4, k4, v4 = (t.reshape(n, t_len, SUP_HEADS, d_head).transpose(1, 2).contiguous()
                      for t in (qk[..., :hd], qk[..., hd:], qkv[..., 2 * hd:]))
        pos = torch.arange(t_len, device=dev)
        mask = attention.band_mask(pos[:, None], pos[None, :], t_len, *SUP_WINDOW,
                                   attention.ref_strip_elems(t_len))
        sdpa = F.scaled_dot_product_attention
        pairs = float(mask.sum().item())
        ops = n * SUP_HEADS * pairs * 4.0 * d_head
        report(
            "attention_prerotated_f32", "dorado_tpu_torch/csrc/attention_banded.cu",
            "dorado_tpu/ops/attention.py:700", err,
            time_ms(lambda: attention.windowed_attention_prerotated_f32(
                qk, qkv, SUP_HEADS, *SUP_WINDOW), 5),
            time_ms(lambda: attention.windowed_attention_prerotated_plain(
                qk, qkv, SUP_HEADS, *SUP_WINDOW), 1),
            ops, PEAK_F32, 4 * n * t_len * 2 * hd + 4 * n * t_len * hd + 4 * n * t_len * hd,
            time_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask), 3),
            "(scaled_dot_product_attention in float32, dense T' x T' with the same boolean "
            "mask)", tf32x3_bound_ms=bound_ms(3 * ops, PEAK_TF32, 4 * n * t_len * 4 * hd)[0],
        )
        print(f"  max_abs_err of attention_prerotated_f32 is max |err| / max |value|", flush=True)
        del qkv, qk, out, into, ref, q4, k4, v4, mask
        torch.cuda.empty_cache()

        # ---- K14 at float32: out_proj and fc2 with the residual norm --------
        alpha = k.sup_alpha
        site_numbers = {}
        for site, k_in, with_bias in (("fc2", SUP_FFN, False), ("out_proj", SUP_D, True)):
            x = torch.randn(SUP_M, k_in, generator=gen, device=dev)
            w = torch.randn(SUP_D, k_in, generator=gen, device=dev) / k_in**0.5
            b = torch.randn(SUP_D, generator=gen, device=dev) * 0.1 if with_bias else None
            res = torch.randn(SUP_M, SUP_D, generator=gen, device=dev)
            nw = 1.0 + 0.1 * torch.randn(SUP_D, generator=gen, device=dev)
            errs = []
            for m in (F32_RAGGED_ROWS, SUP_M):
                args = (x[:m], w, b, res[:m], nw, alpha)
                out = fused_norm.matmul_residual_rmsnorm_f32(*args)
                into = fused_norm._launch(*args, 1e-5, out=nan_like((m, SUP_D)))
                ref = fused_norm.matmul_residual_rmsnorm_plain(*args)
                torch.cuda.synchronize()
                worst = max(((out - ref).abs() / (ref.abs() + 1.0)).max().item(),
                            ((into - ref).abs() / (ref.abs() + 1.0)).max().item())
                print(f"fused_norm_f32 {site} M={m} K={k_in}: the largest |err| / (|value| + 1) "
                      f"is {worst:.3g} (limit {TOL_NORM_F32}), every position written",
                      flush=True)
                if not (bool(torch.isfinite(into).all()) and worst <= TOL_NORM_F32):
                    raise AssertionError(f"fused_norm_f32 {site} at M={m}: error {worst}")
                errs.append(worst)
            args = (x, w, b, res, nw, alpha)

            def unfused():
                return tx_model.rms_norm(F.linear(x, w, b) + res * alpha, nw)

            site_numbers[site] = dict(
                err=max(errs),
                ms=time_ms(lambda: fused_norm.matmul_residual_rmsnorm_f32(*args), 5),
                plain_ms=time_ms(lambda: fused_norm.matmul_residual_rmsnorm_plain(*args), 2),
                library_ms=time_ms(unfused, 3), ops=2.0 * SUP_M * k_in * SUP_D,
                nbytes=4 * (SUP_M * k_in + SUP_D * k_in + 2 * SUP_M * SUP_D + 2 * SUP_D))
            del x, res, out, into, ref
        o, f2 = site_numbers["out_proj"], site_numbers["fc2"]
        fc2_bound, fc2_by = bound_ms(f2["ops"], PEAK_F32, f2["nbytes"])
        report(
            "fused_norm_f32", "dorado_tpu_torch/csrc/fused_norm.cu",
            "dorado_tpu/ops/fused_norm.py:55", max(o["err"], f2["err"]), o["ms"], o["plain_ms"],
            o["ops"], PEAK_F32, o["nbytes"], o["library_ms"],
            "(float32 F.linear + residual + rms_norm, TF32 off)", fc2_ms=f2["ms"],
            fc2_plain_ms=f2["plain_ms"], fc2_bound_ms=fc2_bound, fc2_bound_by=fc2_by,
            fc2_library_ms=f2["library_ms"],
        )
        print(f"  fused_norm_f32 at fc2 (K={SUP_FFN}, no bias): kernel {f2['ms']:.3f} ms, plain "
              f"{f2['plain_ms']:.3f} ms, bound {fc2_bound:.3f} ms ({fc2_by}), unfused float32 "
              f"passes {f2['library_ms']:.3f} ms [{card}]", flush=True)
        torch.cuda.empty_cache()


def wide_kernels(k) -> None:
    """K1's wide form in bf16 (``lstm_scan_time_major_wide``) and in float32
    (``lstm_scan_time_major_wide_f32``) at WIDE_SHAPES and WIDE_F32_SHAPES,
    both directions, into outputs filled with NaN first (through
    ``lstm._launch_wide``) and through the wrappers, against the plain
    version; each timed at T = 1666, N = 128 beside its bound and cuDNN's
    LSTM at the same shape (float32: TF32 off). Then K11a at float32 at sup's
    shape and a ragged one, into NaN-filled outputs, within TOL_ATTN_F32,
    timed beside its bound and SDPA in float32. A row each in the
    ``kernels`` line."""
    torch, dev, gen, lstm, attention = k.torch, k.dev, k.gen, k.lstm, k.attention
    F = torch.nn.functional
    time_ms, report, card = k.time_ms, k.report, k.card

    with torch.inference_mode():
        for name, dtype, es, shapes, tol, peak in (
                ("lstm_scan_wide", torch.bfloat16, 2, WIDE_SHAPES, TOL_LSTM, PEAK_BF16),
                ("lstm_scan_wide_f32", torch.float32, 4, WIDE_F32_SHAPES, TOL_LSTM_F32,
                 PEAK_F32)):
            symbol = "lstm_scan_wide_f32" if es == 4 else "lstm_scan_wide_bf16"
            wrapper = (lstm.lstm_scan_time_major_wide_f32 if es == 4
                       else lstm.lstm_scan_time_major_wide)
            err, timed = 0.0, {}
            for t_len, n, h in shapes:
                w = ((torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) / h**0.5).to(dtype)
                xproj = (torch.randn(t_len, n, 4 * h, generator=gen, device=dev) * 0.8).to(dtype)
                p = lstm.k1_wide_launch_plan(h, n, dev, es)
                for reverse in (False, True):
                    out = wrapper(xproj, w, reverse=reverse)
                    into = torch.full((t_len, n, h), float("nan"), dtype=dtype, device=dev)
                    lstm._launch_wide(symbol, xproj, *lstm.wide_w_hh(w, p), into, reverse, p)
                    ref = lstm.lstm_scan_plain(xproj, w, reverse=reverse)
                    torch.cuda.synchronize()
                    # NaN where a position was not written
                    e = max((out.float() - ref.float()).abs().max().item(),
                            (into.float() - ref.float()).abs().max().item())
                    smem = lstm._k1_wide_smem(p.units, p.cluster, p.rows, p.resident - p.reg, es)
                    print(f"{name} H={h} T={t_len} N={n} reverse={reverse}: max abs error "
                          f"{e:.3g} (limit {tol}), every position written; clusters of "
                          f"{p.cluster}, {p.units} units a CTA, {p.warps} warps, {p.rows} rows a "
                          f"cluster, {p.clusters} clusters; pairs of k-tiles: {p.reg} in "
                          f"registers, {p.resident - p.reg} resident, {p.pairs - p.resident} "
                          f"streamed from L2, of {p.pairs}; {smem} bytes of shared memory a "
                          f"CTA", flush=True)
                    if not e <= tol:
                        raise AssertionError(f"{name} at H={h} T={t_len} N={n} "
                                             f"reverse={reverse}: max abs error {e}")
                    err = max(err, e)
                    del out, into, ref
                if (t_len, n) != (T, N):
                    continue
                # timed as K1's row is: reversed (the first layer's direction),
                # beside cuDNN's one-layer LSTM at the same shape, its input
                # projection included
                cudnn = torch.nn.LSTM(h, h, device=dev, dtype=dtype)
                cudnn.flatten_parameters()
                x_in = torch.randn(t_len, n, h, generator=gen, device=dev).to(dtype)
                ms = time_ms(lambda: wrapper(xproj, w, reverse=True), 3)
                with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                    lib_ms = time_ms(lambda: cudnn(x_in), 3)
                ops = 2.0 * t_len * n * h * 4 * h
                nbytes = es * (t_len * n * 4 * h + h * 4 * h + t_len * n * h)
                b_ms, b_by = bound_ms(ops, peak, nbytes)
                timed[h] = dict(
                    ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, ops=ops,
                    nbytes=nbytes, us_per_step=ms / t_len * 1e3, split=p._asdict(),
                    plain_ms=time_ms(lambda: lstm.lstm_scan_plain(xproj, w, reverse=True), 1))
                if es == 4:
                    timed[h]["tf32x3_bound_ms"] = bound_ms(ops, PEAK_TF32 / 3, nbytes)[0]
                print(f"{name} T={t_len} N={n} H={h}: {ms:.3f} ms, {ms / t_len * 1e3:.3f} us a "
                      f"step; bound {b_ms:.3f} ms ({b_by}); cuDNN nn.LSTM "
                      f"{'float32, TF32 off' if es == 4 else 'bf16'} at the same shape "
                      f"{lib_ms:.3f} ms [{card}]", flush=True)
                del cudnn, x_in
            first, second = timed[shapes[0][2]], timed[shapes[1][2]]
            report(
                name, "dorado_tpu_torch/csrc/lstm_scan.cu", "dorado_tpu/ops/lstm.py:65", err,
                first["ms"], first["plain_ms"], first["ops"], peak, first["nbytes"],
                first["library_ms"],
                "(cuDNN nn.LSTM" + (" float32, TF32 off" if es == 4 else "")
                + ", one layer, incl. its input projection)",
                shape=f"T={T} N={N} H={shapes[0][2]}", us_per_step=first["us_per_step"],
                split=first["split"],
                **({"tf32x3_bound_ms": first["tf32x3_bound_ms"]} if es == 4 else {}),
                **{f"h{shapes[1][2]}_{key}": v for key, v in second.items()
                   if key not in ("ops", "nbytes")},
            )
            torch.cuda.empty_cache()
        print(f"  the wide forms' clusters the card runs at once, by width: "
              f"{ {key[1:4:2]: c for key, c in lstm._active.items()
                   if not key[2] and lstm.k1_needs_wide(key[1], key[3])} }", flush=True)

        # ---- K11a at float32: the float32 stream on the "hp" route ----------
        hd, d_head = SUP_D, SUP_D // SUP_HEADS
        rows = torch.from_numpy(attention.wqkv_halfperm_rows(SUP_HEADS, SUP_D)).to(dev)
        err = 0.0
        for n, t_len in (F32_RAGGED_ATTN, (N, SUP_TOK)):  # the timed shape last
            qkv = torch.randn(n, t_len, 3 * hd, generator=gen, device=dev)
            hp = qkv[..., rows].contiguous()
            cos, sin = attention.rope_tables(t_len, d_head, 10000.0, dev)
            out = attention.windowed_attention_halfperm_f32(hp, cos, sin, SUP_HEADS, *SUP_WINDOW)
            into = attention._halfperm_launch(hp, cos, sin, SUP_HEADS, *SUP_WINDOW, 12,
                                              out=torch.full((n, t_len, hd), float("nan"),
                                                             device=dev))
            ref = attention.windowed_attention_halfperm_plain(hp, cos, sin, SUP_HEADS,
                                                              *SUP_WINDOW)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            e = max((out - ref).abs().max().item(), (into - ref).abs().max().item()) / scale
            print(f"attention_halfperm_f32 N={n} T'={t_len}: max |err| / max |value| {e:.3g} "
                  f"(limit {TOL_ATTN_F32}), every position written", flush=True)
            if not (bool(torch.isfinite(into).all()) and e <= TOL_ATTN_F32):
                raise AssertionError(f"attention_halfperm_f32 at N={n} T'={t_len}: error {e}")
            err = max(err, e)
        qk = attention.rope_qk(qkv, cos, sin, SUP_HEADS)
        q4, k4, v4 = (t.reshape(n, t_len, SUP_HEADS, d_head).transpose(1, 2).contiguous()
                      for t in (qk[..., :hd], qk[..., hd:], qkv[..., 2 * hd:]))
        pos = torch.arange(t_len, device=dev)
        mask = attention.band_mask(pos[:, None], pos[None, :], t_len, *SUP_WINDOW,
                                   attention.ref_strip_elems(t_len))
        pairs = float(mask.sum().item())
        ops = n * SUP_HEADS * pairs * 4.0 * d_head
        report(
            "attention_halfperm_f32", "dorado_tpu_torch/csrc/attention_banded.cu",
            "dorado_tpu/ops/attention.py:608", err,
            time_ms(lambda: attention.windowed_attention_halfperm_f32(
                hp, cos, sin, SUP_HEADS, *SUP_WINDOW), 5),
            time_ms(lambda: attention.windowed_attention_halfperm_plain(
                hp, cos, sin, SUP_HEADS, *SUP_WINDOW), 1),
            ops, PEAK_F32,
            4 * n * t_len * 3 * hd + 4 * n * t_len * hd + 2 * 4 * t_len * (d_head // 2),
            time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), 3),
            "(scaled_dot_product_attention in float32 on q and k rotated beforehand, dense T' x "
            "T' with the same boolean mask)",
            tf32x3_bound_ms=bound_ms(3 * ops, PEAK_TF32, 4 * n * t_len * 4 * hd)[0],
        )
        print("  max_abs_err of attention_halfperm_f32 is max |err| / max |value|", flush=True)
        del qkv, hp, qk, out, into, ref, q4, k4, v4, mask
        torch.cuda.empty_cache()


def profiled_step(k, what, runner) -> None:
    """One full batch of ``runner``'s device step under the profiler: its
    device time by kernel and its busy share of the wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    torch = k.torch
    buf = runner.make_input_buffer(0)
    buf[:] = np.random.RandomState(SEED).randn(*buf.shape)
    runner.call_chunks(buf, buf.shape[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.call_chunks(buf, buf.shape[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                        if e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in by_kernel)
    print(f"{what} device step (batch {buf.shape[0]}, chunk {buf.shape[1]}, "
          f"{runner.compute_dtype}): wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({busy / wall_ms:.1%}) [{k.card}]", flush=True)
    for key, ms in by_kernel[:12]:
        print(f"  {ms:9.3f} ms {ms / busy:6.1%}  {key[:90]}")


def chunk_signals(pipe, reads):
    """One chunk of each read (long reads: each fills it), scaled as the
    pipeline scales it, as f16 [reads, chunk]."""
    import numpy as np

    chunk = pipe.runner.chunk_size
    return np.stack([pipe.scaler.scale_read(r.signal, read_scale=0.2)[0][10:10 + chunk]
                     for r in reads]).astype(np.float16)


def score_rel(k, model, ref_model, sig, layers=None) -> float:
    """Mean abs difference of two models' scores (``model`` on the card,
    ``ref_model`` on the CPU, or both on the card) over the mean abs score,
    on the chunks ``sig``; over their first ``layers`` encoder layers where
    given."""
    torch = k.torch
    kept = [(m, m.layers) for m in (model, ref_model) if layers is not None]
    try:
        for m, all_layers in kept:
            m.layers = all_layers[:layers]
        with torch.inference_mode():
            a = model(torch.from_numpy(sig).to(k.dev)).float()
            ref_dev = next(ref_model.parameters()).device
            b = ref_model(torch.from_numpy(sig).to(ref_dev)).float().to(a.device)
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError("scores not finite or of the wrong shape")
        return ((a - b).abs().mean() / b.abs().mean()).item()
    finally:
        for m, all_layers in kept:
            m.layers = all_layers


def hold_scores_and_decode(k, what, runner, cpu_runner, sig, max_rel, layers=None) -> None:
    """The model's scores on the card against the CPU model's on the same
    chunks (``score_rel`` within ``max_rel``, over the first ``layers``
    encoder layers where given), and the card's Viterbi decode of its own
    bf16 scores equal (sequences and moves) to the CPU's decode of the same
    values."""
    import numpy as np

    torch = k.torch
    rel = score_rel(k, runner.model, cpu_runner.model, sig, layers)
    depth = "" if layers is None else f", first {layers} layers"
    print(f"{what}: scores on the card vs the CPU's {cpu_runner.compute_dtype} model{depth}: "
          f"mean abs difference {rel:.3e} of the mean abs score (limit {max_rel})", flush=True)
    if not rel <= max_rel:
        raise AssertionError(f"{what}: scores too far from the CPU model's")
    with torch.inference_mode():
        scores = runner.model(torch.from_numpy(sig).to(k.dev))
        vit = scores.to(torch.bfloat16)
        on_card = runner.decode_scores(vit).cpu().numpy()
        on_cpu = cpu_runner.decode_scores(vit.float().cpu()).numpy()
        emit = on_card[2].astype(bool)
        if not (np.array_equal(on_card[0], on_cpu[0]) and np.array_equal(on_card[2], on_cpu[2])
                and emit.sum() > 0):
            raise AssertionError(f"{what}: the device decode differs from the CPU decode (or "
                                 f"calls no base)")
        print(f"  {what}: Viterbi decode of the card's bf16 scores, {int(emit.sum())} bases, "
              f"equal to the CPU decode of the same values", flush=True)


def run_path(k, path, pipe, reads, what) -> None:
    """``run_reads`` over ``reads`` with every launch counter at 0 first; the
    launches must be those of ``path`` (``k.check_launches``), and every read
    must have a record or subreads."""
    torch = k.torch
    pipe.run_reads(reads, k.Discard())  # the per-shape set-up, reused below
    torch.cuda.synchronize()
    for w in k.wrappers.values():
        w.launches = 0
    written = k.Parents(k.Discard())
    t0 = time.perf_counter()
    stats = pipe.run_reads(reads, written)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k.launches[path] = {name: w.launches for name, w in k.wrappers.items()}
    k.check_launches(path, k.launches[path], stats.batches)
    if set(written.parents) != {r.read_id for r in reads} or stats.bases_called == 0:
        raise AssertionError(f"{path}: {len(set(written.parents))} of {len(reads)} reads "
                             f"written, {stats.bases_called} bases")
    samples = sum(len(r.signal) for r in reads)
    print(f"{path} pipeline: {len(reads)} reads, {samples} samples, {stats.batches} batches, "
          f"{stats.bases_called} bases in {elapsed:.3f} s = {samples / elapsed:.0f} samples/s "
          f"({what}) [{k.card}]; launches "
          f"{ {n: v for n, v in k.launches[path].items() if v} }; device idle "
          f"{stats.device_idle_s:.3f} s", flush=True)


def float32_paths(k, cfg, model, reads, sup_cfg, sup_model, sup_reads) -> None:
    """``compute_dtype=torch.float32`` on the card: ``run_reads`` at hac v4.3
    (Viterbi and beam, W8A8: K2 and K1 at float32) and at sup v5.0 (W8A8: K2,
    K10, K12 and K13 at their float32 forms), and one device step of sup with
    the fused norms (K14 at float32); the scores against the CPU's float32
    models (also with ``quantize_tx_head_w8a8``'s head, through K2), the
    decode against the CPU's, and one profiled step each."""
    import numpy as np

    torch = k.torch
    from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
    from dorado_tpu_torch.pipeline import BasecallerPipeline

    f32 = dict(batch_size=N, emit_moves=True, compute_dtype=torch.float32)
    hac = BasecallerPipeline(cfg, model, **f32)
    hac_beam = BasecallerPipeline(cfg, model, decoder="beam", **f32)
    sup = BasecallerPipeline(sup_cfg, sup_model, **f32)
    if not (hac.runner.compute_dtype == sup.runner.compute_dtype == torch.float32
            and hac.runner.score_dtype == torch.bfloat16
            and next(sup.runner.model.parameters()).dtype == torch.float32):
        raise AssertionError("the float32 pipelines do not hold float32 models")
    run_path(k, "hac f32 viterbi", hac, reads, "hac v4.3, float32, W8A8 projections")
    run_path(k, "hac f32 beam", hac_beam, reads, "hac v4.3, float32, W8A8, beam decoder")
    run_path(k, "sup f32", sup, sup_reads, "sup v5.0, 18 layers, float32, W8A8 encoder matmuls")
    sup_hp = BasecallerPipeline(sup_cfg, sup_model, tx_attention="hp", **f32)
    run_path(k, "sup hp f32", sup_hp, sup_reads,
             "sup v5.0, 18 layers, float32, W8A8 encoder matmuls, hp attention route")
    # the fused norms on a copy whose biases and norm weights are drawn from
    # the seed, as the route check's
    drawn = k.tx_model.with_routes(sup_model)
    draw_biases_and_norms(drawn, SEED)
    fused = TorchBasecallRunner(sup_cfg, drawn, batch_size=N, tx_fused_norm=True,
                                compute_dtype=torch.float32)
    buf = fused.make_input_buffer(0)
    buf[:] = np.random.RandomState(SEED).randn(*buf.shape)
    for w in k.wrappers.values():
        w.launches = 0
    fused.call_chunks(buf, buf.shape[0])
    torch.cuda.synchronize()
    k.launches["sup f32 fused"] = {name: w.launches for name, w in k.wrappers.items()}
    k.check_launches("sup f32 fused", k.launches["sup f32 fused"], 1)
    print(f"sup f32 fused: one device step, launches "
          f"{ {n: v for n, v in k.launches['sup f32 fused'].items() if v} }", flush=True)

    kw = dict(batch_size=N, compute_dtype=torch.float32)
    sig = chunk_signals(hac, reads[2:6])
    hold_scores_and_decode(k, "hac f32", hac.runner, TorchBasecallRunner(
        cfg, model, device="cpu", lstm_precision="w8a8", **kw), sig, MAX_F32_SCORE_REL)
    sig = chunk_signals(sup, sup_reads[SUP_SHORT_READS:SUP_SHORT_READS + 2])
    sup_cpu = TorchBasecallRunner(sup_cfg, sup_model, device="cpu", tx_precision="w8a8", **kw)
    hold_scores_and_decode(k, "sup f32", sup.runner, sup_cpu, sig, MAX_F32_W8A8_SHALLOW,
                           layers=SUP_SHALLOW_DEPTH)
    rel = score_rel(k, sup.runner.model, sup_cpu.model, sig)
    print(f"  sup f32, all 18 layers: mean abs difference {rel:.3e} of the mean abs score "
          f"(limit {MAX_SUP_BF16_MEAN_ERR}, the bf16 model's)", flush=True)
    if not rel <= MAX_SUP_BF16_MEAN_ERR:
        raise AssertionError("sup f32: scores over all layers too far from the CPU model's")
    # unquantised, all 18 layers: the float32 stream's own arithmetic (K10 at
    # float32, the norms, the float32 products), no int8 rounding
    plain = dict(tx_precision="bf16", **kw)
    rel = score_rel(k, TorchBasecallRunner(sup_cfg, sup_model, **plain).model,
                    TorchBasecallRunner(sup_cfg, sup_model, device="cpu", **plain).model, sig)
    print(f"sup f32 unquantised, all 18 layers: scores on the card vs the CPU's mean abs "
          f"difference {rel:.3e} of the mean abs score (limit {MAX_F32_SCORE_REL})", flush=True)
    if not rel <= MAX_F32_SCORE_REL:
        raise AssertionError("sup f32 unquantised: scores too far from the CPU model's")
    # the quantised head (quantize_tx_head_w8a8: the upsample and the CRF
    # head through K2 at float32) behind the unquantised encoder, whose
    # stream the card computes as the CPU does (above), on the card against
    # the CPU: where the stream sits at an int8 rounding boundary of the
    # head's row quantisation, a score moves a step
    head_q = k.tx_model.quantize_tx_head_w8a8(sup_model)
    on_card = TorchBasecallRunner(sup_cfg, head_q, **plain)
    for w in k.wrappers.values():
        w.launches = 0
    rel = score_rel(k, on_card.model,
                    TorchBasecallRunner(sup_cfg, head_q, device="cpu", **plain).model, sig)
    torch.cuda.synchronize()
    head_launches = k.wrappers["w8a8_matmul_fq_f32"].launches
    print(f"sup f32 unquantised with the quantised head, all 18 layers: scores on the card vs "
          f"the CPU's mean abs difference {rel:.3e} of the mean abs score (limit "
          f"{MAX_F32_SCORE_REL}); K2 float32 launched {head_launches} times (the upsample and "
          f"the CRF head)", flush=True)
    if not (rel <= MAX_F32_SCORE_REL and head_launches == 2):
        raise AssertionError("sup f32 quantised head: too far from the CPU's, or not on K2")
    del on_card, head_q
    # the fused norms against the unfused route, on the card at float32
    rel = score_rel(k, fused.model, TorchBasecallRunner(sup_cfg, drawn, **kw).model, sig,
                    SUP_SHALLOW_DEPTH)
    print(f"sup f32 fused norms vs unfused on the card, first {SUP_SHALLOW_DEPTH} layers: mean "
          f"abs difference {rel:.3e} of the mean abs score (limit {MAX_F32_W8A8_SHALLOW})",
          flush=True)
    if not rel <= MAX_F32_W8A8_SHALLOW:
        raise AssertionError("sup f32: the fused norms are too far from the unfused route")
    # the "hp" route at float32 against the default route on the card, on the
    # drawn copy, all 18 layers: K11a's float32 staging rotates as rope_qk
    # does (each product and sum singly rounded) and the float32 body after it
    # is K10's, and wqkv's permuted rows give the same int8 products, so the
    # route check's limit for "hp" holds: equal
    hp_f32 = TorchBasecallRunner(sup_cfg, drawn, tx_attention="hp", **kw).model
    with torch.inference_mode():
        got = hp_f32(torch.from_numpy(sig).to(k.dev))
        want = TorchBasecallRunner(sup_cfg, drawn, **kw).model(torch.from_numpy(sig).to(k.dev))
    diff = (got - want).abs().max().item() if got.shape == want.shape else float("inf")
    print(f"sup hp attention, float32 W8A8, vs the default route on the card, all 18 layers: "
          f"max abs difference {diff}", flush=True)
    if diff != 0:
        raise AssertionError("sup hp f32: scores differ from the default route's")
    del hp_f32, got, want
    for what, runner in (("hac f32 viterbi", hac.runner), ("hac f32 beam", hac_beam.runner),
                         ("sup f32", sup.runner), ("sup f32 fused", fused),
                         ("sup hp f32", sup_hp.runner)):
        profiled_step(k, what, runner)
    del hac, hac_beam, sup, fused, sup_cpu, drawn, sup_hp
    torch.cuda.empty_cache()


def fast_phase(k, reads) -> tuple:
    """fast v4.0 at full width (5 LSTM layers of 96, 64 states, chunk 10000,
    batch 128, unquantised projections, random weights from the seed with
    the CRF head's gain): its kernels timed at its shapes (K1 at H = 96 in
    bf16 and float32; K3, K6 and K17 at 64 states: ``fast_*`` keys of their
    rows; K4 and K5 are timed at 64 states with their checks), then
    ``run_reads`` in bf16 (Viterbi and beam) and in float32, each path's
    launches held, its scores against the CPU's float32 model and its decode
    against the CPU's, and one profiled step each. Returns (config, model)."""
    import numpy as np

    torch, dev, gen = k.torch, k.dev, k.gen
    lstm, crf_cuda, beam = k.lstm, k.crf_cuda, k.beam
    from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
    from dorado_tpu_torch.models.crf_model import init_lstm_crf_params
    from dorado_tpu_torch.models.presets import fast_v40_config
    from dorado_tpu_torch.pipeline import BasecallerPipeline

    cfg = fast_v40_config()
    cfg.normalise_basecaller_params()
    model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.linear1_w.mul_(HEAD_GAIN)
    hf = cfg.lstm_size

    def fast_times(name, ms, plain_ms, ops, peak, nbytes, **extra):
        b_ms, b_by = bound_ms(ops, peak, nbytes)
        row = next(r for r in k.rows if r["name"] == name)
        row.update(fast_ms=ms, fast_plain_ms=plain_ms, fast_bound_ms=b_ms, fast_bound_by=b_by,
                   **extra)
        print(f"{name} at fast v4.0's shapes: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
              f"bound {b_ms:.3f} ms ({b_by}) {extra or ''} [{k.card}]", flush=True)

    with torch.inference_mode():
        # K1 at H = 96, bf16 and float32, at fast's T and batch
        for name, dtype, peak, elem in (("lstm_scan", torch.bfloat16, PEAK_BF16, 2),
                                        ("lstm_scan_f32", torch.float32, PEAK_F32, 4)):
            xp = torch.randn(FAST_T, N, 4 * hf, generator=gen, device=dev).to(dtype)
            whh = (torch.randn(hf, 4 * hf, generator=gen, device=dev) / hf**0.5).to(dtype)
            out = lstm.lstm_scan_time_major(xp, whh)
            ref = lstm.lstm_scan_plain(xp, whh)
            torch.cuda.synchronize()
            e = (out.float() - ref.float()).abs().max().item()
            limit = TOL_LSTM if dtype == torch.bfloat16 else TOL_LSTM_F32
            print(f"{name} at fast's H={hf} T={FAST_T} N={N}: max abs error {e:.3g} (limit "
                  f"{limit}); split {lstm.k1_launch_plan(hf, N, dev, elem_bytes=elem)}", flush=True)
            if not e <= limit:
                raise AssertionError(f"{name} at H={hf}: max abs error {e}")
            fast_times(name, k.time_ms(lambda: lstm.lstm_scan_time_major(xp, whh), 5),
                       k.time_ms(lambda: lstm.lstm_scan_plain(xp, whh), 1),
                       2.0 * FAST_T * N * hf * 4 * hf, peak,
                       elem * (FAST_T * N * 4 * hf + hf * 4 * hf + FAST_T * N * hf),
                       fast_max_abs_err=e)
            del xp, out, ref
        # K3, the full-history scans (K6) and K17 at 64 states on fast's T
        sc = (torch.randn(FAST_T, N, 4 * FAST_S, generator=gen, device=dev) * 2).clamp(-5, 5)
        sc16 = sc.bfloat16()
        fast_times("crf_lse_backward",
                   k.time_ms(lambda: crf_cuda.backward_scores_shifted(sc16, STAY), 5),
                   k.time_ms(lambda: crf_cuda.backward_scores_shifted_plain(sc16, STAY), 1),
                   17.0 * FAST_T * N * FAST_S, PEAK_F32,
                   2 * FAST_T * N * 4 * FAST_S + 2 * FAST_T * N * FAST_S)
        ops = LSE_F64_FLOPS * 2 * FAST_T * N * FAST_S
        fast_times("crf_lse_scan",
                   k.time_ms(lambda: crf_cuda.forward_backward_scores(sc, STAY), 3),
                   k.time_ms(lambda: (k.crf_scan.forward_scores(sc, STAY),
                                      k.crf_scan.backward_scores(sc, STAY)), 1),
                   ops, PEAK_F64, 4 * FAST_T * N * 4 * FAST_S + 2 * 4 * (FAST_T + 1) * N * FAST_S)
        beta = crf_cuda.backward_scores(sc, STAY)
        fast_times("beam_search",
                   k.time_ms(lambda: beam.beam_forward(sc, beta, W, BEAM_CUT, STAY), 3),
                   k.time_ms(lambda: beam.beam_forward_plain(sc, beta, W, BEAM_CUT, STAY), 1),
                   float(FAST_T * N * W * (8 * W + 115)), PEAK_F32,
                   4 * FAST_T * N * 4 * FAST_S + 4 * FAST_T * N * FAST_S + FAST_T * N * W * 5
                   + N * W * 12)
        del sc, sc16, beta
    torch.cuda.empty_cache()

    p = dict(batch_size=N, emit_moves=True)
    vit = BasecallerPipeline(cfg, model, **p)
    bm = BasecallerPipeline(cfg, model, decoder="beam", **p)
    f32 = BasecallerPipeline(cfg, model, compute_dtype=torch.float32, **p)
    if vit.runner.chunk_size // cfg.stride != FAST_T or cfg.num_states != FAST_S:
        raise AssertionError("the fast pipeline is not fast v4.0 at chunk 10000")
    if any(hasattr(layer, "w_ih_q") for layer in vit.runner.model.lstms):
        raise AssertionError("fast's projections were quantised (H = 96 is no multiple of 128)")
    run_path(k, "fast viterbi", vit, reads, "fast v4.0, bf16, unquantised projections")
    run_path(k, "fast beam", bm, reads, "fast v4.0, bf16, beam decoder")
    run_path(k, "fast f32", f32, reads, "fast v4.0, float32")
    sig = chunk_signals(vit, reads[2:6])
    cpu = TorchBasecallRunner(cfg, model, device="cpu", batch_size=N)
    hold_scores_and_decode(k, "fast bf16", vit.runner, cpu, sig, MAX_FAST_BF16_MEAN_ERR)
    hold_scores_and_decode(k, "fast f32", f32.runner, cpu, sig, MAX_F32_SCORE_REL)
    for what, runner in (("fast viterbi", vit.runner), ("fast beam", bm.runner),
                         ("fast f32", f32.runner)):
        profiled_step(k, what, runner)
    del vit, bm, f32, cpu
    torch.cuda.empty_cache()
    return cfg, model


def lstm_sup_phase(k, make_read) -> tuple:
    """The LSTM-sup class at full width (``lstm_sup_config``: 5 LSTM layers of
    768 on K1's wide form, 1024 states, chunk 9996, batch 128, random weights
    from the seed with LSTM_SUP_HEAD_GAIN on the CRF head), through
    ``run_reads`` over reads that fill a batch (``make_read``): bf16 with W8A8
    projections and the Viterbi decoder, the same with the beam decoder, and
    float32 (W8A8, Viterbi), each path's launches held. The scores of two
    chunks against the CPU's float32 W8A8 model (hac's limits at each type),
    the card's Viterbi decode of them equal to the CPU's, the card's beam
    against the CPU's plain beam on the same scores and back guide (K17's
    limits), and one profiled step each. Returns (config, model)."""
    import numpy as np

    torch, dev = k.torch, k.dev
    crf_cuda, beam = k.crf_cuda, k.beam
    from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
    from dorado_tpu_torch.models.crf_model import init_lstm_crf_params
    from dorado_tpu_torch.models.presets import lstm_sup_config
    from dorado_tpu_torch.pipeline import BasecallerPipeline

    cfg = lstm_sup_config()
    cfg.normalise_basecaller_params()
    model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.linear1_w.mul_(LSTM_SUP_HEAD_GAIN)
    # from a generator of their own: the later phases keep their draws
    rs = np.random.RandomState(SEED + 1)
    reads = [make_read(200 + i, 130_000 if i >= LSTM_SUP_SHORT_READS
                       else int(rs.randint(3_000, 7_001)), rs)
             for i in range(LSTM_SUP_SHORT_READS + LSTM_SUP_LONG_READS)]
    p = dict(batch_size=N, emit_moves=True)
    vit = BasecallerPipeline(cfg, model, **p)
    bm = BasecallerPipeline(cfg, model, decoder="beam", **p)
    f32 = BasecallerPipeline(cfg, model, compute_dtype=torch.float32, **p)
    if (vit.runner.chunk_size // cfg.stride != T or cfg.num_states != SUP_S
            or cfg.lstm_size != 768 or not k.lstm.k1_needs_wide(cfg.lstm_size)):
        raise AssertionError("the LSTM-sup pipeline is not 768 wide at 1024 states, chunk 9996")
    for pipe in (vit, bm, f32):
        if not all(hasattr(layer, "w_ih_q") for layer in pipe.runner.model.lstms):
            raise AssertionError("the LSTM-sup projections are not W8A8")
    what = f"LSTM-sup (H = 768, 1024 states), batch {N}"
    run_path(k, "lstm sup viterbi", vit, reads, what + ", bf16 with W8A8 projections")
    run_path(k, "lstm sup beam", bm, reads, what + ", bf16 with W8A8, beam decoder")
    run_path(k, "lstm sup f32", f32, reads, what + ", float32 with W8A8 projections")
    sig = chunk_signals(vit, reads[LSTM_SUP_SHORT_READS:LSTM_SUP_SHORT_READS + 2])
    cpu = TorchBasecallRunner(cfg, model, device="cpu", lstm_precision="w8a8", batch_size=N)
    hold_scores_and_decode(k, "lstm sup bf16", vit.runner, cpu, sig, MAX_LSTM_SUP_BF16_MEAN_ERR)
    hold_scores_and_decode(k, "lstm sup f32", f32.runner, cpu, sig, MAX_F32_SCORE_REL)
    # the beam on the card against the CPU's plain beam on the same float32
    # scores, the card's back guide on both sides
    with torch.inference_mode():
        scores = bm.runner.model(torch.from_numpy(sig).to(dev)).contiguous()
        back_guide = crf_cuda.backward_scores(scores, STAY)
        st_k, mv_k = beam.beam_search_device(scores, back_guide, W, BEAM_CUT, STAY)
        st_c, mv_c = beam.beam_search_plain(scores.cpu(), back_guide.cpu(), W, BEAM_CUT, STAY)
    per_row = ((st_k.cpu() != st_c) | (mv_k.cpu() != mv_c)).sum(dim=1).tolist()
    print(f"lstm sup beam on the card vs the CPU's plain beam, the card's back guide on both: "
          f"differing steps by row {per_row} of {T}; {int(mv_k.sum().item())} moves", flush=True)
    if (sum(c > 0 for c in per_row) > BEAM_MAX_ROWS_DIFFERENT
            or max(per_row) > BEAM_MAX_ROW_SHARE_DIFFERENT * T or int(mv_k.sum().item()) == 0):
        raise AssertionError("lstm sup beam: far from the CPU's plain beam on the same back guide")
    for what, runner in (("lstm sup viterbi", vit.runner), ("lstm sup beam", bm.runner),
                         ("lstm sup f32", f32.runner)):
        profiled_step(k, what, runner)
    del vit, bm, f32, cpu, scores, back_guide
    torch.cuda.empty_cache()
    return cfg, model


def duplex_kernels(k) -> None:
    """K1 (bf16 and float32) and K2 at the stereo runner's shapes: K1 at T =
    2000, H = 384 and N = 1, 3 and 32 in both directions, launched into
    outputs filled with NaN first and through its wrapper, against its plain
    version, each timed beside its bound and cuDNN's LSTM at the same shape
    (float32: TF32 off); K2 at the rows of 3 and 32 chunks bit for bit (also
    into a NaN-filled output), timed beside the torch._int_mm route. The
    times go into K1's, K1 float32's and K2's rows as ``stereo_*`` keys."""
    torch, dev, gen, lstm, int8_matmul = k.torch, k.dev, k.gen, k.lstm, k.int8_matmul
    time_ms, card = k.time_ms, k.card
    g4 = 4 * H

    def row(name):
        return next(r for r in k.rows if r["name"] == name)

    with torch.inference_mode():
        for name, symbol, dtype, tol, peak, es in (
                ("lstm_scan", "lstm_scan_bf16", torch.bfloat16, TOL_LSTM, PEAK_BF16, 2),
                ("lstm_scan_f32", "lstm_scan_f32", torch.float32, TOL_LSTM_F32, PEAK_F32, 4)):
            w = ((torch.rand(H, g4, generator=gen, device=dev) * 2 - 1) / H**0.5).to(dtype)
            keys = {}
            for n in STEREO_K1_N:
                xproj = (torch.randn(STEREO_T, n, g4, generator=gen, device=dev) * 0.8).to(dtype)
                plan = lstm.k1_launch_plan(H, n, dev, elem_bytes=es)
                err = 0.0
                for reverse in (False, True):
                    into = torch.full((STEREO_T, n, H), float("nan"), dtype=dtype, device=dev)
                    lstm._launch(symbol, xproj, lstm.slice_w_hh(w, plan.cluster, plan.units),
                                 into, reverse, plan)
                    out = lstm.lstm_scan_time_major(xproj, w, reverse=reverse)
                    ref = lstm.lstm_scan_plain(xproj, w, reverse=reverse).float()
                    torch.cuda.synchronize()
                    # NaN where a position was not written
                    e = max((into.float() - ref).abs().max().item(),
                            (out.float() - ref).abs().max().item())
                    if not e <= tol:
                        raise AssertionError(f"{name} at the stereo shape T={STEREO_T} N={n} "
                                             f"reverse={reverse}: max abs error {e} > {tol}")
                    err = max(err, e)
                cudnn = torch.nn.LSTM(H, H, device=dev, dtype=dtype)
                cudnn.flatten_parameters()
                x_in = torch.randn(STEREO_T, n, H, generator=gen, device=dev).to(dtype)
                ms = time_ms(lambda: lstm.lstm_scan_time_major(xproj, w, reverse=True), 5)
                with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                    lib_ms = time_ms(lambda: cudnn(x_in), 5)
                plain_ms = time_ms(lambda: lstm.lstm_scan_plain(xproj, w, reverse=True), 1)
                b_ms, b_by = bound_ms(2.0 * STEREO_T * n * H * g4, peak,
                                      es * (STEREO_T * n * g4 + H * g4 + STEREO_T * n * H))
                keys.update({f"stereo_n{n}_{key}": v for key, v in dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    max_abs_err=err, us_per_step=ms / STEREO_T * 1e3,
                    split=plan._asdict()).items()})
                print(f"{name} at the stereo shape T={STEREO_T} N={n} H={H}, both directions, "
                      f"into NaN-filled outputs: max abs error {err:.3g} (limit {tol}); kernel "
                      f"{ms:.3f} ms ({ms / STEREO_T * 1e3:.3f} us a step), plain {plain_ms:.3f} "
                      f"ms, bound {b_ms:.4f} ms ({b_by}), cuDNN nn.LSTM {lib_ms:.3f} ms; split "
                      f"{plan} [{card}]", flush=True)
                del xproj, into, out, ref, cudnn, x_in
            row(name).update(keys)

        w_ih = (torch.rand(g4, H, generator=gen, device=dev) * 2 - 1) / H**0.5
        wq, ws = int8_matmul.quantize_weight_rows(w_ih)
        wq_t = wq.t()
        bias = torch.randn(g4, generator=gen, device=dev) * 0.1
        keys = {}
        for m in STEREO_K2_ROWS:
            x = torch.randn(m, H, generator=gen, device=dev).bfloat16()
            out = int8_matmul.w8a8_matmul_fq(x, wq_t, ws, bias)
            into = int8_matmul._fq_launch(x, wq_t, ws, bias, torch.bfloat16,
                                          out=torch.full((m, g4), float("nan"), device=dev,
                                                         dtype=torch.bfloat16))
            ref = int8_matmul.w8a8_matmul_fq_plain(x, wq_t, ws, bias)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref) and torch.equal(into, ref)):
                raise AssertionError(f"w8a8_matmul_fq at the stereo rows M={m}: "
                                     f"{(out != ref).sum().item()} outputs differ from the plain "
                                     f"version's (or a position was not written)")

            def int_mm_path():
                xf = x.float()
                s = xf.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) * (1.0 / 127.0)
                xq = torch.round(xf * torch.reciprocal(s)).to(torch.int8)
                return (torch._int_mm(xq, wq_t).float() * s * ws + bias).to(torch.bfloat16)

            ms = time_ms(lambda: int8_matmul.w8a8_matmul_fq(x, wq_t, ws, bias), 10)
            plain_ms = time_ms(lambda: int8_matmul.w8a8_matmul_fq_plain(x, wq_t, ws, bias), 2)
            lib_ms = time_ms(int_mm_path, 5)
            b_ms, b_by = bound_ms(2.0 * m * H * g4, PEAK_INT8,
                                  2 * m * H + H * g4 + 8 * g4 + 2 * m * g4)
            keys.update({f"stereo_m{m}_{key}": v for key, v in dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms).items()})
            print(f"w8a8_matmul_fq at the stereo rows M={m} K={H} O={g4}: bit for bit, every "
                  f"position written; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}), torch._int_mm route {lib_ms:.4f} ms [{card}]",
                  flush=True)
            del x, out, into, ref
        row("w8a8_matmul_fq").update(keys)
    torch.cuda.empty_cache()


class _Records:
    """A writer that keeps the records."""

    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


def stereo_model(torch):
    """(config, model) of the stereo preset at full width: random weights
    from the seed, the CRF head's weights at HEAD_GAIN and its bias drawn."""
    from dorado_tpu_torch.models.crf_model import init_lstm_crf_params
    from dorado_tpu_torch.models.presets import stereo_config

    cfg = stereo_config()
    cfg.normalise_basecaller_params()
    model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.linear1_w.mul_(HEAD_GAIN)
        model.linear1_b.copy_(torch.randn(cfg.outsize,
                                          generator=torch.Generator().manual_seed(SEED + 2)))
    return cfg, model


def check_duplex_output(path, records, reads, stats, mods=False) -> list:
    """Every read written (its record or its subreads'), the duplex records
    first, each named ``t;c`` with a qstring of its length and ``dx`` 1, the
    simplex records' ``dx`` -1 on each parent and 0 on the rest; with
    ``mods``, each duplex MM with '+' channels on C and '-' on G and an ML
    value for each of its calls. Returns the duplex records."""
    duplex = [r for r in records if ";" in r.qname]
    simplex = records[len(duplex):]
    if any(";" in r.qname for r in simplex) or not duplex:
        raise AssertionError(f"{path}: the duplex records are not written first, or none")
    parents = {name for r in duplex for name in r.qname.split(";")}
    tags = [{t.tag: t.value for t in r.tags} for r in records]
    read_of = {t.get("pi") or r.qname for r, t in zip(simplex, tags[len(duplex):])}
    if read_of != {r.read_id for r in reads} or len(simplex) != stats.simplex_reads:
        raise AssertionError(f"{path}: records of {len(read_of)} of {len(reads)} reads written")
    for r, t in zip(records, tags):
        want = 1 if ";" in r.qname else -1 if r.qname in parents else 0
        if t["dx"] != want or len(r.seq) != len(r.qual) or not r.seq:
            raise AssertionError(f"{path}: {r.qname} has dx {t['dx']} (want {want}) or a "
                                 f"qstring of another length")
    if not parents <= {r.qname for r in simplex}:
        raise AssertionError(f"{path}: a duplex record names a read with no simplex record")
    if mods:
        for r, t in zip(duplex, tags):
            calls = sum(len(part.split(",")) - 1 for part in t["MM"].split(";"))
            if ("C+h?" not in t["MM"] or "G-m?" not in t["MM"] or len(t["ML"]) != calls
                    or t["MN"] != len(r.seq)):
                raise AssertionError(f"{path}: {r.qname}'s MM/ML/MN are not both strands' "
                                     f"({t['MM'][:60]}, {len(t['ML'])} ML values)")
    return duplex


def duplex_phase(k, cfg, model, mod_dir) -> None:
    """Duplex calling at full width (``DuplexPipeline.run_reads`` over the
    channel-ordered reads of the duplex fixture, pairs forced with
    ``ForcedPairer``): hac v4.3 and the stereo preset, W8A8, in bf16 with
    the Viterbi and the beam decoder, in float32 (Viterbi), and with the
    5mCG_5hmCG@v3 model (``mod_dir``); each run's launches held against its
    simplex and stereo batches, its records checked (``check_duplex_output``);
    the real pairer's verdicts on the same candidates printed; the stereo
    model's scores against the CPU's float32 model and its decodes against
    the CPU's; one profiled stereo step of each kind; the host ms a pair of
    the pair alignment and the stereo features beside the pair's stereo
    device ms. Then the command line (``duplex_cli``)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    torch, dev = k.torch, k.dev
    crf_cuda, beam = k.crf_cuda, k.beam
    from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
    from dorado_tpu_torch.duplex import DuplexPairer, DuplexPipeline, check_pair
    from dorado_tpu_torch.duplex.pairing import PairingResult
    from dorado_tpu_torch.duplex.stereo import StereoFeatureInputs, generate_stereo_features
    from dorado_tpu_torch.io.pod5 import iter_reads
    from dorado_tpu_torch.modbase.caller import ModBaseCaller
    from dorado_tpu_torch.modbase.config import load_modbase_config
    from dorado_tpu_torch.utils.align import align
    from dorado_tpu_torch.utils.sequence import mean_qscore_from_qstring, reverse_complement
    from tests.torch_duplex import DUPLEX_FIXTURE_PAIRS, ForcedPairer

    scfg, smodel = stereo_model(torch)
    reads = list(iter_reads([DUPLEX_FIXTURE], by_channel=True))
    p = dict(batch_size=N)
    pipes = {
        "duplex viterbi": DuplexPipeline(cfg, model, scfg, smodel, **p),
        "duplex beam": DuplexPipeline(cfg, model, scfg, smodel, decoder="beam", **p),
        "duplex f32": DuplexPipeline(cfg, model, scfg, smodel, compute_dtype=torch.float32, **p),
        "duplex modbase": DuplexPipeline(
            cfg, model, scfg, smodel, modbase_caller=ModBaseCaller(
                [load_modbase_config(mod_dir)], canonical_stride=cfg.stride), **p),
    }
    for pipe in pipes.values():
        sr = pipe.stereo_runner
        if (sr.batch_size != STEREO_ROWS or sr.chunk_size // scfg.stride != STEREO_T
                or not all(hasattr(layer, "w_ih_q") for layer in sr.model.lstms)
                or sr.model.linear1_b is None):
            raise AssertionError("the stereo runner is not the W8A8 stereo preset at 32 rows of "
                                 "T = 2000 with its head's bias")
    print(f"duplex fixture {DUPLEX_FIXTURE.name}: {len(reads)} reads, "
          f"{sum(len(r.signal) for r in reads)} samples", flush=True)
    pairer = None
    for path, pipe in pipes.items():
        pipe.pairer = ForcedPairer(PairingResult)
        for w in k.wrappers.values():
            w.launches = 0
        simplex_chunks = pipe.simplex.runner.stats.chunks_called
        stereo_before = pipe.stereo_runner.stats
        written = _Records()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = pipe.run_reads(reads, written)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        stereo_after = pipe.stereo_runner.stats
        simplex_batches = pipe.simplex.stats.batches
        stereo_batches = stereo_after[0] - stereo_before[0]
        simplex_chunks = pipe.simplex.runner.stats.chunks_called - simplex_chunks
        k.launches[path] = {name: w.launches for name, w in k.wrappers.items()}
        k.check_launches(path, k.launches[path], simplex_batches + stereo_batches)
        duplex = check_duplex_output(path, written.records, reads, stats,
                                     mods=path == "duplex modbase")
        # a full simplex batch and a partial one: the run ends on the latter
        if not (simplex_chunks > N and simplex_chunks < simplex_batches * N):
            raise AssertionError(f"{path}: {simplex_chunks} simplex chunks in {simplex_batches} "
                                 f"batches: no full batch, or no partial one")
        if stats.pairs != DUPLEX_FIXTURE_PAIRS or stats.duplex_reads != stats.pairs:
            raise AssertionError(f"{path}: {stats.pairs} pairs, {stats.duplex_reads} duplex reads")
        print(f"{path}: {len(reads)} reads in {simplex_batches} simplex batches ({simplex_chunks} "
              f"chunks, the last partial) and {stats.pairs} forced pairs in {stereo_batches} "
              f"stereo batches ({stereo_after[1] - stereo_before[1]} chunks of T = {STEREO_T}) "
              f"in {elapsed:.3f} s [{k.card}]: {len(duplex)} duplex records "
              f"({sum(len(r.seq) for r in duplex)} bases); host a pair: alignment "
              f"{stats.pair_align_s / stats.pairs * 1e3:.2f} ms, stereo features "
              f"{stats.stereo_features_s / stats.pairs * 1e3:.2f} ms; stereo calls (wall) "
              f"{stats.stereo_call_s / stats.pairs * 1e3:.2f} ms a pair; launches "
              f"{ {n: v for n, v in k.launches[path].items() if v} }", flush=True)
        if path == "duplex viterbi":
            pairer = pipe.pairer

    # the real pairer over the same candidates, in the same order: its gates
    # see random calls (few bases, low qscores)
    real = DuplexPairer()
    verdicts = [real.push(c) is not None for c in pairer.pushed]
    forced = ForcedPairer(PairingResult)
    pairs = [pr for pr in (forced.push(c) for c in pairer.pushed) if pr is not None]
    gates = [(len(pr.template.seq), len(pr.complement.seq),
              round(min(mean_qscore_from_qstring(pr.template.qstring),
                        mean_qscore_from_qstring(pr.complement.qstring)), 2),
              pr.complement.start_time_ms - pr.template.end_time_ms) for pr in pairs]
    print(f"DuplexPairer over the {len(pairer.pushed)} candidates: {sum(verdicts)} pairs; "
          f"check_pair on the {len(pairs)} forced pairs: "
          f"{[check_pair(pr.template, pr.complement) is not None for pr in pairs]}; their "
          f"(template bases, complement bases, lower mean qscore, gap ms): {gates}", flush=True)

    # the stereo model on the card against the CPU's float32 model, on a
    # chunk of each of two pairs' features; a pair's host and device times
    vit, bm, f32 = pipes["duplex viterbi"], pipes["duplex beam"], pipes["duplex f32"]
    chunks = []
    for pr in pairs[:2]:
        t, c = pr.template, pr.complement
        rc = reverse_complement(c.seq)
        t0 = time.perf_counter()
        ops = align(t.seq, rc).ops
        t1 = time.perf_counter()
        feats = generate_stereo_features(StereoFeatureInputs(
            alignment=ops, template_seq=t.seq, template_qstring=t.qstring,
            template_moves=t.moves, template_signal=t.signal, complement_seq=rc,
            complement_qstring=c.qstring, complement_moves=c.moves,
            complement_signal=np.ascontiguousarray(c.signal[::-1]),
            signal_stride=cfg.stride)).T
        t2 = time.perf_counter()
        chunks.append(feats[: vit.stereo_runner.chunk_size])
        vit._call_stereo(pr)  # the per-shape set-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t3 = time.perf_counter()
            vit._call_stereo(pr)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t3
        device = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        print(f"pair {t.read_id[:8]};{c.read_id[:8]} ({len(t.seq)} and {len(c.seq)} bases, "
              f"{len(feats)} stereo samples): host alignment {(t1 - t0) * 1e3:.2f} ms, stereo "
              f"features {(t2 - t1) * 1e3:.2f} ms; its stereo call {wall * 1e3:.2f} ms wall, "
              f"{device:.2f} ms on the device [{k.card}]", flush=True)
    sig = np.stack(chunks).astype(np.float16)
    cpu = TorchBasecallRunner(scfg, smodel, device="cpu", lstm_precision="w8a8",
                              batch_size=STEREO_ROWS)
    hold_scores_and_decode(k, "stereo bf16", vit.stereo_runner, cpu, sig,
                           MAX_STEREO_BF16_MEAN_ERR)
    hold_scores_and_decode(k, "stereo f32", f32.stereo_runner, cpu, sig, MAX_F32_SCORE_REL)
    with torch.inference_mode():
        scores = bm.stereo_runner.model(torch.from_numpy(sig).to(dev)).contiguous()
        back_guide = crf_cuda.backward_scores(scores, STAY)
        st_k, mv_k = beam.beam_search_device(scores, back_guide, W, BEAM_CUT, STAY)
        st_c, mv_c = beam.beam_search_plain(scores.cpu(), back_guide.cpu(), W, BEAM_CUT, STAY)
    per_row = ((st_k.cpu() != st_c) | (mv_k.cpu() != mv_c)).sum(dim=1).tolist()
    print(f"stereo beam on the card vs the CPU's plain beam, the card's back guide on both: "
          f"differing steps by row {per_row} of {STEREO_T}; {int(mv_k.sum().item())} moves",
          flush=True)
    if (sum(c > 0 for c in per_row) > BEAM_MAX_ROWS_DIFFERENT
            or max(per_row) > BEAM_MAX_ROW_SHARE_DIFFERENT * STEREO_T
            or int(mv_k.sum().item()) == 0):
        raise AssertionError("stereo beam: far from the CPU's plain beam on the same back guide")

    # one stereo device step of each kind at a full stereo batch, profiled, its
    # launches those of one batch
    for path, pipe in (("stereo viterbi", vit), ("stereo beam", bm), ("stereo f32", f32)):
        for w in k.wrappers.values():
            w.launches = 0
        profiled_step(k, path, pipe.stereo_runner)
        torch.cuda.synchronize()
        k.launches[path] = {name: w.launches for name, w in k.wrappers.items()}
        k.check_launches(path, k.launches[path], 2)  # the set-up call and the profiled one
    del pipes, vit, bm, f32, cpu, scores, back_guide
    torch.cuda.empty_cache()
    duplex_cli(k, cfg, model, scfg, smodel)


def duplex_cli(k, cfg, model, scfg, smodel) -> None:
    """``dorado_tpu_torch duplex`` on the duplex fixture with model
    directories the port writes: in this process with pairs forced (its
    launches held), whose SAM must equal ``DuplexPipeline.run``'s with the
    same options and header; ``python -m dorado_tpu_torch duplex ...
    --emit-sam`` in a subprocess, whose SAM must equal the in-process run's
    with the real pairer but for @PG; and ``duplex basespace --pairs`` on the
    forced run's SAM with its pairs."""
    import shlex

    torch = k.torch
    import dorado_tpu_torch.duplex.pipeline as duplex_pipeline
    from dorado_tpu_torch.cli.main import main as cli_main
    from dorado_tpu_torch.duplex import DuplexPipeline
    from dorado_tpu_torch.duplex.pairing import PairingResult
    from dorado_tpu_torch.io.sam import SamWriter
    from dorado_tpu_torch.models.load import build_model, load_model, save_model
    from tests.torch_duplex import ForcedPairer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_duplex_") as tmp:
        tmp = Path(tmp)
        hac_dir = save_model(cfg, model, tmp / cfg.model_name)
        stereo_dir = save_model(scfg, smodel, tmp / scfg.model_name)
        loaded = [build_model(*load_model(d)) for d in (hac_dir, stereo_dir)]

        def in_process(argv, forced):
            """``DuplexPipeline.run`` with the command's models, options and
            header: its SAM text."""
            pipe = DuplexPipeline(load_model(hac_dir)[0], loaded[0], load_model(stereo_dir)[0],
                                  loaded[1])
            if forced:
                pipe.pairer = ForcedPairer(PairingResult)
            out = io.StringIO()
            writer = SamWriter(out, pipe.simplex.build_header(
                [DUPLEX_FIXTURE], cli_line=shlex.join(["dorado_tpu_torch", *argv])))
            pipe.run(DUPLEX_FIXTURE, writer)
            writer.close()
            return out.getvalue()

        sam = tmp / "duplex.sam"
        argv = ["duplex", str(hac_dir), str(DUPLEX_FIXTURE), "--stereo-model", str(stereo_dir),
                "--emit-sam"]
        real_pairer = duplex_pipeline.DuplexPairer
        duplex_pipeline.DuplexPairer = lambda: ForcedPairer(PairingResult)
        try:
            for w in k.wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            rc = cli_main([*argv, "-o", str(sam)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            duplex_pipeline.DuplexPairer = real_pairer
        k.launches["cli duplex"] = {name: w.launches for name, w in k.wrappers.items()}
        k.check_launches("cli duplex", k.launches["cli duplex"], 1)
        got = sam.read_text()
        want = in_process([*argv, "-o", str(sam)], forced=True)
        if rc != 0 or got != want:
            print("\n".join(difflib.unified_diff(got.splitlines(), want.splitlines(), n=0,
                                                 lineterm=""))[:3000], flush=True)
            raise AssertionError(f"cli duplex: exit code {rc}, or its SAM differs from "
                                 f"DuplexPipeline.run's (the diff above)")
        duplex = [l.split("\t")[0] for l in got.splitlines() if ";" in l.split("\t")[0]]
        print(f"cli duplex (in process, pairs forced): {wall:.2f} s, {len(duplex)} duplex "
              f"records, the SAM equal to DuplexPipeline.run's [{k.card}]; launches "
              f"{ {n: v for n, v in k.launches['cli duplex'].items() if v} }", flush=True)

        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "dorado_tpu_torch", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0

        def body(text):
            return [l for l in text.splitlines() if not l.startswith("@PG")]

        want = in_process(argv, forced=False)
        if res.returncode != 0 or body(res.stdout) != body(want) or not body(want):
            raise AssertionError(f"python -m dorado_tpu_torch duplex: exit code "
                                 f"{res.returncode}, or its SAM differs from the in-process "
                                 f"run's but for @PG: {res.stderr[-2000:]}")
        print(f"python -m dorado_tpu_torch duplex (the real pairer): {wall:.2f} s, "
              f"{len(body(want))} lines equal to DuplexPipeline.run's but for @PG; "
              f"{[l for l in res.stderr.splitlines() if l.startswith('> ')]}", flush=True)

        pairs = tmp / "pairs.txt"
        pairs.write_text("".join(name.replace(";", " ") + "\n" for name in duplex))
        out = tmp / "basespace.sam"
        rc = cli_main(["duplex", "basespace", str(sam), "--pairs", str(pairs), "--emit-sam",
                       "-o", str(out)])
        records = [l for l in out.read_text().splitlines() if not l.startswith("@")]
        if rc != 0:
            raise AssertionError(f"duplex basespace: exit code {rc}")
        print(f"cli duplex basespace on the forced pairs: {len(records)} consensus records of "
              f"{len(duplex)} pairs (random calls of a pair rarely overlap)", flush=True)


# ---- draft polishing: the mapper, the features, the two polish models -------

# a seeded 30 kb draft and 200 reads of 8-12 kb from both strands (67x; 300
# until the correct phase came: the script's time), at 8% errors
# (substitutions, deletions and insertions in equal parts); windows of
# 10,000 columns overlapping by 1,000, the read matrix's 100 rows (the JAX
# command's defaults)
POLISH_DRAFT = 30_000
POLISH_READS = 200
POLISH_READ_LEN = (8_000, 12_001)
POLISH_ERROR = 0.08
POLISH_WINDOW, POLISH_OVERLAP = 10_000, 1_000
# the polish models' float32 logits, card against CPU: max abs difference
# (both compute in float32, TF32 off; the sums' order differs); a column
# whose argmax differs must have its top two CPU logits within twice this
TOL_POLISH_LOGITS = 1e-3


class _CachedFeatures:
    """The polish pipeline's host features (``build_pileup``,
    ``build_read_matrix``) computed once a window for the phase's one read
    set and handed to every later pipeline over the same windows, each
    computation timed: the CPU pipelines, whose host work is the card's."""

    def __init__(self):
        import dorado_tpu_torch.secondary.polish as polish_mod
        import dorado_tpu_torch.secondary.read_matrix as matrix_mod

        self.mods = (polish_mod, matrix_mod)
        self.real = (polish_mod.build_pileup, matrix_mod.build_read_matrix)
        self.cache, self.seconds = {}, {"pileup": [], "read_matrix": []}

    def _cached(self, kind, real):
        def fn(reads, start, end, *args, **kwargs):
            key = (kind, start, end, tuple(sorted((k, repr(v)) for k, v in kwargs.items())))
            if key not in self.cache:
                t0 = time.perf_counter()
                self.cache[key] = real(reads, start, end, *args, **kwargs)
                self.seconds[kind].append(time.perf_counter() - t0)
            return self.cache[key]
        return fn

    def __enter__(self):
        self.mods[0].build_pileup = self._cached("pileup", self.real[0])
        self.mods[1].build_read_matrix = self._cached("read_matrix", self.real[1])
        return self

    def __exit__(self, *exc):
        self.mods[0].build_pileup, self.mods[1].build_read_matrix = self.real


def polish_phase(k) -> None:
    """Draft polishing at full width on the card: the port's mapper aligns
    200 FASTQ reads to a 30 kb draft (the command's ``_collect_alignments``);
    ``PolishPipeline`` (windows of 10,000 overlapping by 1,000) runs the
    counts GRUModel (``presets.polish_gru_config``: gru 128, 2 bidirectional
    layers, cuDNN) and the read-level LatentSpaceLSTM
    (``presets.polish_rl_config``: 128 channels, kernels 1 and 17, LSTM 128,
    100 reads a column; its four LSTM directions a window on K1 float32),
    random weights from the seed, on the card; the counts pipeline on the
    CPU over the same windows, the read-level pipeline's forward on the CPU
    on the longest window: logits within TOL_POLISH_LOGITS, argmax equal but
    at near ties (counted), the counts sequences equal but at near-tie
    columns. Launches: 4 of K1 float32 a read-level
    window, none of any hand-written kernel on the counts path. K1 float32
    at a window's shape (T = its columns, N = 1, H = 128), both directions
    into NaN-filled outputs, timed beside its bound, its plain version and
    cuDNN (``polish_*`` keys of its row). Each window's host features
    (pileup, read matrix) beside its device forward (CUDA events, the
    profiler's device time by kernel). Last ``python -m dorado_tpu_torch
    polish reads.fastq draft.fa -m <gru dir>``, whose FASTA must equal
    ``run()``'s."""
    import argparse

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    torch, dev, gen, lstm, time_ms = k.torch, k.dev, k.gen, k.lstm, k.time_ms
    from dorado_tpu_torch.cli.main import _collect_alignments
    from dorado_tpu_torch.models import presets
    from dorado_tpu_torch.secondary.architectures import model_factory
    from dorado_tpu_torch.secondary.polish import PolishPipeline
    from tests.torch_polish import polish_inputs, write_fasta, write_fastq

    t_phase = time.perf_counter()
    draft, truth, reads = polish_inputs(SEED, POLISH_DRAFT, POLISH_READS, POLISH_READ_LEN,
                                        error=POLISH_ERROR)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_polish_"))
    fasta = write_fasta(tmp / "draft.fa", [("ctg", draft)])
    fastq = write_fastq(tmp / "reads.fastq", reads)
    t0 = time.perf_counter()
    by_contig = _collect_alignments(argparse.Namespace(
        reads=str(fastq), draft=str(fasta), min_mapq=0, threads=0))
    map_s = time.perf_counter() - t0
    aligned = by_contig.get("ctg", [])
    if len(aligned) < 0.95 * POLISH_READS:
        raise AssertionError(f"polish: the mapper aligned {len(aligned)} of {POLISH_READS} reads")
    print(f"polish inputs: a {len(draft)} b draft, {POLISH_READS} reads of {POLISH_READ_LEN} b at "
          f"{POLISH_ERROR:.0%} errors, {sum(len(r[1]) for r in reads) / len(draft):.1f}x; the "
          f"port's mapper aligned {len(aligned)} on {os.cpu_count()} threads in {map_s:.2f} s "
          f"({map_s / POLISH_READS * 1e3:.1f} ms a read) [host of {k.card}]", flush=True)

    gcfg, rcfg = presets.polish_gru_config(), presets.polish_rl_config()
    g = torch.Generator().manual_seed(SEED)
    models = {"counts": model_factory("GRUModel", gcfg["model"]["kwargs"], g),
              "rl": model_factory("LatentSpaceLSTM", rcfg["model"]["kwargs"], g)}
    with torch.no_grad():
        # the gap class's bias lowered, so that the random GRU emits bases;
        # the batch norms away from their identity
        models["counts"].linear.bias[0] = -1.0
        for block in models["rl"].read_level_conv:
            c = block.bn.weight.shape[0]
            block.bn.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
            block.bn.bias.copy_(0.1 * torch.randn(c, generator=g))
            block.bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            block.bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    gru_dir = presets.save_polish_model(gcfg, models["counts"], tmp / presets.POLISH_GRU_NAME)
    feature_opts = {"include_dwells": False, "include_haplotags": False,
                    "include_snp_qv": False, "hap_source": "unphased", "max_reads": 100}
    kinds = {"counts": ("counts", {}), "rl": ("read_level", feature_opts)}

    def pipeline(name, device):
        kind, opts = kinds[name]
        return PolishPipeline(copy.deepcopy(models[name]), window_len=POLISH_WINDOW,
                              window_overlap=POLISH_OVERLAP, feature_kind=kind,
                              feature_opts=opts, device=device)

    def run(name, device):
        """(polished [(name, seq)], [(feats, logits, forward ms by CUDA
        events or None)] a window, the pipeline)."""
        pipe = pipeline(name, device)
        windows = []
        real = pipe.forward

        def forward(feats):
            if device is not dev:  # the CPU's run
                out = real(feats)
                windows.append((feats, out, None))
                return out
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = real(feats)
            end.record()
            end.synchronize()
            windows.append((feats, out, start.elapsed_time(end)))
            return out

        pipe.forward = forward
        return pipe.run(fasta, by_contig, with_quals=True), windows, pipe

    results = {}
    with _CachedFeatures() as cached:
        for name in ("counts", "rl"):
            path = f"polish {name}"
            for w in k.wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            got, windows, pipe = run(name, dev)
            wall = time.perf_counter() - t0
            k.launches[path] = {n: w.launches for n, w in k.wrappers.items()}
            k.check_launches(path, k.launches[path], len(windows))
            t0 = time.perf_counter()
            if name == "counts":
                # the whole pipeline on the CPU, over the same windows; the
                # GRU's many small steps run fastest on one thread
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                want, cpu_windows, _ = run(name, "cpu")
                torch.set_num_threads(threads)
                held = list(range(len(windows)))
            else:
                # the read-level model on the CPU takes about a second for
                # 1,000 columns (its plain LSTM's steps): the CPU pipeline's
                # forward is held on the longest window's features only; the
                # launch counts and K1's own check below cover every window
                longest = max(range(len(windows)), key=lambda i: windows[i][0].shape[1])
                feats = windows[longest][0]
                want, held = None, [longest]
                cpu_windows = [(feats, pipeline(name, "cpu").forward(feats), None)]
            cpu_wall = time.perf_counter() - t0
            results[name] = (got, windows, pipe, want, cpu_windows, held, wall, cpu_wall)
        feature_s = {kind: list(v) for kind, v in cached.seconds.items()}

    for name, (got, windows, pipe, want, cpu_windows, held, wall, cpu_wall) in results.items():
        if len(held) != len(cpu_windows) or not windows:
            raise AssertionError(f"polish {name}: {len(windows)} windows on the card, "
                                 f"{len(cpu_windows)} on the CPU")
        err, flips, near = 0.0, 0, 0
        for (feats, lg, _), (cfeats, lc, _) in zip([windows[i] for i in held], cpu_windows):
            if (feats.shape != cfeats.shape or lg.shape != lc.shape
                    or not np.isfinite(lg).all()):
                raise AssertionError(f"polish {name}: window shapes {feats.shape} / "
                                     f"{cfeats.shape} or logits not finite")
            err = max(err, float(np.abs(lg - lc).max()))
            differ = lg.argmax(-1) != lc.argmax(-1)
            top2 = np.sort(lc, axis=-1)[:, -2:]
            flips += int(differ.sum())
            near += int((differ & (top2[:, 1] - top2[:, 0] <= 2 * TOL_POLISH_LOGITS)).sum())
        seq_g = got[0][1][0]
        if want is None:
            same = f"the CPU pipeline's forward on window {held[0]} only"
        else:
            seq_c = want[0][1][0]
            diff_cols = sum(a != b for a, b in zip(seq_g, seq_c)) + abs(len(seq_g) - len(seq_c))
            same = "sequences " + ("equal" if seq_g == seq_c else f"differ at {diff_cols} columns")
            if seq_g != seq_c and flips == 0:
                raise AssertionError(f"polish {name}: the sequences differ with no argmax flip")
        print(f"polish {name}: {len(windows)} windows of {[f.shape[1] for f, _, _ in windows]} "
              f"columns; card against CPU over windows {held}: logits max abs difference "
              f"{err:.3g} (limit {TOL_POLISH_LOGITS}), argmax differs at {flips} columns ({near} "
              f"of them near ties), {same}; {len(seq_g)} b polished (draft {len(draft)}, truth "
              f"{len(truth)}); run on the card {wall:.2f} s, on the CPU {cpu_wall:.2f} s (host "
              f"features cached); launches "
              f"{ {n: v for n, v in k.launches[f'polish {name}'].items() if v} } [{k.card}]",
              flush=True)
        if not err <= TOL_POLISH_LOGITS or flips != near:
            raise AssertionError(f"polish {name}: the card's logits are {err} from the CPU's "
                                 f"(limit {TOL_POLISH_LOGITS}), or {flips - near} argmax flips "
                                 f"away from a near tie")
        if not seq_g or got[0][1][1] is None or len(got[0][1][1]) != len(seq_g):
            raise AssertionError(f"polish {name}: empty sequence or qualities of another length")

    # ---- the time split of a window ------------------------------------------
    pile_s, matrix_s = feature_s["pileup"], feature_s["read_matrix"]
    for name, (got, windows, pipe, *_rest) in results.items():
        fwd = [ms for _, _, ms in windows]
        print(f"polish {name} a window: host features {np.mean(pile_s):.3f} s pileup"
              + (f" + {np.mean(matrix_s):.3f} s read matrix" if name == "rl" else "")
              + f" (each window: {[round(s, 3) for s in pile_s]}"
              + (f", {[round(s, 3) for s in matrix_s]}" if name == "rl" else "")
              + f"); device forward by CUDA events {np.mean(fwd):.2f} ms "
              f"({[round(ms, 2) for ms in fwd]}), host clock incl. the copies "
              f"{pipe.stats.forward_s / len(windows) * 1e3:.2f} ms [{k.card}]", flush=True)
        shape = max((f.shape for f, _, _ in windows), key=lambda s: s[1])
        x = torch.from_numpy(np.random.RandomState(SEED).rand(*shape).astype(np.float32))
        if name == "rl":
            x = torch.from_numpy(np.random.RandomState(SEED).randint(1, 6, shape).astype(
                np.float32))
            x[..., 2] = torch.where(x[..., 2] > 3, 1.0, -1.0)
        x = x.to(dev)
        model = pipe.model
        with torch.inference_mode():
            ev_ms = time_ms(lambda: model(x), 2)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                            if e.self_device_time_total > 0), key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in by_kernel)
        # CUDA events time every forward; the profiler's sum is only what it
        # sees (in the whole script's process it has missed cuDNN's kernels)
        print(f"polish {name} forward at {tuple(shape)}: CUDA events {ev_ms:.2f} ms; "
              f"profiled: wall {wall_ms:.2f} ms, kernels seen {busy:.2f} ms [{k.card}]",
              flush=True)
        for key, ms in by_kernel[:8]:
            print(f"  {ms:9.3f} ms {ms / ev_ms:6.1%} of the events' time  {key[:90]}")
        del x

    # ---- K1 float32 at the polish shape ----------------------------------------
    h = rcfg["model"]["kwargs"]["lstm_size"]
    t_len = max(f.shape[1] for f, _, _ in results["rl"][1])
    w = (torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) / h**0.5
    xproj = torch.randn(t_len, 1, 4 * h, generator=gen, device=dev) * 0.8
    plan = lstm.k1_launch_plan(h, 1, dev, elem_bytes=4)
    err = 0.0
    for reverse in (False, True):
        into = torch.full((t_len, 1, h), float("nan"), device=dev)
        lstm._launch("lstm_scan_f32", xproj, lstm.slice_w_hh(w, plan.cluster, plan.units), into,
                     reverse, plan)
        out = lstm.lstm_scan_time_major(xproj, w, reverse=reverse)
        if reverse:
            # the plain version takes seconds at this T on the card: it runs
            # there once, timed by CUDA events
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            ref = lstm.lstm_scan_plain(xproj, w, reverse=reverse)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
        else:
            # the forward direction's plain version on the host's CPU (its
            # small steps run faster there)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            ref = lstm.lstm_scan_plain(xproj.cpu(), w.cpu(), reverse=reverse).to(dev)
            torch.set_num_threads(threads)
        e = max((into - ref).abs().max().item(), (out - ref).abs().max().item())
        if not e <= TOL_LSTM_F32:  # NaN where a position was not written
            raise AssertionError(f"lstm_scan_f32 at the polish shape T={t_len} N=1 H={h} "
                                 f"reverse={reverse}: max abs error {e} > {TOL_LSTM_F32}")
        err = max(err, e)
    cudnn = torch.nn.LSTM(h, h, device=dev)
    cudnn.flatten_parameters()
    x_in = torch.randn(t_len, 1, h, generator=gen, device=dev)
    ms = time_ms(lambda: lstm.lstm_scan_time_major(xproj, w, reverse=True), 3)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_ms = time_ms(lambda: cudnn(x_in), 3)
    ops = 2.0 * t_len * h * 4 * h
    nbytes = 4 * (t_len * 4 * h + h * 4 * h + t_len * h)
    b_ms, b_by = bound_ms(ops, PEAK_F32, nbytes)
    row = next(r for r in k.rows if r["name"] == "lstm_scan_f32")
    row.update({f"polish_{key}": v for key, v in dict(
        shape=f"T={t_len} N=1 H={h} (a read-level polish window)", ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, tf32x3_bound_ms=bound_ms(ops, PEAK_TF32 / 3, nbytes)[0],
        library_ms=lib_ms, max_abs_err=err, us_per_step=ms / t_len * 1e3,
        split=plan._asdict(),
        launches_a_window=k.launches["polish rl"]["lstm_scan_f32"] / len(results["rl"][1])
    ).items()})
    print(f"lstm_scan_f32 at the polish shape T={t_len} N=1 H={h}, both directions, into "
          f"NaN-filled outputs: max abs error {err:.3g} (limit {TOL_LSTM_F32}); kernel {ms:.3f} "
          f"ms ({ms / t_len * 1e3:.3f} us a step), plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; {row['polish_tf32x3_bound_ms']:.4f} ms on 3xTF32), cuDNN nn.LSTM float32, "
          f"TF32 off {lib_ms:.3f} ms; split {plan} [{k.smi}]", flush=True)
    del xproj, into, out, ref, cudnn, x_in

    # ---- the command line ---------------------------------------------------------
    out = tmp / "polished.fa"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dorado_tpu_torch", "polish", str(fastq),
                          str(fasta), "-m", str(gru_dir), "--window-len", str(POLISH_WINDOW),
                          "--window-overlap", str(POLISH_OVERLAP), "-o", str(out)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    want = "".join(f">{name}\n" + "".join(seq[i:i + 80] + "\n" for i in range(0, len(seq), 80))
                   for name, (seq, _) in results["counts"][0])
    if res.returncode != 0 or not out.exists() or out.read_text() != want:
        raise AssertionError(f"python -m dorado_tpu_torch polish: exit code {res.returncode}, "
                             f"or its FASTA differs from run()'s: {res.stderr[-2000:]}")
    print(f"python -m dorado_tpu_torch polish reads.fastq draft.fa -m <gru dir>: {wall:.2f} s, "
          f"its FASTA equal to run()'s; "
          f"{[l for l in res.stderr.splitlines() if l.startswith('> ')]}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"polish phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- variant calling: the slot model and the perceiver ------------------------

# the polish phase's draft length, read lengths and errors, made diploid:
# two haplotypes with seeded homozygous and heterozygous SNPs and short
# indels (``tests/torch_variant.py``), 150 reads of both (50x; a default
# window still holds 100 reads); windows of the command's defaults (10,000
# and margins of 1,000)
VARIANT_READS = 150
VARIANT_WINDOW = 10_000
# the perceiver's one full default window: draft [10,000, 20,000) with its
# margins, [9,000, 21,000)
VARIANT_PERCEIVER_SPAN = (10_000, 20_000)
# card against CPU, reduced regions ([lo, hi) of the draft, one window each):
# the CPU's perceiver over every token of a window takes a while
VARIANT_CPU_REGIONS = {"slot": (12_000, 14_000), "perceiver": (15_000, 15_500)}
# the variant models' outputs, card against CPU: the polish bound; a column
# whose argmax differs must have its top two CPU values within twice this
TOL_VARIANT = 1e-3


def variant_phase(k) -> None:
    """Variant calling at full width on the card: the port's mapper aligns
    150 reads of two haplotypes of the polish phase's draft (30 kb, 162
    seeded sites); ``VariantCaller`` runs the slot preset with its LSTMs
    (``presets.slot_attention_config(add_lstm=True)``: 2 slots, read
    embedding 128, kernels 1 and 17, haplotags computed; four K1 float32
    launches a window at H = 256) over the whole draft (path ``variant
    slot``), and the perceiver preset (dimension 256, 4 blocks of 8 heads,
    the decoder LSTM on K1 float32, the reads updated) over one full default
    window (path ``variant perceiver``): its time by CUDA events, its peak
    memory, the memory-efficient attention backend shown by the profiler.
    Both again on the card and on the CPU over a reduced region each:
    outputs within TOL_VARIANT (NaN at the same places), records equal but
    at near ties (counted). K1 float32 at the slot window's shape (T = its
    columns, N = 1, H = 256), both directions into NaN-filled outputs,
    beside its bound, the plain version and cuDNN (``variant_*`` keys of its
    row); the phasing pass's host time beside the device forward. Beside
    the comparisons (host work; the timings wait for it to end), ``python -m
    dorado_tpu_torch variant reads.fastq draft.fa --model-config <slot.toml>
    -o <dir>``, whose ``variants.vcf`` must equal the function's."""
    import argparse

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import dorado_tpu_torch.secondary.architectures as arch
    from dorado_tpu_torch.cli.main import _collect_alignments, _feature_opts
    from dorado_tpu_torch.models import presets
    from dorado_tpu_torch.secondary.variant import VcfWriter
    from dorado_tpu_torch.secondary.variant_calling import VariantCaller, _ref_end
    from tests.torch_polish import write_fasta, write_fastq
    from tests.torch_variant import diploid_inputs

    torch, dev, gen, lstm, time_ms = k.torch, k.dev, k.gen, k.lstm, k.time_ms
    t_phase = time.perf_counter()
    draft, _, sites, reads = diploid_inputs(SEED, POLISH_DRAFT, VARIANT_READS, POLISH_READ_LEN,
                                            error=POLISH_ERROR)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_variant_"))
    fasta = write_fasta(tmp / "draft.fa", [("ctg", draft)])
    fastq = write_fastq(tmp / "reads.fastq", [r[:3] for r in reads])
    t0 = time.perf_counter()
    by_contig = _collect_alignments(argparse.Namespace(
        reads=str(fastq), draft=str(fasta), min_mapq=0, threads=0))
    map_s = time.perf_counter() - t0
    aligned = by_contig.get("ctg", [])
    if len(aligned) < 0.95 * VARIANT_READS:
        raise AssertionError(f"variant: the mapper aligned {len(aligned)} of {VARIANT_READS}")
    print(f"variant inputs: a {len(draft)} b draft, {len(sites)} sites "
          f"({sum(s[2] == 'hom' for s in sites)} homozygous), {VARIANT_READS} reads of "
          f"{POLISH_READ_LEN} b of both haplotypes at {POLISH_ERROR:.0%} errors; mapped "
          f"{len(aligned)} in {map_s:.2f} s [host of {k.card}]", flush=True)

    configs = {"slot": presets.slot_attention_config(add_lstm=True),
               "perceiver": presets.variant_perceiver_config(use_decoder_lstm=True,
                                                             update_read_embeddings=True)}
    tomls = {}
    for name, cfg in configs.items():
        tomls[name] = tmp / f"{name}.toml"
        tomls[name].write_text(presets.polish_config_toml(cfg))
    # the slot model of the command's --model-config (the factory's seed 0)
    models = {"slot": arch.model_factory("SlotAttentionConsensus",
                                         configs["slot"]["model"]["kwargs"]),
              "perceiver": arch.model_factory("VariantPerceiver",
                                              configs["perceiver"]["model"]["kwargs"],
                                              torch.Generator().manual_seed(SEED))}

    def caller(name, device):
        mc = arch.parse_model_config(tomls[name])
        return VariantCaller(copy.deepcopy(models[name]), "read_level",
                             _feature_opts(mc, hap_source="compute"), device=device,
                             window_len=VARIANT_WINDOW)

    def recorded(c):
        """``c`` with its forward recorded: [(features, output, device ms by
        CUDA events or None)]."""
        windows, real = [], c.forward

        def forward(feats):
            if c.device.type != dev.type:  # the CPU's run
                out = real(feats)
                windows.append((feats, out, None))
                return out
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = real(feats)
            end.record()
            end.synchronize()
            windows.append((feats, out, start.elapsed_time(end)))
            return out

        c.forward = forward
        return windows

    phase_s = []
    real_phase = arch.batch_adjacency_phase

    def timed_phase(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_phase(*args, **kwargs)
        phase_s.append(time.perf_counter() - t0)
        return out

    arch.batch_adjacency_phase = timed_phase
    try:
        # ---- the slot model over the whole draft on the card -------------------
        slot = caller("slot", dev)
        slot_windows = recorded(slot)
        vcf = io.StringIO()
        for w in k.wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        slot.run([("ctg", draft)], by_contig, VcfWriter(vcf, [("ctg", len(draft))]))
        wall = time.perf_counter() - t0
        k.launches["variant slot"] = {n: w.launches for n, w in k.wrappers.items()}
        k.check_launches("variant slot", k.launches["variant slot"], len(slot_windows))
        st = slot.stats
        nan_windows = 0
        for feats, out, _ in slot_windows:
            # a window with a column no read covers is NaN throughout (the
            # slot attention's 0/0, spread by the LSTMs: the JAX package's)
            uncovered = bool((feats[0, :, :, 0] == 0).all(-1).any())
            nan_windows += uncovered
            if out.shape != (feats.shape[1], 2, 5) or not (
                    np.isfinite(out).all() or (uncovered and np.isnan(out).all())):
                raise AssertionError(f"variant slot: output {out.shape} for features "
                                     f"{feats.shape}, or NaN where every column is covered")
        fwd = [ms for _, _, ms in slot_windows]
        print(f"variant slot: {st.windows} windows of {[f.shape[1] for f, _, _ in slot_windows]} "
              f"columns x {[f.shape[2] for f, _, _ in slot_windows]} reads ({nan_windows} with an "
              f"uncovered column, NaN throughout), {st.records} "
              f"records in {wall:.2f} s: host features {st.features_s:.2f} s, forwards "
              f"{st.forward_s:.2f} s (of which phasing on the host {sum(phase_s):.2f} s: "
              f"{[round(s, 3) for s in phase_s]}), decode {st.decode_s:.2f} s; a forward by "
              f"CUDA events incl. the phasing {[round(ms, 1) for ms in fwd]} ms; launches "
              f"{ {n: v for n, v in k.launches['variant slot'].items() if v} } [{k.card}]",
              flush=True)
        print(f"variant slot a window: the forward by CUDA events less the host's phasing "
              f"(the device part and the copies) "
              f"{[round(ms - 1e3 * s, 1) for ms, s in zip(fwd, phase_s)]} ms [{k.card}]",
              flush=True)
        slot_vcf = vcf.getvalue()

        # ---- the command line, run beside the comparisons below ---------------------
        # (its mapping and features take the host; the card stays free for
        # the perceiver's and K1's timings, which come after it ends)
        out_dir = tmp / "vcf_out"
        out_dir.mkdir()
        cmd_log = open(tmp / "command.err", "w+")
        t_cmd = time.perf_counter()
        command = subprocess.Popen(
            [sys.executable, "-m", "dorado_tpu_torch", "variant", str(fastq), str(fasta),
             "--model-config", str(tomls["slot"]), "-o", str(out_dir)], cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=cmd_log)

        try:
            # ---- card against CPU over a reduced region each --------------------------
            for name, (r_lo, r_hi) in VARIANT_CPU_REGIONS.items():
                out = {}
                for device in (dev, "cpu"):
                    c = caller(name, device)
                    windows = recorded(c)
                    text = io.StringIO()
                    t0 = time.perf_counter()
                    c.run([("ctg", draft)], by_contig, VcfWriter(text, [("ctg", len(draft))]),
                          regions={"ctg": (r_lo, r_hi)})
                    out[str(device)] = (windows, text.getvalue(), time.perf_counter() - t0)
                (gw, gtext, gs), (cw, ctext, cs) = out[str(dev)], out["cpu"]
                if len(gw) != len(cw) or not gw:
                    raise AssertionError(f"variant {name}: {len(gw)} windows on the card, "
                                         f"{len(cw)} on the CPU")
                err, flips, near = 0.0, 0, 0
                for (_, g, _), (_, c_, _) in zip(gw, cw):
                    if g.shape != c_.shape or not np.array_equal(np.isnan(g), np.isnan(c_)):
                        raise AssertionError(f"variant {name}: shapes {g.shape} / {c_.shape} "
                                             f"or NaN at other places")
                    fin = ~np.isnan(c_)
                    err = max(err, float(np.abs(g[fin] - c_[fin]).max(initial=0.0)))
                    differ = g.argmax(-1) != c_.argmax(-1)
                    top2 = np.sort(c_, axis=-1)[..., -2:]
                    flips += int(differ.sum())
                    gap = top2[..., 1] - top2[..., 0]
                    near += int((differ & (gap <= 2 * TOL_VARIANT)).sum())
                g_rec, c_rec = body_lines(gtext), body_lines(ctext)
                diff = (sum(a != b for a, b in zip(g_rec, c_rec))
                        + abs(len(g_rec) - len(c_rec)))
                print(f"variant {name}, card against CPU over [{r_lo}, {r_hi}): "
                      f"{[w[0].shape[1:3] for w in gw]} columns x reads; outputs max abs "
                      f"difference {err:.3g} (limit {TOL_VARIANT}), argmax differs at {flips} "
                      f"(column, haplotype) pairs ({near} near ties); {len(c_rec)} records, "
                      f"{diff} differ; card {gs:.2f} s, CPU {cs:.2f} s (beside the command) "
                      f"[{k.card}]", flush=True)
                if not err <= TOL_VARIANT or flips != near or (diff and not flips):
                    raise AssertionError(f"variant {name}: card against CPU {err} (limit "
                                         f"{TOL_VARIANT}), {flips - near} flips away from a near "
                                         f"tie, or {diff} records differ with no flip")
            rc = command.wait(timeout=600)
        finally:
            if command.poll() is None:
                command.kill()
                command.wait()
        wall = time.perf_counter() - t_cmd
        cmd_log.seek(0)
        err_text = cmd_log.read()
        cmd_log.close()
        got = out_dir / "variants.vcf"
        if rc != 0 or not got.exists() or got.read_text() != slot_vcf:
            raise AssertionError(f"python -m dorado_tpu_torch variant: exit code {rc}, or its "
                                 f"VCF differs from VariantCaller.run's: {err_text[-2000:]}")
        print(f"python -m dorado_tpu_torch variant reads.fastq draft.fa --model-config "
              f"<slot.toml> -o <dir>: {wall:.2f} s (beside the comparisons above), its "
              f"variants.vcf ({len(body_lines(slot_vcf))} records) equal to VariantCaller.run's; "
              f"{[l for l in err_text.splitlines() if l.startswith('> ')]}", flush=True)

        # ---- the perceiver over one full default window on the card --------------
        per = caller("perceiver", dev)
        lo, hi = VARIANT_PERCEIVER_SPAN
        w_start, w_end = lo - per.margin, hi + per.margin
        window_reads = [r for r in aligned if r.ref_start < w_end and _ref_end(r) > w_start]
        t0 = time.perf_counter()
        pile, feats = per.features(window_reads, w_start, w_end)
        feat_s = time.perf_counter() - t0
        for w in k.wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        logits = per.forward(feats)
        end.record()
        end.synchronize()
        per_ms, per_wall = start.elapsed_time(end), time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base_bytes
        k.launches["variant perceiver"] = {n: w.launches for n, w in k.wrappers.items()}
        k.check_launches("variant perceiver", k.launches["variant perceiver"], 1)
        if logits.shape != (feats.shape[1], 2, 5) or not np.isfinite(logits).all():
            raise AssertionError(f"variant perceiver: logits {logits.shape} or not finite")
        records = [v for v in per.decode(draft, "ctg", pile, logits) if lo <= v.pos < hi]
        p, d = feats.shape[1], feats.shape[2]
        kw = configs["perceiver"]["model"]["kwargs"]
        dim, heads = kw["dimension"], kw["num_heads"]
        n_big = kw["num_blocks"] + (kw["num_blocks"] - 1)  # reads to haps, haps to reads
        flop = n_big * 4.0 * p * (p * d) * dim
        print(f"variant perceiver: one default window [{w_start}, {w_end}): {p} columns x {d} "
              f"reads ({p * d} keys, {p} queries, {heads} heads of {dim // heads}); host "
              f"features {feat_s:.2f} s; forward by CUDA events {per_ms:.1f} ms (host clock "
              f"{per_wall:.2f} s), peak memory {peak / 2**30:.2f} GiB over "
              f"{base_bytes / 2**30:.2f} GiB in use before; {n_big} big attentions, "
              f"{flop:.3g} FLOP, {flop / per_ms / 1e9:.1f} TFLOP/s over the whole forward; "
              f"{len(records)} records; launches "
              f"{ {n: v for n, v in k.launches['variant perceiver'].items() if v} } [{k.card}]",
              flush=True)
        # the attention's backend, seen by the profiler on the window's first
        # 2,000 columns (the whole window takes long under the profiler)
        x = torch.from_numpy(np.ascontiguousarray(feats[:, :2000])).to(dev)
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            per.model(x)
            torch.cuda.synchronize()
        by_kernel = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                            if e.self_device_time_total > 0), key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in by_kernel)
        attn = [(key, ms) for key, ms in by_kernel
                if "fmha_cutlass" in key or "MemEffAttention" in key]
        if not attn:
            raise AssertionError(f"variant perceiver: no attention kernel among "
                                 f"{[key for key, _ in by_kernel[:12]]}")
        print(f"variant perceiver at 2,000 columns, profiled: kernels {busy:.1f} ms, the "
              f"memory-efficient attention {sum(ms for _, ms in attn):.1f} ms "
              f"({sum(ms for _, ms in attn) / busy:.1%}) [{k.card}]", flush=True)
        for key, ms in by_kernel[:8]:
            print(f"  {ms:9.3f} ms {ms / busy:6.1%}  {key[:100]}")
        del x

    finally:
        arch.batch_adjacency_phase = real_phase

    # ---- K1 float32 at the slot window's shape -----------------------------------
    h = 2 * configs["slot"]["model"]["kwargs"]["read_embedding_size"]
    t_len = max(f.shape[1] for f, _, _ in slot_windows)
    w = (torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) / h**0.5
    xproj = torch.randn(t_len, 1, 4 * h, generator=gen, device=dev) * 0.8
    plan = lstm.k1_launch_plan(h, 1, dev, elem_bytes=4)
    err = 0.0
    for reverse in (False, True):
        into = torch.full((t_len, 1, h), float("nan"), device=dev)
        lstm._launch("lstm_scan_f32", xproj, lstm.slice_w_hh(w, plan.cluster, plan.units), into,
                     reverse, plan)
        out = lstm.lstm_scan_time_major(xproj, w, reverse=reverse)
        # the plain version on the host's CPU, one thread (its small steps
        # run faster there); the forward direction's time is reported
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        ref = lstm.lstm_scan_plain(xproj.cpu(), w.cpu(), reverse=reverse).to(dev)
        if not reverse:
            plain_ms = (time.perf_counter() - t0) * 1e3
        torch.set_num_threads(threads)
        e = max((into - ref).abs().max().item(), (out - ref).abs().max().item())
        if not e <= TOL_LSTM_F32:  # NaN where a position was not written
            raise AssertionError(f"lstm_scan_f32 at the variant shape T={t_len} N=1 H={h} "
                                 f"reverse={reverse}: max abs error {e} > {TOL_LSTM_F32}")
        err = max(err, e)
    cudnn = torch.nn.LSTM(h, h, device=dev)
    cudnn.flatten_parameters()
    x_in = torch.randn(t_len, 1, h, generator=gen, device=dev)
    ms = time_ms(lambda: lstm.lstm_scan_time_major(xproj, w, reverse=True), 3)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), torch.inference_mode():
        lib_ms = time_ms(lambda: cudnn(x_in), 3)
    ops = 2.0 * t_len * h * 4 * h
    nbytes = 4 * (t_len * 4 * h + h * 4 * h + t_len * h)
    b_ms, b_by = bound_ms(ops, PEAK_F32, nbytes)
    row = next(r for r in k.rows if r["name"] == "lstm_scan_f32")
    row.update({f"variant_{key}": v for key, v in dict(
        shape=f"T={t_len} N=1 H={h} (a slot-model variant window)", ms=ms, plain_ms=plain_ms,
        plain_where="the host's CPU, one thread, forward", bound_ms=b_ms, bound_by=b_by,
        tf32x3_bound_ms=bound_ms(ops, PEAK_TF32 / 3, nbytes)[0], library_ms=lib_ms,
        max_abs_err=err, us_per_step=ms / t_len * 1e3, split=plan._asdict(),
        launches_a_window=k.launches["variant slot"]["lstm_scan_f32"] / len(slot_windows),
        perceiver_launches_a_window=k.launches["variant perceiver"]["lstm_scan_f32"],
    ).items()})
    print(f"lstm_scan_f32 at the variant shape T={t_len} N=1 H={h}, both directions, into "
          f"NaN-filled outputs: max abs error {err:.3g} (limit {TOL_LSTM_F32}); kernel {ms:.3f} "
          f"ms ({ms / t_len * 1e3:.3f} us a step), plain (host CPU, forward) {plain_ms:.1f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; {row['variant_tf32x3_bound_ms']:.4f} ms on 3xTF32), "
          f"cuDNN nn.LSTM float32, TF32 off {lib_ms:.3f} ms; split {plan} [{k.smi}]", flush=True)
    del xproj, into, out, ref, cudnn, x_in

    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"variant phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- read correction: the HERRO-contract model at full width ----------------

# a seeded 24 kb genome and 24 reads of 8-12 kb from both strands at 8%
# errors (10x): about 70 windows of 4096 target bases (40 reads of a 40 kb
# genome took 127 s, the mapping 36 s of it: the reads were cut, not the
# widths)
CORRECT_GENOME = 24_000
CORRECT_READS = 24
CORRECT_READ_LEN = (8_000, 12_001)
CORRECT_ERROR = 0.08
# the command's runs and the CPU's correct the first index block: the first
# read (or two; -i 10k), every read still a query
CORRECT_BLOCK = ["-i", "10k", "--run-block-id", "0"]
# the correction model's float32 logits, card against CPU: max abs difference
# (both float32 with TF32 off; the sums' order differs); a supported column
# whose prediction differs must have its top two CPU logits within twice this
TOL_CORRECT_LOGITS = 1e-4


def correct_phase(k) -> None:
    """Read correction at full width on the card (path ``correct nn``: no
    hand-written kernel; the model's matmuls on cuBLAS in float32, its
    attention the plain product, softmax, product): 24 seeded FASTQ reads of
    8-12 kb of a 24 kb genome at 8% errors, all-vs-all overlaps by the
    port's mapper on every host core, then ``ReadCorrector(use_nn=True)``
    with the command's
    default model (dim 128, depth 4, 4 heads, windows of 4096, seeded random
    weights), one window a forward. Prints the windows, the mapping's
    seconds, the host's window extraction, features and decode in seconds a
    window, the device forward in ms a window (CUDA events) and one forward
    by kernel (the profiler). The first index block's reads again on the CPU
    over the same overlaps, beside the command's subprocess: each window's logits on the card against
    the CPU within TOL_CORRECT_LOGITS, predictions and corrected reads equal
    but at near ties (counted). Then the command: ``python -m
    dorado_tpu_torch correct --nn`` over that block against the function,
    ``--to-paf`` then ``--from-paf`` against that direct run, and a scripted
    module with HERRO's contract (``tests/torch_correct.py``) through
    ``--model-path`` on the card against ``-x cpu``, its logits within
    TOL_CORRECT_LOGITS; the command's wall time."""
    import contextlib

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from dorado_tpu_torch.cli.main import _parse_size
    from dorado_tpu_torch.cli.main import main as cli_main
    from dorado_tpu_torch.correct import ReadCorrector, nn_model
    from dorado_tpu_torch.utils.torchscript import script_and_save
    from tests.torch_correct import HerroContract, correct_reads
    from tests.torch_polish import write_fastq

    torch, dev = k.torch, k.dev
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    fq_reads = correct_reads(SEED, CORRECT_GENOME, CORRECT_READS, CORRECT_READ_LEN,
                             error=CORRECT_ERROR)
    reads = [(name, seq) for name, seq, _ in fq_reads]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_correct_"))
    fastq = write_fastq(tmp / "reads.fastq", fq_reads)

    # ---- the main path: every read on the card ---------------------------------
    for w in k.wrappers.values():
        w.launches = 0
    corrector = ReadCorrector(use_nn=True, device=dev, threads=0)
    forwards = []  # (columns, ms by CUDA events, the window's features)
    real_predict = corrector.predict

    def timed_predict(wf):
        if not len(wf.indices):  # no supported column: no forward (the JAX contract)
            return real_predict(wf)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        bases = real_predict(wf)
        end.record()
        end.synchronize()
        forwards.append((wf.bases.shape[1], start.elapsed_time(end), wf))
        return bases

    corrector.predict = timed_predict
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = corrector.compute_overlap_records(reads)
    card_out = dict(corrector.correct(reads, overlap_records=records))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k.launches["correct nn"] = {name: w.launches for name, w in k.wrappers.items()}
    k.check_launches("correct nn", k.launches["correct nn"], 1)
    st = corrector.stats
    changed = sum(card_out[name] != seq for name, seq in reads)
    if (st.reads_corrected < 0.9 * CORRECT_READS or len(forwards) < CORRECT_READS
            or changed < CORRECT_READS // 2):
        raise AssertionError(f"correct: {st.reads_corrected} reads corrected, {changed} changed, "
                             f"over {st.windows} windows, {len(forwards)} forwards")
    ms = np.array([f[1] for f in forwards])
    cols = np.array([f[0] for f in forwards])
    host_s, device_s = st.extract_s + st.features_s + st.decode_s, ms.sum() / 1e3
    print(f"correct inputs: a {CORRECT_GENOME} b genome, {CORRECT_READS} reads of "
          f"{CORRECT_READ_LEN} b at {CORRECT_ERROR:.0%} errors; {len(records)} overlaps mapped "
          f"on {os.cpu_count()} threads in {st.mapping_s:.2f} s [host of {k.card}]", flush=True)
    print(f"correct nn (path 'correct nn', no hand-written kernel): {st.reads_corrected} reads "
          f"corrected ({changed} changed), {st.windows} windows, {len(forwards)} with supported "
          f"columns and a forward, of {cols.min()}-{cols.max()} columns (mean {cols.mean():.0f}),"
          f" in {wall:.2f} s wall; a window: host window "
          f"extraction {st.extract_s / st.windows:.4f} s, host features "
          f"{st.features_s / st.windows:.4f} s, decode {st.decode_s / st.windows:.4f} s, device "
          f"forward {ms.mean():.3f} ms (CUDA events; median {np.median(ms):.3f}, max "
          f"{ms.max():.3f}; host-clock forward with the fetch "
          f"{st.forward_s / len(forwards) * 1e3:.3f} ms); host / device {host_s / device_s:.0f}x "
          f"[{k.smi}]", flush=True)
    # one forward of the longest window by kernel
    wf_big = max(forwards, key=lambda f: f[0])[2]
    bases = torch.from_numpy(wf_big.bases[None]).to(dev)
    quals = torch.from_numpy(wf_big.quals[None]).to(dev)
    model = corrector.nn_model
    with torch.no_grad():
        model(bases, quals)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(bases, quals)
            torch.cuda.synchronize()
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                        if e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy = sum(v for _, v in by_kernel)
    length = wf_big.bases.shape[1]
    flops = 4 * (2 * length * 128 * (3 * 128 + 128 + 8 * 128) + 4 * length * length * 128)
    rate = f"{flops / busy / 1e9:.1f} TFLOP/s" if busy > 0 else "the profiler saw no kernel"
    print(f"correct forward at L={length} by kernel (the profiler): {busy:.3f} ms busy, "
          f"{flops / 1e9:.1f} GFLOP (the four layers' matmuls and attention products) = "
          f"{rate}; float32 peak {PEAK_F32 / 1e12:.0f} TFLOP/s [{k.smi}]:", flush=True)
    for key, v in by_kernel[:8]:
        print(f"  {v:9.3f} ms {v / busy:6.1%}  {key[:90]}")
    peak0 = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        model(bases, quals)
    torch.cuda.synchronize()
    print(f"correct forward at L={length}: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (the run's peak so far "
          f"{peak0 / 2**30:.2f} GiB)", flush=True)
    del bases, quals

    # ---- the command in a fresh process, beside the CPU's run ------------------------
    direct = tmp / "direct.fa"
    t_cli = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-m", "dorado_tpu_torch", "correct", str(fastq),
                              "--nn", *CORRECT_BLOCK, "-o", str(direct)], cwd=ROOT,
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    # ---- the first index block on the CPU over the same overlaps -----------------
    block, total = [], 0
    for name, seq in reads:
        block.append(name)
        total += len(seq)
        if total >= _parse_size(CORRECT_BLOCK[1]):
            break
    cpu_model = copy.deepcopy(model).to(cpu)
    cpu_corrector = ReadCorrector(use_nn=True, nn_model=cpu_model, device="cpu")
    held = {"windows": 0, "err": 0.0, "ties": 0, "columns": 0}

    def cpu_predict(wf):
        """The CPU's predictions, its logits held against the card's."""
        got = nn_model.window_logits(cpu_model, wf, cpu)
        card = nn_model.window_logits(model, wf, dev).cpu()
        held["windows"] += 1
        held["err"] = max(held["err"], float((got - card).abs().max()))
        if not held["err"] <= TOL_CORRECT_LOGITS:
            raise AssertionError(f"correct: logits on the card differ from the CPU's by "
                                 f"{held['err']} > {TOL_CORRECT_LOGITS}")
        idx = torch.from_numpy(wf.indices.astype(np.int64))
        a, b = got[idx], card[idx]
        differ = a.argmax(-1) != b.argmax(-1)
        top2 = a.topk(2, -1).values if len(idx) else a[:, :2]
        near = (top2[:, 0] - top2[:, 1]) <= 2 * TOL_CORRECT_LOGITS
        if bool((differ & ~near).any()):
            raise AssertionError("correct: a prediction differs from the CPU's off a near tie")
        held["ties"] += int(differ.sum())
        held["columns"] += len(idx)
        return "".join(nn_model.CLASSES[int(i)] for i in a.argmax(-1))

    cpu_corrector.predict = cpu_predict
    t0 = time.perf_counter()
    cpu_out = dict(cpu_corrector.correct(reads, targets=set(block), overlap_records=records))
    cpu_s = time.perf_counter() - t0
    reads_differ = sum(cpu_out[n] != card_out[n] for n in block)
    if held["columns"] == 0 or reads_differ > held["ties"]:
        raise AssertionError(f"correct: {reads_differ} of the block's reads differ from the "
                             f"CPU's, {held['ties']} near ties")
    print(f"correct card against CPU: the first block ({len(block)} reads, {held['windows']} "
          f"windows, {held['columns']} supported columns) on the CPU in {cpu_s:.1f} s; logits "
          f"max abs error {held['err']:.3g} (limit {TOL_CORRECT_LOGITS}); {held['ties']} "
          f"predictions differ at near ties; {reads_differ} corrected reads differ", flush=True)

    # ---- the command ---------------------------------------------------------------
    fn = ReadCorrector(use_nn=True, device=dev, threads=0)
    want = "".join(f">{name}\n" + "".join(seq[i:i + 80] + "\n" for i in range(0, len(seq), 80))
                   for name, seq in fn.correct(reads, targets=set(block)))
    try:
        _, err = child.communicate(timeout=600)
    finally:
        child.kill()
    cli_wall = time.perf_counter() - t_cli
    if child.returncode != 0 or not direct.exists() or direct.read_text() != want:
        raise AssertionError(f"python -m dorado_tpu_torch correct --nn: exit code "
                             f"{child.returncode}, or its FASTA differs from the function's: "
                             f"{err[-2000:]}")
    print(f"python -m dorado_tpu_torch correct reads.fastq --nn {' '.join(CORRECT_BLOCK)}: "
          f"{cli_wall:.2f} s wall (a fresh process, beside the CPU's run), its FASTA equal to "
          f"the function's; {[l for l in err.splitlines() if l.startswith('> ')]}", flush=True)

    def run_cli(*argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli_main(["correct", str(fastq), *argv])
        if rc != 0:
            raise AssertionError(f"correct {' '.join(argv)}: exit code {rc}: {err.getvalue()}")
        return err.getvalue()

    paf = tmp / "overlaps.paf"
    run_cli("--to-paf", *CORRECT_BLOCK, "-o", str(paf))
    from_paf = tmp / "from_paf.fa"
    run_cli("--nn", *CORRECT_BLOCK, "-p", str(paf), "-o", str(from_paf))
    if from_paf.read_text() != want:
        raise AssertionError("correct --from-paf: its FASTA differs from the direct run's")
    print(f"correct --to-paf then --from-paf: {len(paf.read_text().splitlines())} overlaps; "
          f"the FASTA equal to the direct run's", flush=True)

    herro = tmp / "herro.pt"
    script_and_save(HerroContract(copy.deepcopy(cpu_model)), herro)
    outs = {}
    for where in ("cuda", "cpu"):
        outs[where] = tmp / f"herro_{where}.fa"
        t0 = time.perf_counter()
        err = run_cli("--model-path", str(herro), *CORRECT_BLOCK, "-p", str(paf), "-x", where,
                      "-o", str(outs[where]))
        print(f"correct --model-path <HERRO-contract TorchScript> -x {where}: "
              f"{time.perf_counter() - t0:.2f} s; {err.splitlines()[-1]}", flush=True)
    ts_differ = sum(a != b for a, b in zip(outs["cuda"].read_text().splitlines(),
                                           outs["cpu"].read_text().splitlines()))
    if ts_differ and not held["ties"]:
        raise AssertionError(f"correct --model-path: {ts_differ} lines differ between the card "
                             f"and the CPU, with no near tie")
    wf = forwards[0][2]
    scripted = {where: nn_model.TorchScriptScorer(str(herro), where) for where in ("cuda", "cpu")}
    logits = {}
    for where, scorer in scripted.items():
        d = scorer.device
        with torch.no_grad(), nn_model.float32_products(d):
            out = scorer.module(torch.from_numpy(wf.bases[None]).to(d),
                                torch.from_numpy(wf.quals[None]).to(d),
                                torch.tensor([wf.bases.shape[1]], dtype=torch.int32, device=d),
                                [torch.from_numpy(wf.indices.astype(np.int32)).to(d)])
        logits[where] = out[0].cpu()
    ts_err = float((logits["cuda"] - logits["cpu"]).abs().max())
    if not ts_err <= TOL_CORRECT_LOGITS:
        raise AssertionError(f"correct --model-path: the scripted module's logits on the card "
                             f"differ from the CPU's by {ts_err}")
    print(f"correct --model-path: the scripted module's logits on the card against the CPU, "
          f"max abs error {ts_err:.3g} (limit {TOL_CORRECT_LOGITS}); the two FASTAs differ at "
          f"{ts_differ} lines", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"correct phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def body_lines(vcf_text: str) -> list[str]:
    """A VCF's records, its header lines left out."""
    return [line for line in vcf_text.splitlines() if not line.startswith("#")]


# ---- barcoding, trimming and poly(A) in the basecaller; demux and trim ------
DEMUX_KIT = "SQK-NBD114-24"
DEMUX_KIT_96 = "SQK-NBD114-96"
# hac reads of 40-60k samples: about 2,700 chunks, 22 batches of 128 a pass
DEMUX_READS = 480
DEMUX_READ_SAMPLES = (40_000, 60_001)
DEMUX_CMD_READS = 2_000  # planted reads of the demux and trim commands
DEMUX_CMD_LENGTHS = (1_000, 10_001)
DEMUX_CMD_ERROR = 0.05
DEMUX_CMD_UNBARCODED = 0.1
DEMUX_TIMED_READS = 100  # of those, timed one by one for the host ms a read
DEMUX_WORKERS = 6  # processes that apply the commands' functions to their input
# the classifier on the planted reads (all of them right on the CPU at this
# seed): the share of barcoded reads given their barcode, and of reads given
# another barcode than planted or one where none was planted. The planted
# calls of the pipeline runs are held to the same shares, and to as large a
# share of tails found within DEMUX_TAIL_TOL bases of the planted length
MIN_DEMUX_RIGHT = 0.95
MAX_DEMUX_WRONG = 0.01
DEMUX_TAIL_TOL = 3
DEMUX_SHEET = ("experiment_id,kit,flow_cell_id,barcode,alias\n"
               + "".join(f",{DEMUX_KIT},FAB00000,barcode{i:02d},smoke_{i:02d}\n"
                         for i in range(1, 13)))


def demux_planter(real, kit_name: str):
    """A wrapper of the pipeline's ``mux_change_trim`` (``real``) that makes
    each call it is given a read of a multiplexed cDNA run, its bases, moves,
    qualities and tail drawn from a seed of the call's own bases, so that
    equal calls stay equal: the LSK110 front adapter, the kit's front context
    (flank, barcode, flank), the SSP primer, random bases, a poly(A) tail of
    30-150 bases, the reverse-complemented VNP primer, the context reverse-
    complemented and the rear adapter; a base every two moves, and the scaled
    signal flat under the tail. A tenth of the reads carries no barcode, and
    a seventh of the others one of ``barcode13``-``barcode14``, which the
    sample sheet does not hold. A call too short for that stays as it was.

    Returns the wrapper and ``planted``: for each call the wrapper returned,
    keyed by its bases and qualities, the signal it returned, the planted
    barcode (None for none, or a call left as it was) and the tail's bases
    (0 for none)."""
    import zlib

    import numpy as np

    from dorado_tpu_torch.demux.adapters import ADAPTERS, PRIMERS
    from dorado_tpu_torch.demux.barcoder import get_barcode_sequence, get_kit_info
    from dorado_tpu_torch.utils.sequence import reverse_complement
    from tests.torch_demux import random_seq

    info = get_kit_info(kit_name)
    ssp, vnp = PRIMERS["PCS110"]
    front_adapter, rear_adapter = ADAPTERS["LSK110"]
    planted = {}

    def plant(seq, qstring, moves, signal, stride, end_reason):
        seq, qstring, moves, signal = real(seq, qstring, moves, signal, stride, end_reason)
        rng = np.random.RandomState(zlib.crc32(seq.encode()))
        barcode, tail = None, int(rng.randint(30, 151))
        if rng.rand() >= 0.1:
            barcode = info["barcodes"][rng.randint(14)]
        context = ""
        if barcode is not None:
            context = (info["top_front_flank"] + get_barcode_sequence(barcode)
                       + info["top_rear_flank"])
        head = front_adapter + context + ssp
        rear = reverse_complement(vnp) + reverse_complement(context) + rear_adapter
        n = (len(moves) + 1) // 2
        insert = n - len(head) - tail - len(rear)
        if insert < 100:
            planted[(seq, qstring)] = (signal, None, 0)
            return seq, qstring, moves, signal
        seq = head + random_seq(rng, insert) + "A" * tail + rear
        moves = np.zeros(len(moves), np.uint8)
        moves[: 2 * n : 2] = 1
        qstring = "".join(chr(33 + q) for q in rng.randint(8, 35, n))
        # the tail's samples, and those of the four As that open the rear primer
        a = 2 * stride * (n - len(rear) - tail)
        b = min(len(signal), 2 * stride * (n - len(rear) + 4))
        signal = signal.copy()
        signal[a:b] = 1.2 + rng.normal(0.0, 0.05, b - a).astype(signal.dtype)
        planted[(seq, qstring)] = (signal, barcode, tail)
        return seq, qstring, moves, signal

    return plant, planted


def demux_functions(records, kit_name):
    """The ``demux`` and ``trim`` commands' functions on ``records``: each
    record's barcode group and its line after classification and barcode
    trimming, and its line after adapter and primer trimming over every kit."""
    from dorado_tpu_torch.demux import BarcodeClassifier
    from dorado_tpu_torch.demux.adapters import ReadTrimmer
    from dorado_tpu_torch.demux.barcoder import (
        UNCLASSIFIED, determine_barcode_trim_interval, normalize_barcode_name,
    )
    from dorado_tpu_torch.demux.trimmer import trim_record
    from dorado_tpu_torch.io.sam import SamTag

    classifier, trim_all = BarcodeClassifier(kit_name), ReadTrimmer()
    groups, trimmed = [], []
    for rec in records:
        demuxed = copy.deepcopy(rec)
        res = classifier.classify(demuxed.seq)
        name = UNCLASSIFIED
        if res.barcode_name != UNCLASSIFIED:
            name = f"{classifier.kit_info['name']}_{normalize_barcode_name(res.barcode_name)}"
        demuxed.tags.append(SamTag("BC", "Z", name))
        if name != UNCLASSIFIED:
            interval = determine_barcode_trim_interval(res, len(demuxed.seq))
            if interval != (0, len(demuxed.seq)):
                trim_record(demuxed, interval)
        groups.append((name, demuxed.to_sam_line()))
        trimmed.append(trim_all.trim(copy.deepcopy(rec)).to_sam_line())
    return groups, trimmed


def demux_phase(k, cfg, model) -> None:
    """Barcoding, adapter and primer trimming and poly(A) estimation in the
    basecaller on the card (path ``demux hac``: hac v4.3 at full width, W8A8,
    Viterbi; K1 and K2 5 times a batch, K3, K4, K5 once), and the ``demux``
    and ``trim`` commands on the card's host. Nothing that is timed runs
    beside another part of the phase.

    - ``run_reads`` over DEMUX_READS reads of 40-60k samples with and without
      ``barcode_classifier`` (SQK-NBD114-24, limited to a sample sheet's 12
      barcodes and aliased by it), ``estimate_poly_a`` and ``trimmer`` (the
      CLI's ``--trim all``), in turns (plain, options, options, plain), each
      after a run that pays the per-shape set-up: samples/s and the device's
      idle share of each pass, the host's thread-seconds in ``classify``,
      the trimmer and ``calculate_num_bases`` beside ``host_finish_s``. Both
      pipelines' calls are planted reads (``demux_planter``). Every read must
      be written, and each record with the options must equal the plain
      run's record with the port's own classifier, poly(A) calculator (on the
      signal the pipeline gave it: the read's scaled and trimmed signal, a
      subread's own) and trimmer applied on the host. The reads that were
      not split are held to the planted truth: barcodes by MIN_DEMUX_RIGHT
      and MAX_DEMUX_WRONG, the share of tails found within DEMUX_TAIL_TOL
      bases and of reads trimmed by MIN_DEMUX_RIGHT.
    - ``basecaller --kit-name --trim all --estimate-poly-a --sample-sheet
      --emit-summary`` in process on the committed POD5 fixture (path ``cli
      demux``), its calls planted too: BC, pt and pa on every record, reads
      given a sheet's alias (and an RG with its suffix), a tail and a trim,
      12 barcode read groups a run, the summary's barcode columns.
    - ``python -m dorado_tpu_torch demux`` (classify, trim, summary) and then
      ``trim``, one at a time, over a BAM of DEMUX_CMD_READS planted reads of
      1-10 kb (``tests/torch_demux.py``: the LSK110 adapters and
      SQK-NBD114-24 barcodes with flanks at both ends, 5% errors, 10%
      unbarcoded): each command's reads/s (its wall time, start-up
      included). Each output file must hold the records of the commands'
      functions (``demux_functions``, in DEMUX_WORKERS processes while the
      host holds the pipeline's records), and the classified share must meet
      MIN_DEMUX_RIGHT and MAX_DEMUX_WRONG against the planted truth.
    - Then, alone, the host ms a read of ``classify`` at a 24- and a
      96-barcode kit and of ``find_adapters`` + ``find_primers``
      (SQK-NBD114-24's, and every kit's), one thread, over DEMUX_TIMED_READS
      of the commands' reads; and of ``calculate_num_bases`` over the
      pipeline's planted records."""
    import multiprocessing
    import threading
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    import dorado_tpu_torch.pipeline.basecaller as basecaller_module
    from dorado_tpu_torch.demux import BarcodeClassifier
    from dorado_tpu_torch.demux.adapters import ReadTrimmer, find_adapters, find_primers
    from dorado_tpu_torch.demux.barcoder import UNCLASSIFIED, normalize_barcode_name
    from dorado_tpu_torch.io.bam_reader import read_bam
    from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamTag
    from dorado_tpu_torch.pipeline import BasecallerPipeline
    from dorado_tpu_torch.polytail import make_calculator
    from dorado_tpu_torch.polytail.calculator import ReadContext
    from dorado_tpu_torch.utils.sample_sheet import SampleSheet
    from tests.torch_demux import planted_records

    torch = k.torch
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_demux_"))
    (tmp / "sheet.csv").write_text(DEMUX_SHEET)
    sheet = SampleSheet(str(tmp / "sheet.csv"))
    rs = np.random.RandomState(SEED + 23)
    reads = [k.make_read(2300 + i, int(rs.randint(*DEMUX_READ_SAMPLES)), rs)
             for i in range(DEMUX_READS)]
    samples = sum(len(r.signal) for r in reads)

    # the commands' input, and their functions on it in processes of their own
    t0 = time.perf_counter()
    cmd_records, truth = planted_records(SEED, DEMUX_KIT, DEMUX_CMD_READS, DEMUX_CMD_LENGTHS,
                                         DEMUX_CMD_ERROR, DEMUX_CMD_UNBARCODED, adapters=True)
    bam = tmp / "planted.bam"
    with open(bam, "wb") as fh:
        writer = BamWriter(fh, SamHeader())
        for rec in cmd_records:
            writer.write(rec)
        writer.close()
    bases = sum(len(r.seq) for r in cmd_records)
    print(f"demux inputs: {DEMUX_READS} hac reads of {DEMUX_READ_SAMPLES} samples; "
          f"{DEMUX_CMD_READS} planted reads of {DEMUX_CMD_LENGTHS} bases ({bases} bases), the "
          f"LSK110 adapters and {DEMUX_KIT} at both ends, {DEMUX_CMD_ERROR:.0%} errors, "
          f"{DEMUX_CMD_UNBARCODED:.0%} unbarcoded, written in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def classifier():
        return BarcodeClassifier(DEMUX_KIT, allowed_barcodes=sheet.get_barcode_values())

    plain = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True)
    options = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True,
                                 barcode_classifier=classifier(), sample_sheet=sheet,
                                 estimate_poly_a=True, trimmer=ReadTrimmer(kit_name=DEMUX_KIT))
    # the host's thread-seconds in each stage of the options run
    host_s = {"classify": 0.0, "poly(A)": 0.0, "trim": 0.0, "planting the calls": 0.0}
    lock = threading.Lock()

    def timed(stage, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    host_s[stage] += time.perf_counter() - t0
        return wrapped

    options.barcode_classifier.classify = timed("classify", options.barcode_classifier.classify)
    calculator = options.poly_tail_selector.get_calculator(None)  # every read's: one config
    calculator.calculate_num_bases = timed("poly(A)", calculator.calculate_num_bases)
    options.trimmer.trim = timed("trim", options.trimmer.trim)
    # the plain run's subreads' own signals, for the poly(A) estimate on the host
    sub_signals = {}
    real_split = plain.read_splitter.split

    def split(seq, qstring, moves, signal, stride):
        subs = real_split(seq, qstring, moves, signal, stride)
        if len(subs) > 1:
            with lock:
                sub_signals.update({(s.seq, s.qstring): s.signal for s in subs})
        return subs

    plain.read_splitter.split = split
    plant, planted = demux_planter(basecaller_module.mux_change_trim, DEMUX_KIT)
    real_mux_trim = basecaller_module.mux_change_trim
    # the planter runs in the finish threads of both runs: its thread-seconds
    # are part of host_finish_s
    basecaller_module.mux_change_trim = timed("planting the calls", plant)
    try:
        for p in (plain, options):
            p.run_reads(reads[:24], k.Discard())  # the per-shape set-up, reused below
        torch.cuda.synchronize()
        k.path_kernels["demux hac"] = k.path_kernels["viterbi"]
        k.per_batch["demux hac"] = [5, 5, 1, 1, 1]
        passes, records = [], {}
        for label, p in (("plain", plain), ("options", options), ("options", options),
                         ("plain", plain)):
            counted = label == "options" and "options" not in records
            if counted:
                for w in k.wrappers.values():
                    w.launches = 0
                for stage in host_s:
                    host_s[stage] = 0.0
            written = Collect()
            parents = k.Parents(written)
            t0 = time.perf_counter()
            stats = p.run_reads(reads, parents)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if counted:
                k.launches["demux hac"] = {name: w.launches for name, w in k.wrappers.items()}
                k.check_launches("demux hac", k.launches["demux hac"], stats.batches)
                finish_s, stage_s = stats.host_finish_s, dict(host_s)
            if set(parents.parents) != {r.read_id for r in reads}:
                raise AssertionError(f"demux {label}: {len(set(parents.parents))} of "
                                     f"{len(reads)} reads written")
            records.setdefault(label, written.records)
            passes.append((label, samples / wall, stats.device_idle_frac))
            print(f"demux hac pipeline, {label}: {len(reads)} reads, {samples} samples, "
                  f"{stats.batches} batches, {len(written.records)} records in {wall:.3f} s = "
                  f"{samples / wall:.0f} samples/s; device idle {stats.device_idle_frac:.1%}; "
                  f"host finish {stats.host_finish_s:.3f} thread-s (hac v4.3, batch {N}, bf16 "
                  f"with W8A8 projections, Viterbi, planted calls"
                  f"{'; ' + DEMUX_KIT + ', --trim all, --estimate-poly-a, a sample sheet' if label == 'options' else ''}) "
                  f"[{k.smi}]", flush=True)
    finally:
        basecaller_module.mux_change_trim = real_mux_trim
    print(f"demux hac: launches {dict((n, v) for n, v in k.launches['demux hac'].items() if v)};"
          f" host thread-s in the options run: " + ", ".join(
              f"{stage} {s:.3f} ({s / finish_s:.1%} of host_finish_s {finish_s:.3f})"
              for stage, s in stage_s.items()) + f" [{k.smi}]", flush=True)
    for label in ("plain", "options"):
        rates = [r for lab, r, _ in passes if lab == label]
        idle = [i for lab, _, i in passes if lab == label]
        print(f"demux hac {label}: samples/s by pass {[round(r) for r in rates]}, device idle "
              f"{[f'{i:.1%}' for i in idle]} [{k.smi}]", flush=True)

    # ---- the commands' functions in processes of their own, meanwhile the
    # options run's records: the plain run's, finished on the host ------------
    share = -(-len(cmd_records) // DEMUX_WORKERS)
    pool = ProcessPoolExecutor(DEMUX_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(demux_functions, cmd_records[i:i + share], DEMUX_KIT)
                   for i in range(0, len(cmd_records), share)]
        host_classifier, host_trimmer = classifier(), ReadTrimmer(kit_name=DEMUX_KIT)
        host_calculator = make_calculator()
        by_name = {r.qname: r for r in records["options"]}
        if sorted(by_name) != sorted(r.qname for r in records["plain"]):
            raise AssertionError("demux hac: the options run's records are not the plain "
                                 "run's")
        allowed = set(sheet.get_barcode_values())
        contexts, counts = [], dict.fromkeys(("classified", "tailed", "planted", "barcoded",
                                              "right", "wrong", "tail right", "trimmed"), 0)
        for rec in records["plain"]:
            tags = {t.tag: t.value for t in rec.tags}
            res = host_classifier.classify(rec.seq)
            bc = UNCLASSIFIED
            if res.barcode_name != UNCLASSIFIED:
                bc = (f"{host_classifier.kit_info['name']}_"
                      f"{normalize_barcode_name(res.barcode_name)}")
                bc = sheet.get_alias(bc, "FAB00000", "", "") or bc
                counts["classified"] += 1
                for t in rec.tags:
                    if t.tag == "RG":
                        t.value = f"{t.value}_{bc}"
            if "pi" in tags:
                signal, trimmed, barcode, tail = sub_signals[(rec.seq, rec.qual)], 0, None, 0
            else:
                signal, barcode, tail = planted[(rec.seq, rec.qual)]
                trimmed = tags["ts"]
            contexts.append(ReadContext(
                seq=rec.seq, moves=np.asarray(tags["mv"][1:]), signal=signal,
                stride=cfg.stride, num_trimmed_samples=trimmed,
                flow_cell_product_code="FLO-PRO114M"))
            poly = host_calculator.calculate_num_bases(contexts[-1])
            counts["tailed"] += poly.num_bases >= 0
            at = [t.tag for t in rec.tags].index("po")
            rec.tags[at:at] = [
                SamTag("BC", "Z", bc),
                SamTag("pt", "i", poly.num_bases if poly.num_bases >= 0 else -1),
                SamTag("pa", "B", np.array([poly.signal_anchor, *poly.signal_range,
                                            *poly.split_signal_range], dtype=np.int32),
                       subtype="i"),
            ]
            length = len(rec.seq)
            host_trimmer.trim(rec)
            if rec.to_sam_line() != by_name[rec.qname].to_sam_line():
                raise AssertionError(f"demux hac: {rec.qname} differs from the plain record "
                                     f"with classify, poly(A) and trim applied on the host")
            if tail:  # a planted read that was not split: against the planted truth
                counts["planted"] += 1
                counts["tail right"] += abs(poly.num_bases - tail) <= DEMUX_TAIL_TOL
                counts["trimmed"] += len(rec.seq) < length
                if barcode is not None and normalize_barcode_name(barcode) in allowed:
                    want = f"smoke_{barcode[-2:]}"
                    counts["barcoded"] += 1
                    counts["right"] += bc == want
                    counts["wrong"] += bc not in (want, UNCLASSIFIED)
                else:
                    counts["wrong"] += bc != UNCLASSIFIED
        print(f"demux hac: {len(records['plain'])} records equal the plain run's with "
              f"classify, poly(A) and trim applied on the host ({counts['classified']} "
              f"classified, {counts['tailed']} with a tail); of {counts['planted']} planted "
              f"reads not split, {counts['right']} of {counts['barcoded']} with a sheet's "
              f"barcode given its alias, {counts['wrong']} given another or one where none "
              f"fits, {counts['tail right']} tails within {DEMUX_TAIL_TOL} bases, "
              f"{counts['trimmed']} trimmed", flush=True)
        planted_n = max(1, counts["planted"])
        if (counts["planted"] < len(reads) // 2
                or counts["right"] < MIN_DEMUX_RIGHT * counts["barcoded"]
                or counts["wrong"] > MAX_DEMUX_WRONG * planted_n
                or counts["tail right"] < MIN_DEMUX_RIGHT * planted_n
                or counts["trimmed"] < MIN_DEMUX_RIGHT * planted_n):
            raise AssertionError("demux hac: the planted reads miss their limits")
        want_groups, want_trim = {}, []
        for future in futures:
            groups, trimmed_lines = future.result(timeout=600)
            for name, line in groups:
                want_groups.setdefault(name, []).append(line)
            want_trim += trimmed_lines
    finally:
        pool.shutdown(cancel_futures=True)

    # ---- the command line on the card: the basecaller with the options -------
    from dorado_tpu_torch.cli.main import main as cli_main
    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.models.load import save_model

    model_dir = save_model(cfg, model, tmp / cfg.model_name)
    (tmp / "cli").mkdir()
    k.path_kernels["cli demux"] = k.path_kernels["viterbi"]
    for w in k.wrappers.values():
        w.launches = 0
    plant, cli_planted = demux_planter(real_mux_trim, DEMUX_KIT)
    basecaller_module.mux_change_trim = plant
    t0 = time.perf_counter()
    try:
        rc = cli_main(["basecaller", str(model_dir), str(ROOT / "tests" / "data" /
                                                           "torch_port" / "fixture.pod5"),
                       "--kit-name", DEMUX_KIT, "--trim", "all", "--estimate-poly-a",
                       "--sample-sheet", str(tmp / "sheet.csv"), "--emit-summary",
                       "--emit-sam", "-o", str(tmp / "cli" / "calls.sam")])
        torch.cuda.synchronize()
    finally:
        basecaller_module.mux_change_trim = real_mux_trim
    wall = time.perf_counter() - t0
    k.launches["cli demux"] = {name: w.launches for name, w in k.wrappers.items()}
    k.check_launches("cli demux", k.launches["cli demux"], 0)
    header, cli_records = read_records(tmp / "cli" / "calls.sam")
    groups = [line for line in header.splitlines() if line.startswith("@RG")]
    barcoded = [line for line in groups if "\tbk:" + DEMUX_KIT in line]
    summary = (tmp / "cli" / "sequencing_summary.txt").read_text().splitlines()
    tags = [{t.tag: t.value for t in r.tags} for r in cli_records]
    tagged = all({"BC", "pt", "pa"} <= set(t) for t in tags)
    # the fixture's experiment name is no valid sample-sheet experiment_id, so
    # its reads take no alias: a classified read's BC is the kit's barcode name
    classified = sum(t["BC"] != UNCLASSIFIED and t["RG"].endswith("_" + t["BC"])
                     for t in tags if tagged)
    tailed = sum(t["pt"] >= 0 for t in tags if tagged)
    # a record that was not split and holds less than its planted call
    trimmed = sum("pi" not in t and any(r.seq in seq and len(r.seq) < len(seq)
                                        for seq, _ in cli_planted)
                  for r, t in zip(cli_records, tags))
    if (rc != 0 or not cli_records or not tagged or not classified or not tailed or not trimmed
            or len(barcoded) != 12 * (len(groups) - len(barcoded))
            or "barcode_arrangement" not in summary[0]
            or len(summary) != len(cli_records) + 1):
        raise AssertionError(f"cli demux: exit {rc}, {len(cli_records)} records (BC, pt, pa on "
                             f"each: {tagged}; {classified} classified, {tailed} with a "
                             f"tail, {trimmed} trimmed), {len(barcoded)} barcode read groups "
                             f"of {len(groups)}, {len(summary) - 1} summary rows; BC and RG "
                             f"{sorted({(t.get('BC'), t.get('RG')) for t in tags})}")
    print(f"cli demux (path 'cli demux'): basecaller --kit-name {DEMUX_KIT} --trim all "
          f"--estimate-poly-a --sample-sheet --emit-summary on the committed fixture, planted "
          f"calls: {len(cli_records)} records with BC, pt and pa ({classified} classified "
          f"with the RG suffix, {tailed} with a tail, {trimmed} trimmed), {len(barcoded)} barcode read "
          f"groups, the summary's barcode columns, in {wall:.2f} s; launches "
          f"{ {n: v for n, v in k.launches['cli demux'].items() if v} } [{k.smi}]", flush=True)

    # ---- the commands, one at a time -------------------------------------------
    commands = {
        "demux": ["demux", str(bam), "--kit-name", DEMUX_KIT, "--output-dir",
                  str(tmp / "demux"), "--emit-summary"],
        "trim": ["trim", str(bam), "-o", str(tmp / "trimmed.bam")],
    }
    walls = {}
    for name, argv in commands.items():
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "dorado_tpu_torch", *argv], cwd=ROOT,
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                             timeout=600)
        walls[name] = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"python -m dorado_tpu_torch {name}: exit {res.returncode}"
                                 f"\n{res.stderr}")
    got_groups = {p.stem: [r.to_sam_line() for r in read_bam(p)[1]]
                  for p in (tmp / "demux").glob("*.bam")}
    if got_groups != want_groups:
        raise AssertionError(f"demux: the command's files differ from its functions' "
                             f"({sorted(got_groups)} against {sorted(want_groups)})")
    if [r.to_sam_line() for r in read_bam(tmp / "trimmed.bam")[1]] != want_trim:
        raise AssertionError("trim: the command's records differ from its functions'")
    summary = (tmp / "demux" / "barcoding_summary.txt").read_text().splitlines()
    if len(summary) != DEMUX_CMD_READS + 1:
        raise AssertionError(f"demux: {len(summary) - 1} summary rows")
    called = {line.split("\t")[0]: name for name, lines in got_groups.items()
              for line in lines}
    planted_cmd = [(f"read-{i:05d}", t) for i, t in enumerate(truth)]
    barcoded = [(q, f"NB24_barcode{t[2:]}") for q, t in planted_cmd if t]
    right = sum(called[q] == want for q, want in barcoded) / len(barcoded)
    wrong = sum(called[q] not in (want, UNCLASSIFIED) for q, want in barcoded)
    wrong += sum(called[q] != UNCLASSIFIED for q, t in planted_cmd if not t)
    trimmed = sum(a != b.to_sam_line() for a, b in zip(want_trim, cmd_records))
    print(f"demux: {len(got_groups)} files equal to the functions' records; {right:.2%} of "
          f"{len(barcoded)} barcoded reads given their barcode (limit {MIN_DEMUX_RIGHT:.0%}), "
          f"{wrong} reads of {DEMUX_CMD_READS} given another barcode or one where none was "
          f"planted (limit {MAX_DEMUX_WRONG:.0%}); trim: the functions' records, {trimmed} "
          f"reads trimmed", flush=True)
    if right < MIN_DEMUX_RIGHT or wrong > MAX_DEMUX_WRONG * DEMUX_CMD_READS:
        raise AssertionError("demux: the classified share misses its limits")
    for name, wall in walls.items():
        print(f"{name} command: {DEMUX_CMD_READS} reads in {wall:.2f} s = "
              f"{DEMUX_CMD_READS / wall:.1f} reads/s (wall, start-up included; alone) "
              f"[host of {k.smi}]", flush=True)

    # ---- single-thread host ms a read, alone -----------------------------------
    timed_reads = [r.seq for r in cmd_records[:DEMUX_TIMED_READS]]
    host_ms = {}
    for kit in (DEMUX_KIT, DEMUX_KIT_96):
        c = BarcodeClassifier(kit)
        t0 = time.perf_counter()
        for seq in timed_reads:
            c.classify(seq)
        host_ms[f"classify {kit}"] = (time.perf_counter() - t0) / len(timed_reads) * 1e3
    for kit in (DEMUX_KIT, None):  # None: every kit's adapters and primers
        t0 = time.perf_counter()
        for seq in timed_reads:
            find_adapters(seq, kit)
            find_primers(seq, kit)
        host_ms[f"find_adapters + find_primers, kit {kit}"] = (
            (time.perf_counter() - t0) / len(timed_reads) * 1e3)
    t0 = time.perf_counter()
    for ctx in contexts:
        host_calculator.calculate_num_bases(ctx)
    host_ms[f"calculate_num_bases, the hac run's {len(contexts)} records (planted primers "
            f"and tails)"] = (time.perf_counter() - t0) / len(contexts) * 1e3
    for what, ms in host_ms.items():
        print(f"demux host ms a read, one thread: {what} {ms:.3f} ms [host of {k.smi}]",
              flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"demux phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- several devices: replicas, the sharded step, two processes ------------
RNA_READS = 128  # direct-RNA reads of 40-60k samples at 4 kHz: about 700 chunks
RNA_READ_SAMPLES = (40_000, 60_001)
RNA_CPU_READS = 6  # of 15-25k samples, through the card's and the CPU's pipelines
RNA_CPU_SAMPLES = (15_000, 25_001)
MAX_RNA_SCORE_REL = 0.02  # hac's: bf16 W8A8 on the card against float32 on the CPU
RNA_FIXTURE = ROOT / "tests" / "data" / "torch_port" / "rna.pod5"
CRAM_RATE_READS = 128  # hac reads of 40-60k samples written as .bam and as .cram
CRAM_CONTIG = 30_000  # the seeded contig of the reference-based CRAM
CRAM_ALIGNED_READS = 60
CRAM_ALIGNED_LEN = (2_000, 5_001)


def rg_last(records) -> list[str]:
    """Each record's SAM line with its RG tag moved last, as a CRAM reader
    gives it back (the read group is a data series, not a tag)."""
    import copy

    out = []
    for rec in records:
        rec = copy.copy(rec)
        rec.tags = ([t for t in rec.tags if t.tag != "RG"]
                    + [t for t in rec.tags if t.tag == "RG"])
        out.append(rec.to_sam_line())
    return out


def rna_cram_phase(k, hac_cfg, hac_model) -> None:
    """Direct-RNA basecalling on the card and CRAM in and out (paths ``rna
    viterbi``, ``rna beam`` and ``cli rna cram``).

    - The RNA stand-in (``presets.rna004_hac_config``: hac v4.3's widths,
      RNA004 at 4 kHz) at full width, batch 128, W8A8, bf16, seeded weights,
      through ``run_reads`` with ``estimate_poly_a`` over RNA_READS seeded
      reads (``tests/torch_rna.py``: a DNA-adapter step, a third with an
      open-pore spike that splits them, half with a flat poly(A) stretch),
      with the Viterbi and the beam decoder: K1 and K2 5 times a batch, K3-K5
      (Viterbi) or the scans, K17 and the beam traceback (beam) once. Every
      read is written (subreads ``<id>:<i>``); each Viterbi record is its
      stitched call reversed (bases, qualities, moves), and its pt/pa equal
      the port's calculator on that call on the host. The scores and the
      decode against the CPU's float32 model (``hold_scores_and_decode``,
      hac's tolerance), one profiled device step, and RNA_CPU_READS reads
      through the card's pipeline and the CPU's (its decode and host code)
      on the card model's scores: the same records, subreads included.
    - The host's thread-seconds in each stage of the counted RNA runs and of
      the hac runs below (``host_stages``): on the scale pool the whole
      prepare, the RNA split, the adapter search and the scaler; in the
      finish pool (``host_finish_s``) the stitch, the mux-change trim, the
      record, the DNA split and poly(A); on the feed thread the waits in
      dispatch and fetch and the host decode.
    - CRAM: the Viterbi run's records as BAM, as CRAM with rANS and with
      gzip, each CRAM read back equal to the BAM; MB/s (bases and quality
      characters) and records/s of each writer. A reference-based CRAM of
      the ``aligner`` command over seeded reads of a seeded contig, read
      back through ``CramReader(ref_seqs=...)`` equal to its SAM; and
      ``read_records`` on it raises, naming the reference. hac v4.3's
      pipeline over CRAM_RATE_READS reads writing .bam and .cram files in
      turns (bam, cram, cram, bam): samples/s and the device's idle share
      of each pass.
    - The commands: ``basecaller <rna dir> rna.pod5 -o x.cram
      --estimate-poly-a`` (path ``cli rna cram``) equal to ``run_reads``
      with the same options and header; ``summary x.cram``, ``trim --rna
      x.cram`` and ``aligner <ref> x.cram -o y.cram``, each equal to the same
      command on the BAM of the same records; and ``--resume-from`` a CRAM
      of the first half of the records, which writes the whole run."""
    import contextlib
    import dataclasses
    import shlex
    import threading

    import numpy as np

    import dorado_tpu_torch.pipeline.basecaller as basecaller_module
    import dorado_tpu_torch.signal.scaling as scaling_module
    from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
    from dorado_tpu_torch.cli.main import main as cli_main
    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.io.cram import CramReader, CramWriter
    from dorado_tpu_torch.io.pod5 import Pod5File, RunInfo
    from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamRecord
    from dorado_tpu_torch.models.crf_model import init_lstm_crf_params
    from dorado_tpu_torch.models.load import build_model, load_model, save_model
    from dorado_tpu_torch.models.presets import rna004_hac_config
    from dorado_tpu_torch.pipeline import BasecallerPipeline
    from dorado_tpu_torch.pipeline.host import default_host_threads
    from dorado_tpu_torch.polytail.calculator import ReadContext
    from tests.torch_polish import polish_inputs, write_fasta, write_fastq
    from tests.torch_rna import rna_signal

    torch = k.torch
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_rna_"))
    cfg = rna004_hac_config()
    cfg.normalise_basecaller_params()
    model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(SEED + 24))
    with torch.no_grad():
        model.linear1_w.mul_(HEAD_GAIN)
    info = RunInfo(acquisition_id="rna-smoke", sample_rate=4000, flow_cell_id="FAL00000",
                   flow_cell_product_code="FLO-MIN004RA", protocol_run_id="rna-run",
                   acquisition_start_time_ms=1_700_000_000_000, sample_id="rna")
    rs = np.random.RandomState(SEED + 24)

    def rna_read(i, n):
        adapter = int(rs.randint(2_000, 4_001))
        polya = int(rs.randint(600, 1_501)) if i % 2 == 0 else 0
        return dataclasses.replace(smoke_read(i, 1, rs, info), filename="rna.pod5",
                                   signal=rna_signal(rs, n, adapter, polya, spikes=int(i % 3 == 1)))

    reads = [rna_read(2400 + i, int(rs.randint(*RNA_READ_SAMPLES))) for i in range(RNA_READS)]
    cpu_reads = [rna_read(2600 + i, int(rs.randint(*RNA_CPU_SAMPLES)))
                 for i in range(RNA_CPU_READS)]
    samples = sum(len(r.signal) for r in reads)
    pipes = {d: BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True,
                                   estimate_poly_a=True, decoder=d) for d in ("viterbi", "beam")}
    if pipes["viterbi"].runner.lstm_precision != "w8a8" or pipes["viterbi"].rna_splitter is None:
        raise AssertionError("the RNA pipeline is not W8A8 with the RNA splitter")
    rna_what = f"RNA stand-in at hac v4.3 width, batch {N}, bf16 with W8A8 projections"

    # the stitched calls of the counted Viterbi run, keyed by the record they
    # must give: (bases, qualities) reversed
    calls = {}
    real_mux_trim = basecaller_module.mux_change_trim

    def keep_call(seq, qstring, moves, signal, stride, end_reason):
        out = real_mux_trim(seq, qstring, moves, signal, stride, end_reason)
        calls[(out[0][::-1], out[1][::-1])] = (np.asarray(out[2]), out[3])
        return out

    # the host's thread-seconds in each stage of a counted run
    host_s = {}
    lock = threading.Lock()

    def add(stage, dt):
        with lock:
            host_s[stage] = host_s.get(stage, 0.0) + dt

    def timed(stage, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                add(stage, time.perf_counter() - t0)
        return wrapped

    real_pool, real_sink = basecaller_module.OrderedPool, basecaller_module.OrderedSink

    class TimedPool(real_pool):
        """The feed thread's wait for the next prepared read."""

        def map(self, items):
            it, done = super().map(items), object()
            while True:
                t0 = time.perf_counter()
                item = next(it, done)
                add("scale pool wait", time.perf_counter() - t0)
                if item is done:
                    return
                yield item

    class TimedSink(real_sink):
        """The feed thread's time handing reads to the finish pool and
        writing their records, waits for a full window included."""

        def submit(self, item):
            t0 = time.perf_counter()
            try:
                super().submit(item)
            finally:
                add("finish pool handoff", time.perf_counter() - t0)

        def drain_ready(self):
            t0 = time.perf_counter()
            try:
                super().drain_ready()
            finally:
                add("finish pool handoff", time.perf_counter() - t0)

        def drain_all(self):
            t0 = time.perf_counter()
            try:
                super().drain_all()
            finally:
                add("finish pool handoff", time.perf_counter() - t0)

    def instrument(pipe):
        pipe._prepare_read = timed("prepare", pipe._prepare_read)
        pipe.scaler.scale_read = timed("scale", pipe.scaler.scale_read)
        pipe._make_record = timed("record", pipe._make_record)
        if pipe.rna_splitter is not None:
            pipe.rna_splitter.split = timed("rna split", pipe.rna_splitter.split)
        if pipe.read_splitter is not None:
            pipe.read_splitter.split = timed("dna split", pipe.read_splitter.split)
        if pipe.poly_tail_selector is not None:
            calc = pipe.poly_tail_selector.get_calculator(None)  # every read's: one config
            calc.calculate_num_bases = timed("poly(A)", calc.calculate_num_bases)

    real_stitch = basecaller_module.stitch_chunks
    real_adapter_pos = scaling_module.determine_rna_adapter_pos

    @contextlib.contextmanager
    def host_stages(mux_trim=real_mux_trim):
        """Times the module-level stages (the adapter search, the stitch, the
        mux-change trim) for the run inside, from zeroed counts."""
        host_s.clear()
        scaling_module.determine_rna_adapter_pos = timed("adapter", real_adapter_pos)
        basecaller_module.stitch_chunks = timed("stitch", real_stitch)
        basecaller_module.mux_change_trim = timed("mux trim", mux_trim)
        basecaller_module.OrderedPool, basecaller_module.OrderedSink = TimedPool, TimedSink
        try:
            yield
        finally:
            scaling_module.determine_rna_adapter_pos = real_adapter_pos
            basecaller_module.stitch_chunks = real_stitch
            basecaller_module.mux_change_trim = real_mux_trim
            basecaller_module.OrderedPool, basecaller_module.OrderedSink = real_pool, real_sink

    def stage_line(stats):
        def stages(names):
            return ", ".join(f"{st} {host_s[st]:.3f}" for st in names if st in host_s)

        feed = (stats.dispatch_wait_s + stats.finish_wait_s + host_s.get("scale pool wait", 0.0)
                + host_s.get("finish pool handoff", 0.0))
        return (f"scale pool {stages(('prepare', 'rna split', 'adapter', 'scale'))}; finish "
                f"pool host_finish_s {stats.host_finish_s:.3f}: "
                f"{stages(('stitch', 'mux trim', 'record', 'dna split', 'poly(A)'))}; feed thread "
                f"of {stats.elapsed_s:.3f} wall: dispatch {stats.dispatch_wait_s:.3f}, batch "
                f"results {stats.finish_wait_s:.3f} (fetch {stats.device_fetch_s:.3f}, host "
                f"decode {stats.host_decode_s:.3f}), "
                f"{stages(('scale pool wait', 'finish pool handoff', 'write'))}, the rest "
                f"{stats.elapsed_s - feed:.3f} ({default_host_threads()} threads a pool; "
                f"thread-s)")

    records = {}
    for decoder in ("viterbi", "beam"):
        path, pipe = f"rna {decoder}", pipes[decoder]
        k.path_kernels[path] = k.path_kernels[decoder]
        k.per_batch[path] = [5, 5, 1, 1, 1]
        pipe.run_reads(reads[:16], k.Discard())  # the per-shape set-up, reused below
        torch.cuda.synchronize()
        instrument(pipe)
        for w in k.wrappers.values():
            w.launches = 0
        written = Collect()
        written.write = timed("write", written.write)
        with host_stages(keep_call if decoder == "viterbi" else real_mux_trim):
            t0 = time.perf_counter()
            stats = pipe.run_reads(reads, written)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k.launches[path] = {name: w.launches for name, w in k.wrappers.items()}
        k.check_launches(path, k.launches[path], stats.batches)
        recs = records[decoder] = written.records
        parents = {r.qname.split(":")[0] for r in recs}
        subreads = sum(":" in r.qname for r in recs)
        tags = [{t.tag: t.value for t in r.tags} for r in recs]
        if (parents != {r.read_id for r in reads} or not subreads or stats.bases_called == 0
                or not all("pt" in t and "pa" in t for t in tags)
                or sum(t["ts"] > 0 for t in tags) < len(reads) // 2):
            raise AssertionError(f"{path}: {len(parents)} of {len(reads)} reads written, "
                                 f"{subreads} subreads, {stats.bases_called} bases, pt/pa or "
                                 f"the adapter trim missing")
        print(f"{path} pipeline: {len(reads)} reads, {samples} samples, {stats.batches} batches, "
              f"{len(recs)} records ({subreads} subreads), {stats.bases_called} bases, "
              f"{sum(t['pt'] >= 0 for t in tags)} with a poly(A) estimate in {wall:.3f} s = "
              f"{samples / wall:.0f} samples/s; device idle {stats.device_idle_frac:.1%}; host "
              f"finish {stats.host_finish_s:.3f} thread-s ({rna_what}, {decoder}, "
              f"--estimate-poly-a) [{k.smi}]; launches "
              f"{ {n: v for n, v in k.launches[path].items() if v} }", flush=True)
        print(f"{path} host stages: {stage_line(stats)}", flush=True)
    # the Viterbi records: reversed calls, pt/pa of the host's calculator
    calculator = pipes["viterbi"].poly_tail_selector.get_calculator(None)
    poly_s = 0.0
    for rec in records["viterbi"]:
        tags = {t.tag: t.value for t in rec.tags}
        moves, signal = calls[(rec.seq, rec.qual)]
        t0 = time.perf_counter()
        poly = calculator.calculate_num_bases(ReadContext(
            seq=rec.seq, moves=np.asarray(tags["mv"][1:]), signal=signal, stride=cfg.stride,
            num_trimmed_samples=tags["ts"], flow_cell_product_code=info.flow_cell_product_code))
        poly_s += time.perf_counter() - t0
        pa = [poly.signal_anchor, *poly.signal_range, *poly.split_signal_range]
        if (not np.array_equal(np.asarray(tags["mv"][1:]), moves[::-1])
                or tags["pt"] != (poly.num_bases if poly.num_bases >= 0 else -1)
                or list(np.asarray(tags["pa"])) != pa):
            raise AssertionError(f"rna viterbi: {rec.qname} is not its call reversed, or its "
                                 f"pt/pa are not the host calculator's")
    if [r.qname for r in records["beam"]] != [r.qname for r in records["viterbi"]]:
        raise AssertionError("rna beam: other records than the Viterbi run's")
    print(f"rna viterbi: every record is its stitched call reversed (bases, qualities, moves), "
          f"its pt/pa the host calculator's on it ({poly_s / len(records['viterbi']) * 1e3:.2f} "
          f"ms a record, one thread); rna beam writes the same record names", flush=True)

    # ---- the card against the CPU --------------------------------------------
    cpu_runner = TorchBasecallRunner(cfg, model, device="cpu", lstm_precision="w8a8",
                                     batch_size=N)
    hold_scores_and_decode(k, "rna bf16", pipes["viterbi"].runner, cpu_runner,
                           chunk_signals(pipes["viterbi"], reads[:4]), MAX_RNA_SCORE_REL)
    profiled_step(k, "rna viterbi", pipes["viterbi"].runner)

    class CardScores(torch.nn.Module):
        """The card model's scores in the type the card decodes them (bf16),
        handed to the CPU as float32: the CPU pipeline decodes the same
        values."""

        def __init__(self, runner):
            super().__init__()
            self.card_model, self.score_dtype = runner.model, runner.score_dtype

        def forward(self, sig):
            return self.card_model(sig.to(k.dev)).to(self.score_dtype).float().cpu()

    # the CPU pipeline (its decode, stitch, split, trim, reversal, poly(A) and
    # tags) over the card model's scores, against the card's pipeline
    cpu_pipe = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True,
                                  estimate_poly_a=True, device="cpu")
    cpu_pipe.runner.replicas[0].model = CardScores(pipes["viterbi"].runner)
    on_card, on_cpu = Collect(), Collect()
    pipes["viterbi"].run_reads(cpu_reads, on_card)
    t0 = time.perf_counter()
    cpu_pipe.run_reads(cpu_reads, on_cpu)
    cpu_s = time.perf_counter() - t0
    a = sorted(rg_last(on_card.records))
    b = sorted(rg_last(on_cpu.records))
    split = sum(":" in r.qname for r in on_card.records)
    if a != b or not split:
        raise AssertionError(f"rna: {len(a)} records on the card, {len(b)} from the CPU "
                             f"pipeline on the card's scores, {split} subreads; equal: "
                             f"{a == b}")
    print(f"rna: {len(a)} records ({split} subreads) of {RNA_CPU_READS} reads, the card's "
          f"pipeline equal to the CPU's (its decode and host code, {cpu_s:.1f} s) on the card "
          f"model's scores", flush=True)

    # ---- CRAM out and in ---------------------------------------------------
    recs = records["viterbi"]
    header = pipes["viterbi"].build_header([info])
    payload = sum(len(r.seq) + len(r.qual) for r in recs)
    files = {}
    for label, cls, kw in (("bam", BamWriter, {}), ("cram rans", CramWriter, {}),
                           ("cram gzip", CramWriter, {"rans": False})):
        out = tmp / f"rna_{label.replace(' ', '_')}.{label.split()[0]}"
        t0 = time.perf_counter()
        with open(out, "wb") as fh:
            writer = cls(fh, header, **kw)
            for rec in recs:
                writer.write(rec)
            writer.close()
        dt = time.perf_counter() - t0
        files[label] = out
        print(f"{label} writer: {len(recs)} records, {payload} bytes of bases and qualities in "
              f"{dt:.3f} s = {payload / dt / 1e6:.3f} MB/s, {len(recs) / dt:.0f} records/s; "
              f"{out.stat().st_size} bytes written (host of [{k.smi}])", flush=True)
    want = rg_last(read_records(files["bam"])[1])
    for label in ("cram rans", "cram gzip"):
        t0 = time.perf_counter()
        got = rg_last(read_records(files[label])[1])
        if got != want or files[label].read_bytes()[:4] != b"CRAM":
            raise AssertionError(f"{label}: reads back other records than the BAM's")
        print(f"{label}: read back equal to the BAM in {time.perf_counter() - t0:.3f} s",
              flush=True)

    # a reference-based CRAM through the aligner command
    contig, _, aligned_reads = polish_inputs(SEED + 25, CRAM_CONTIG, CRAM_ALIGNED_READS,
                                             CRAM_ALIGNED_LEN, error=0.03, draft_error=0.0)
    ref = write_fasta(tmp / "contig.fa", [("contig", contig)])
    fastq = write_fastq(tmp / "aligned.fastq", aligned_reads)
    outs = {}
    for fmt, extra in (("cram", []), ("sam", ["--emit-sam"])):
        outs[fmt] = tmp / f"aligned.{fmt}"
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["aligner", str(ref), str(fastq), *extra, "-o", str(outs[fmt])])
        if rc != 0:
            raise AssertionError(f"aligner -o aligned.{fmt}: exit code {rc}")
    sam = read_records(outs["sam"])[1]
    back = list(CramReader(outs["cram"], ref_seqs={"contig": contig}).records())
    for rec in back:  # the reader computes MD where the record had none
        rec.tags = [t for t in rec.tags if t.tag != "MD"]
    mapped = sum(not r.flag & 4 for r in sam)
    if rg_last(back) != rg_last(sam) or mapped < CRAM_ALIGNED_READS // 2:
        raise AssertionError(f"aligner -o aligned.cram: {len(back)} records read back through "
                             f"ref_seqs, not the SAM's {len(sam)} ({mapped} mapped)")
    try:
        read_records(outs["cram"])
    except ValueError as exc:
        if "contig" not in str(exc):
            raise
        refusal = str(exc)
    else:
        raise AssertionError("read_records read a reference-based CRAM without a reference")
    print(f"aligner -o aligned.cram: reference-based ({outs['cram'].stat().st_size} bytes, the "
          f"SAM {outs['sam'].stat().st_size}), {len(back)} records ({mapped} mapped) read back "
          f"through CramReader(ref_seqs) equal to the SAM's; read_records raises: {refusal}",
          flush=True)

    # .cram against .bam at hac's width: the writer's write runs on the
    # pipeline's feed thread, which encodes a slice each 4,096 records; a run
    # of fewer records is encoded by the close after it, inside the wall time
    rate_reads = [k.make_read(2700 + i, int(rs.randint(*RNA_READ_SAMPLES)), rs)
                  for i in range(CRAM_RATE_READS)]
    rate_samples = sum(len(r.signal) for r in rate_reads)
    hac_pipe = BasecallerPipeline(hac_cfg, hac_model, batch_size=N)
    hac_pipe.run_reads(rate_reads[:16], k.Discard())
    torch.cuda.synchronize()
    instrument(hac_pipe)
    passes = []
    for label in ("bam", "cram", "cram", "bam"):
        out = tmp / f"rate.{label}"
        with host_stages():
            t0 = time.perf_counter()
            with open(out, "wb") as fh:
                writer = (CramWriter if label == "cram" else BamWriter)(
                    fh, hac_pipe.build_header([smoke_run_info()]))
                writer.write = timed("write", writer.write)
                stats = hac_pipe.run_reads(rate_reads, writer)
                t_close = time.perf_counter()
                writer.close()
                close_s = time.perf_counter() - t_close
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        passes.append((label, rate_samples / wall, stats.device_idle_frac))
        print(f"hac pipeline writing .{label}: {len(rate_reads)} reads, {rate_samples} samples in "
              f"{wall:.3f} s = {rate_samples / wall:.0f} samples/s; device idle "
              f"{stats.device_idle_frac:.1%}; {out.stat().st_size} bytes (hac v4.3, batch {N}, "
              f"W8A8, Viterbi) [{k.smi}]; host stages: {stage_line(stats)}; the writer's close "
              f"after the run {close_s:.3f} s", flush=True)
    rate = {label: np.mean([r for lab, r, _ in passes if lab == label])
            for label in ("bam", "cram")}
    print(f"hac samples/s writing .cram / writing .bam: {rate['cram'] / rate['bam']:.3f} "
          f"({rate['cram']:.0f} / {rate['bam']:.0f}) [{k.smi}]", flush=True)

    # ---- the commands ---------------------------------------------------------
    model_dir = save_model(cfg, model, tmp / cfg.model_name)
    k.path_kernels["cli rna cram"] = k.path_kernels["viterbi"]
    cram = tmp / "calls.cram"
    argv = ["basecaller", str(model_dir), str(RNA_FIXTURE), "--estimate-poly-a", "-o", str(cram)]
    for w in k.wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k.launches["cli rna cram"] = {name: w.launches for name, w in k.wrappers.items()}
    k.check_launches("cli rna cram", k.launches["cli rna cram"], 0)
    config, loaded = load_model(model_dir)
    pipe = BasecallerPipeline(config, build_model(config, loaded), estimate_poly_a=True)
    fixture_reads = list(Pod5File(RNA_FIXTURE).reads(strict=True))
    for r in fixture_reads:
        r.filename = RNA_FIXTURE.name
    ref_header = pipe.build_header([RNA_FIXTURE], cli_line=shlex.join(["dorado_tpu_torch", *argv]))
    want = Collect()
    pipe.run_reads(fixture_reads, want)
    cli_text, cli_recs = read_records(cram)
    if (rc != 0 or cram.read_bytes()[:4] != b"CRAM" or cli_text != ref_header.to_text()
            or rg_last(cli_recs) != rg_last(want.records)):
        raise AssertionError(f"cli rna cram: exit code {rc}, or not CRAM, or other records than "
                             f"run_reads'")
    print(f"cli rna cram (path 'cli rna cram'): basecaller <rna dir> rna.pod5 --estimate-poly-a "
          f"-o calls.cram: {len(cli_recs)} records of {len(fixture_reads)} reads in {wall:.2f} s, "
          f"equal to run_reads' [{k.smi}]", flush=True)
    bam = tmp / "calls.bam"
    with open(bam, "wb") as fh:
        writer = BamWriter(fh, ref_header)
        for rec in want.records:
            writer.write(rec)
        writer.close()

    def command(*args, stdout=False):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(list(args))
        if rc != 0:
            raise AssertionError(f"{' '.join(args)}: exit code {rc}: {err.getvalue()}")
        return out.getvalue()

    if command("summary", str(cram)) != command("summary", str(bam)):
        raise AssertionError("summary calls.cram differs from summary calls.bam")
    command("trim", "--rna", str(cram), "-o", str(tmp / "trim_cram.bam"))
    command("trim", str(bam), "-o", str(tmp / "trim_bam.bam"))
    command("aligner", str(ref), str(cram), "-o", str(tmp / "realigned.cram"))
    command("aligner", str(ref), str(bam), "-o", str(tmp / "realigned_bam.cram"))
    trimmed = [read_records(tmp / f"trim_{x}.bam")[1] for x in ("cram", "bam")]
    realigned = [list(CramReader(tmp / f"realigned{x}.cram", ref_seqs={"contig": contig})
                      .records()) for x in ("", "_bam")]
    if rg_last(trimmed[0]) != rg_last(trimmed[1]) or rg_last(realigned[0]) != rg_last(realigned[1]):
        raise AssertionError("trim --rna or aligner on calls.cram differ from the same on the BAM")
    # --resume-from a CRAM of the first half of the records
    half = len(want.records) // 2
    cut = tmp / "cut.cram"
    with open(cut, "wb") as fh:
        writer = CramWriter(fh, ref_header)
        for rec in want.records[:half]:
            writer.write(rec)
        writer.close()
    resumed = tmp / "resumed.cram"
    command(*argv[:-1], str(resumed), "--resume-from", str(cut))
    # the command skips each record's pi or name, as the JAX command does: an
    # RNA subread names no parent, so a split read is called again
    skip = {r.qname for r in want.records[:half]}
    whole = want.records[:half] + [r for r in want.records if r.qname.split(":")[0] not in skip]
    if rg_last(read_records(resumed)[1]) != rg_last(whole):
        raise AssertionError("basecaller --resume-from cut.cram: not the cut's records and "
                             "run_reads' records of the reads it skips not")
    print(f"summary, trim --rna and aligner on calls.cram equal to the same on its BAM; "
          f"--resume-from a CRAM of {half} records wrote them and the {len(whole) - half} "
          f"records of the reads they do not name", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"RNA and CRAM phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


MULTI_READS = 192  # reads of 40-60k samples: about 1000 chunks, 8 batches of 128
MULTI_READ_SAMPLES = (40_000, 60_001)
# each process's reads for the two-process rates (``multi_rate_reads``): 96 of
# MULTI_READ_SAMPLES, about 500 chunks, 4 batches of 128; one process takes
# both processes' 192. The committed shards (16 reads, less than a batch) are
# for the file sharding, the stats, the barrier and the merge only.
MULTI_RATE_READS = 96
SHARDS_DIR = ROOT / "tests" / "data" / "torch_port" / "shards"
MULTI_CHILD_TIMEOUT_S = 240
# passes over the reads of each timed rate: one pass over 192 reads takes
# about 1.3 s with one replica, too short a window on a host-bound run
MULTI_RATE_PASSES = 3
# card against card: records (replicas, processes) and Viterbi rows (the
# sharded step, against the unsharded step over the same rows) that may
# differ from the one-device run's
MULTI_MAX_RECORDS_DIFFERENT = 0
MULTI_MAX_ROWS_DIFFERENT = 0
# the 2 x 1 step's scores against the unsharded step's over all N rows: the
# unquantised bf16 projections and head run cuBLAS at M = T x N/2 rows, which
# picks other kernels than at T x N, so a score moves by up to one bf16 step
# (2^-5 at the head's clamp of 5); on white noise's dense near-ties that
# reroutes most Viterbi paths, so the paths are held over the same rows
MULTI_MAX_SCORE_ERR = 2.0**-5

MULTI_CHILD = r"""
import json, sys, time
from pathlib import Path

root, addr, rank, data, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]
seed, gain, batch, passes = int(sys.argv[6]), float(sys.argv[7]), int(sys.argv[8]), int(sys.argv[9])
sys.path.insert(0, root)
import torch

from chip_smoke import multi_rate_reads
from dorado_tpu_torch.io.pod5 import find_pod5_files
from dorado_tpu_torch.io.sam import BamWriter
from dorado_tpu_torch.models.crf_model import init_lstm_crf_params
from dorado_tpu_torch.models.presets import hac_v43_config
from dorado_tpu_torch.parallel.distributed import (
    all_reduce_stats, barrier, host_output_path, init_distributed, merge_host_bams,
    shard_files_for_host,
)
from dorado_tpu_torch.pipeline import BasecallerPipeline


class Discard:
    def write(self, rec):
        pass


assert init_distributed(addr, num_processes=2, process_id=rank) == (rank, 2)
cfg = hac_v43_config()
cfg.normalise_basecaller_params()
model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(seed))
with torch.no_grad():
    model.linear1_w.mul_(gain)
pipe = BasecallerPipeline(cfg, model, batch_size=batch, emit_moves=True, device="cuda:0")
files = find_pod5_files(data)
mine = shard_files_for_host(files)
reads = multi_rate_reads(rank)
pipe.run_reads(reads[:24], Discard())  # the per-shape set-up, reused below
torch.cuda.synchronize()
barrier("start")  # both processes time their passes over the card together
start = time.time()  # the host's clock, shared by both processes
for _ in range(passes):
    pipe.run_reads(reads, Discard())
torch.cuda.synchronize()
end = time.time()
totals = {"reads": 0.0, "bases": 0.0, "samples": 0.0}
with open(host_output_path(out), "wb") as fh:
    writer = BamWriter(fh, pipe.build_header(files))  # every process: the same header
    for f in mine:
        stats = pipe.run(f, writer)
        totals["reads"] += stats.reads_called
        totals["bases"] += stats.bases_called
        totals["samples"] += stats.samples_processed
    writer.close()
summed = all_reduce_stats(totals)
barrier("pre-merge")
appended = merge_host_bams(out, 2) if rank == 0 else 0
barrier("post-merge")
print("MULTI_PROCESS " + json.dumps({
    "rank": rank, "files": [f.name for f in mine], "local": totals, "summed": summed,
    "samples": sum(len(r.signal) for r in reads) * passes, "start": start, "end": end,
    "appended": appended,
}), flush=True)
"""


def multi_rate_reads(rank: int) -> list:
    """Process ``rank``'s reads for the two-process rates: MULTI_RATE_READS
    reads of MULTI_READ_SAMPLES samples, as ``smoke_read`` draws them, from
    a generator seeded by the rank."""
    import numpy as np

    gen = np.random.RandomState(SEED + 190 + rank)
    info = smoke_run_info()
    return [smoke_read(19_000 + 1_000 * rank + i, int(gen.randint(*MULTI_READ_SAMPLES)), gen,
                       info) for i in range(MULTI_RATE_READS)]


def timed_passes(k, pipe, reads, first_writer) -> tuple[list, object]:
    """MULTI_RATE_PASSES timed ``run_reads`` over ``reads``, the first into
    ``first_writer``: each pass's seconds and the first pass's stats."""
    seconds, first = [], None
    for i in range(MULTI_RATE_PASSES):
        t0 = time.perf_counter()
        stats = pipe.run_reads(reads, first_writer if i == 0 else k.Discard())
        k.torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        first = first or stats
    return seconds, first


def records_differing(want, got, what) -> int:
    """How many of ``got``'s records differ from ``want``'s (SAM lines,
    matched by name); raises when the names differ."""
    if sorted(r.qname for r in want) != sorted(r.qname for r in got):
        raise AssertionError(f"{what}: the records' names differ from the one-device run's")
    by_name = {r.qname: r.to_sam_line() for r in want}
    return sum(by_name[r.qname] != r.to_sam_line() for r in got)


class Collect:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


def multi_gpu_phase(k, cfg, model) -> None:
    """Several devices at hac v4.3's full width (W8A8, the seed's weights):
    every visible card when there are more than one, else two replicas on
    card 0 (``[cuda:0, cuda:0]``).

    - Replicas: ``run_reads`` over MULTI_READS reads with one replica and
      with the replicas, Viterbi and beam, the records held against the one
      replica's (MULTI_MAX_RECORDS_DIFFERENT), each replica's step launching
      its path's kernels for each of its batches (paths ``replicas
      viterbi``, ``replicas beam``); ``DeviceMonitor`` on card 0 sampled
      through a ``StatsSampler`` during the Viterbi run.
    - The sharded step on a 2 x 1 and a 1 x 2 mesh over those devices at N =
      128, chunk 9996 (unquantised, bf16), its states and moves held against
      the 1 x 1 step's over the same rows (MULTI_MAX_ROWS_DIFFERENT), its
      scores against the 1 x 1 step's over all rows (MULTI_MAX_SCORE_ERR):
      K1, K6, K7a and K5 under paths ``sharded 2x1`` and ``sharded 1x2``.
    - Two processes on card 0 (gloo over 127.0.0.1), each basecalling its
      share of the four committed POD5 shards into its BAM; the stats summed,
      a barrier, process 0's merge; the merged BAM held against a
      one-process run's records, host 0's first.
    - ``basecaller -x cuda --dump-stats-file``: the CSV has ``basecaller.``
      and ``device.`` columns.
    - The rates, each over MULTI_RATE_PASSES passes of ``run_reads``: one
      replica and the replicas over the MULTI_READS reads; each process over
      its own MULTI_RATE_READS reads (``multi_rate_reads``), both timed after
      a barrier, and the two together over their windows' span; one process
      over both processes' reads."""
    import socket

    torch = k.torch
    import numpy as np

    from dorado_tpu_torch.cli.main import main as cli_main
    from dorado_tpu_torch.io.bam_reader import read_bam
    from dorado_tpu_torch.io.sam import BamWriter
    from dorado_tpu_torch.models.load import save_model
    from dorado_tpu_torch.parallel import make_mesh, make_sharded_basecall_step, shard_params
    from dorado_tpu_torch.pipeline import BasecallerPipeline
    from dorado_tpu_torch.utils.device_monitor import DeviceMonitor, describe_devices
    from dorado_tpu_torch.utils.stats import StatsSampler

    count = torch.cuda.device_count()
    print(f"multi-GPU phase: torch.cuda.device_count() = {count}", flush=True)
    for line in describe_devices():
        print(f"  {line}", flush=True)
    card0 = torch.device("cuda", 0)
    devices = [torch.device("cuda", i) for i in range(count)] if count > 1 else [card0] * 2
    where = f"{len(devices)} replicas on {len({str(d) for d in devices})} card(s)"
    rs = np.random.RandomState(SEED + 19)
    reads = [k.make_read(1900 + i, int(rs.randint(*MULTI_READ_SAMPLES)), rs)
             for i in range(MULTI_READS)]
    samples = sum(len(r.signal) for r in reads)
    rates = {}

    # ---- replicas ----------------------------------------------------------
    k.path_kernels["replicas viterbi"] = k.path_kernels["viterbi"]
    k.path_kernels["replicas beam"] = k.path_kernels["beam"]
    k.per_batch["replicas viterbi"] = k.per_batch["replicas beam"] = [5, 5, 1, 1, 1]
    for decoder in ("viterbi", "beam"):
        outs = {}
        for label, device in (("one replica", card0), (where, devices)):
            pipe = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True, device=device,
                                      decoder=decoder)
            pipe.run_reads(reads, k.Discard())  # the per-shape set-up, reused below
            torch.cuda.synchronize()
            for w in k.wrappers.values():
                w.launches = 0
            steps = pipe.runner.stats.batches_called
            monitor = StatsSampler({"device": DeviceMonitor(card0).sample_stats}, period_s=0.02)
            written = Collect()
            monitor.start()
            seconds, stats = timed_passes(k, pipe, reads, written)
            monitor.stop()
            elapsed = sum(seconds)
            steps = pipe.runner.stats.batches_called - steps
            outs[label] = written.records
            rates[f"{label}, {decoder}"] = samples * len(seconds) / elapsed
            if label != "one replica":
                path = f"replicas {decoder}"
                k.launches[path] = {name: w.launches for name, w in k.wrappers.items()}
                k.check_launches(path, k.launches[path], steps)
                shares = [r.stats.batches_called for r in pipe.runner.replicas]
                if len(pipe.runner.replicas) != len(devices) or min(shares) == 0:
                    raise AssertionError(f"{path}: replicas' steps {shares}")
                in_use = [r.get("device.hbm_bytes_in_use", 0) for r in monitor.records]
                limits = {r.get("device.hbm_bytes_limit") for r in monitor.records}
                total = torch.cuda.get_device_properties(0).total_memory
                print(f"  DeviceMonitor(cuda:0) over {len(monitor.records)} samples: bytes in "
                      f"use up to {max(in_use)}, limit {limits} (the card's total_memory "
                      f"{total}, mem_get_info {torch.cuda.mem_get_info(0)[1]})", flush=True)
                if max(in_use) <= 0 or limits != {float(torch.cuda.mem_get_info(0)[1])}:
                    raise AssertionError("DeviceMonitor: no bytes in use, or a limit that is "
                                         "not the card's total")
            print(f"{decoder}, {label}: {len(seconds)} passes over {len(reads)} reads, "
                  f"{samples} samples, {stats.batches} batches a pass, {steps} replica steps in "
                  f"all, {stats.bases_called} bases a pass, the first pass with no batch "
                  f"in flight {stats.device_idle_frac:.1%} of its time (host clock), in "
                  f"{elapsed:.3f} s = "
                  f"{samples * len(seconds) / elapsed:.0f} samples/s (passes: "
                  f"{', '.join(f'{samples / t:.0f}' for t in seconds)}) [{k.smi}]", flush=True)
        differing = records_differing(outs["one replica"], outs[where], f"replicas {decoder}")
        print(f"replicas {decoder}: {differing} of {len(outs[where])} records differ from the "
              f"one replica's", flush=True)
        if differing > MULTI_MAX_RECORDS_DIFFERENT:
            raise AssertionError(f"replicas {decoder}: {differing} records differ")
    torch.cuda.empty_cache()

    # ---- the sharded step ----------------------------------------------------
    sig = rs.randn(N, T * cfg.stride).astype(np.float32)
    one = make_mesh(devices=[card0])
    ref_params, ref_step = shard_params(model, one, cfg), make_sharded_basecall_step(cfg, one)
    ref_step(ref_params, sig)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ref_step(ref_params, sig)
    torch.cuda.synchronize()
    print(f"sharded 1x1 step (N = {N}, T = {T}, bf16): {(time.perf_counter() - t0) * 1e3:.2f} ms "
          f"wall [{k.smi}]", flush=True)
    # the unsharded step over each data group's rows: the 2 x 1 step's work
    halves = [ref_step(ref_params, sig[: N // 2]), ref_step(ref_params, sig[N // 2 :])]
    by_group = tuple(torch.cat([h[i] for h in halves]) for i in range(3))
    ref_scores = make_sharded_basecall_step(cfg, one, decoder="beam")(ref_params, sig)[0]
    del ref_params, ref_step, halves
    mesh21 = make_mesh(devices=devices[:2], data=2)
    for name, mesh, want in (("sharded 2x1", mesh21, by_group),
                             ("sharded 1x2", make_mesh(devices=devices[:2], model=2), ref)):
        k.path_kernels[name] = ["lstm_scan", "crf_lse_scans", "crf_viterbi_forward",
                                "crf_traceback"]
        k.per_batch[name] = [5, 1, 1, 1]
        sharded = shard_params(model, mesh, cfg)
        step = make_sharded_basecall_step(cfg, mesh)
        scores = make_sharded_basecall_step(cfg, mesh, decoder="beam")(sharded, sig)[0]
        score_err = (scores - ref_scores).abs().max().item()
        del scores
        step(sharded, sig)
        torch.cuda.synchronize()
        for w in k.wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        states, moves, posts = step(sharded, sig)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        k.launches[name] = {n: w.launches for n, w in k.wrappers.items()}
        k.check_launches(name, k.launches[name], mesh.shape["data"])
        if states.shape != (N, T) or moves.shape != (N, T) or posts.shape != (N, T + 1, S):
            raise AssertionError(f"{name}: shapes {states.shape} {moves.shape} {posts.shape}")
        rows = ((states != want[0]) | (moves != want[1])).any(dim=1)
        post_err = (posts - want[2]).abs().max().item()
        apart = (states != ref[0]) | (moves != ref[1])
        print(f"{name} step (N = {N}, T = {T}, bf16): {ms:.2f} ms wall; against the unsharded "
              f"step over the same rows {int(rows.sum())} of {N} rows' states or moves differ, "
              f"posts by up to {post_err:.3g}; against the unsharded step over all {N} rows: "
              f"scores by up to {score_err:.3g}, posts by up to "
              f"{(posts - ref[2]).abs().max().item():.3g}, {int(apart.any(dim=1).sum())} rows "
              f"and {float(apart.float().mean()):.4%} of positions differ; "
              f"{float(moves.float().mean()):.3f} moves a step [{k.smi}]", flush=True)
        if (int(rows.sum()) > MULTI_MAX_ROWS_DIFFERENT or score_err > MULTI_MAX_SCORE_ERR
                or not moves.float().mean() > 0.05):
            raise AssertionError(f"{name}: {int(rows.sum())} rows differ, scores by {score_err}, "
                                 f"or no moves")
        del sharded, step, states, moves, posts
    del ref, by_group, ref_scores
    torch.cuda.empty_cache()

    # ---- two processes on card 0 -----------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        tmp = Path(tmp)
        child = tmp / "child.py"
        child.write_text(MULTI_CHILD)
        out = tmp / "calls.bam"
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
        sock.close()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(child), str(ROOT), addr, str(rank), str(SHARDS_DIR), str(out),
             str(SEED), str(HEAD_GAIN), str(N), str(MULTI_RATE_PASSES)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
        results = []
        try:
            for p in procs:
                stdout, stderr = p.communicate(timeout=MULTI_CHILD_TIMEOUT_S)
                line = next((l for l in stdout.splitlines() if l.startswith("MULTI_PROCESS ")),
                            None)
                if p.returncode != 0 or line is None:
                    raise AssertionError(f"two processes: a child exited {p.returncode}:\n"
                                         f"{stderr[-3000:]}")
                results.append(json.loads(line.split(" ", 1)[1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        merged = read_bam(out)[1]
        # one process over both processes' reads, timed as they were
        pipe = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True, device=card0)
        both = multi_rate_reads(0) + multi_rate_reads(1)
        pipe.run_reads(both[:24], k.Discard())  # the per-shape set-up, reused below
        torch.cuda.synchronize()
        seconds, _ = timed_passes(k, pipe, both, k.Discard())
        one_rate = sum(len(r.signal) for r in both) * len(seconds) / sum(seconds)
        rates["one process on cuda:0"] = one_rate
        # one process over the same files, into a BAM read back the same way
        files = sorted(SHARDS_DIR.glob("*.pod5"))
        single = tmp / "single.bam"
        by_file = {}  # each file's records: (first, end) in the one-process BAM
        with open(single, "wb") as fh:
            writer = BamWriter(fh, pipe.build_header(files))
            for f in files:
                first = writer.records_written
                pipe.run(f, writer)
                by_file[f.name] = first, writer.records_written
            writer.close()
        want = read_bam(single)[1]
        host0 = [want[i].qname for f in results[0]["files"] for i in range(*by_file[f])]
        summed = results[0]["summed"]
        differing = records_differing(want, merged, "two processes")
        print(f"two processes on cuda:0: {wall:.1f} s in all; files {results[0]['files']} and "
              f"{results[1]['files']}; summed stats {summed}; {results[0]['appended']} records "
              f"appended to process 0's {len(merged) - results[0]['appended']}; {differing} of "
              f"{len(merged)} records differ from one process's", flush=True)
        if ([r.qname for r in merged[:len(host0)]] != host0
                or summed["reads"] != len(merged) or summed != results[1]["summed"]
                or differing > MULTI_MAX_RECORDS_DIFFERENT):
            raise AssertionError("two processes: the merged BAM is not one process's records, "
                                 "host 0's first, or the summed stats disagree")
        for r in results:
            rates[f"process {r['rank']} of 2 on cuda:0"] = r["samples"] / (r["end"] - r["start"])
        start, end = min(r["start"] for r in results), max(r["end"] for r in results)
        overlap = ((min(r["end"] for r in results) - max(r["start"] for r in results))
                   / (end - start))
        rates["two processes on cuda:0, together"] = (sum(r["samples"] for r in results)
                                                       / (end - start))
        windows = ", ".join(f"{r['end'] - r['start']:.3f} s" for r in results)
        print(f"two processes' timed windows {windows}, overlapping over {overlap:.1%} of their "
              f"span of {end - start:.3f} s; one process over both's {len(both)} reads: "
              f"{sum(seconds):.3f} s", flush=True)

        # ---- the command line with --dump-stats-file ---------------------------
        model_dir = save_model(cfg, model, tmp / cfg.model_name)
        csv_path = tmp / "stats.csv"
        rc = cli_main(["basecaller", str(model_dir), str(SHARDS_DIR), "-x", "cuda", "--emit-sam",
                       "-o", str(tmp / "cli.sam"), "--dump-stats-file", str(csv_path)])
        lines = csv_path.read_text().splitlines()
        head = lines[0].split(",") if lines else []
        print(f"basecaller -x cuda --dump-stats-file: exit {rc}, {len(lines) - 1} rows of "
              f"{len(head)} columns: {head}", flush=True)
        if (rc != 0 or len(lines) < 2 or not any(c.startswith("basecaller.") for c in head)
                or not any(c.startswith("device.") for c in head)):
            raise AssertionError("--dump-stats-file: no basecaller. and device. columns")

    for what, rate in rates.items():
        print(f"multi-GPU rate: {what}: {rate:.0f} samples/s [{k.smi}]", flush=True)


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    if not (ROOT / "dorado_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from dorado_tpu_torch.basecall.runner import TorchBasecallRunner
    from dorado_tpu_torch.io.sam import BamWriter
    from dorado_tpu_torch.modbase.model import init_modbase_params, save_modbase_model
    from dorado_tpu_torch.models.crf_model import _linear_f32, init_lstm_crf_params
    from dorado_tpu_torch.models.presets import (
        hac_5mcg_5hmcg_v3_config, hac_v43_config, sup_v50_config,
    )
    from dorado_tpu_torch.models import tx_model
    from dorado_tpu_torch.models.tx_model import init_tx_params
    from dorado_tpu_torch.ops import (
        _cuda, attention, beam, crf_cuda, crf_scan, fused_norm, int8_matmul, lstm,
    )
    from dorado_tpu_torch.pipeline import BasecallerPipeline
    from dorado_tpu_torch.utils import align as aligner

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
    print(f"built {len(libs)} kernel sources in {time.perf_counter() - t0:.1f} s", flush=True)
    # the read splitter's aligner: host C++, built by g++ (no fallback)
    t0 = time.perf_counter()
    align_lib = aligner.build()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    print(f"built the splitter's aligner {align_lib.name} with {gxx} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # each kernel's registers, spills and static shared memory, under its
    # (mangled) name, and ptxas's notes of lost performance (such as wgmma
    # serialised); K1's and the attention's dynamic shared memory are
    # printed where they launch. A serialised wgmma fails the run.
    serialised = []
    for name, path in libs.items():
        log = path.with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    print(f"  {name}: {line.split(chr(39))[1]}")
                elif "registers" in line or "spill" in line or "Performance Loss" in line:
                    print(f"    {line.strip()}")
                if "wgmma" in line and "serialized" in line:
                    serialised.append(name)
    if serialised:
        raise AssertionError(f"ptxas serialised the wgmma of a kernel in {sorted(set(serialised))}")

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

    def device_ms(fn, reps: int, kernel: str) -> float:
        """The mean device time a call of ``fn`` spends in kernels whose name
        holds ``kernel``, from the profiler: for kernels about as short as a
        host launch, where events around the calls time the host as well.
        The profiler's CUPTI tracing now and then records no kernel at all:
        after three such tries the time comes from CUDA events around the
        calls, with the host's launch time in it, and says so."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            total = sum(e.self_device_time_total for e in prof.key_averages()
                        if kernel in e.key)
            if total > 0:
                return total / 1e3 / reps
        ms = time_ms(fn, reps)
        print(f"  the profiler saw no kernel named like {kernel} in three tries: CUDA events "
              f"around {reps} calls instead, {ms:.4f} ms a call (host launch time included) "
              f"[{card}]", flush=True)
        return ms

    rows = []

    def report(name, source, replaces, err, ms, plain_ms, ops, peak, nbytes, library_ms,
               library_what="", wrappers=None, paths=None, **extra):
        """One row of the ``kernels`` line. ``wrappers`` names the launch
        counters (keys of ``wrappers`` below) whose sum is the row's
        ``launches``: the row's own name unless given; ``paths`` the main
        paths whose launches count for the row: all unless given."""
        b_ms, b_by = bound_ms(ops, peak, nbytes)
        rows.append({
            "wrappers": wrappers or [name], "paths": paths,
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, **extra,
        })
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms {library_what}"
        print(
            f"{name}: max_abs_err {err:.3g}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
            f"  bound {b_ms:.3f} ms ({b_by})  library {lib}  [{card}]",
            flush=True,
        )

    def viterbi_sentinel(sc):
        """K7 launched into choices filled with SENTINEL_CHOICE and a final
        carry of NaNs: (choices, final carry)."""
        t_len, n, c = sc.shape
        ch = torch.full((t_len, n, c // 4), SENTINEL_CHOICE, dtype=torch.int8, device=dev)
        fin = torch.full((n, c // 4), float("nan"), device=dev)
        crf_cuda._launch_viterbi_forward(sc, STAY, ch, fin)
        return ch, fin

    def hold_viterbi(sc, what):
        """K7 against its plain version: (choices, final carry), both exact,
        through the wrapper and into sentinel-filled outputs (every position
        written)."""
        ch, fin = crf_cuda.viterbi_forward(sc, STAY)
        ch_s, fin_s = viterbi_sentinel(sc)
        ch_p, fin_p = crf_cuda.viterbi_forward_plain(sc, STAY)
        torch.cuda.synchronize()
        if not (torch.equal(ch, ch_p) and torch.equal(fin, fin_p) and torch.equal(ch_s, ch_p)
                and torch.equal(fin_s, fin_p)):
            raise AssertionError(
                f"crf_viterbi_forward {what}: {(ch != ch_p).sum().item()} choices differ from the "
                f"plain version's (or the final carry, or a position was not written)")
        print(f"crf_viterbi_forward {what}: choices and final carry equal to the plain version's, "
              f"every position written", flush=True)
        return ch, fin

    def cross_check_viterbi(ch7, fin7, ch4, fin4, path45, sc, what):
        """K7 against K4 on the same score values, and ``viterbi_path``
        against the Viterbi states and moves of K4 + K5: all exact."""
        if not torch.equal(ch7, ch4) or not torch.equal(fin7, fin4):
            raise AssertionError(f"crf_viterbi_forward at {what}: {(ch7 != ch4).sum().item()} "
                                 f"choices differ from K4's (or the final carry)")
        st, mv = crf_cuda.viterbi_path(sc, STAY)
        if not torch.equal(st, path45[0]) or not torch.equal(mv, path45[1]):
            raise AssertionError(f"viterbi_path at {what}: states or moves differ from K4 + K5's")
        print(f"  K7 at {what}: choices and final carry equal to K4's; viterbi_path equal to "
              f"K4 + K5's states and moves", flush=True)

    def hold_full(sc, beta_full, what, vit=None):
        """K8 against its plain version (choices and final carry exact, posts
        within TOL_POSTS_*) and, given K7's outputs, against those: (posts,
        the posts' max abs error)."""
        posts, ch, fin = crf_cuda.fused_forward_decode_full(sc, beta_full, STAY)
        posts_p, ch_p, fin_p = crf_cuda.fused_forward_decode_full_plain(sc, beta_full, STAY)
        torch.cuda.synchronize()
        if not torch.equal(ch, ch_p) or not torch.equal(fin, fin_p):
            raise AssertionError(f"crf_fused_forward_f32 {what}: {(ch != ch_p).sum().item()} "
                                 f"choices differ from the plain version's (or the final carry)")
        diff = (posts - posts_p).abs()
        if not bool((diff <= TOL_POSTS_ABS + TOL_POSTS_REL * posts_p.abs()).all()):
            raise AssertionError(f"crf_fused_forward_f32 {what}: posts max abs error "
                                 f"{diff.max().item()}")
        if vit is not None and not (torch.equal(ch, vit[0]) and torch.equal(fin, vit[1])):
            raise AssertionError(f"crf_fused_forward_f32 {what}: choices differ from K7's")
        print(f"crf_fused_forward_f32 {what}: posts max abs error {diff.max().item():.3g}; choices "
              f"and final carry equal to the plain version's"
              + (" and to K7's" if vit is not None else ""), flush=True)
        return posts, diff.max().item()

    # ---- K1: LSTM recurrence ---------------------------------------------
    def k1_split(h, n, fused=False, elem_bytes=2, p=None) -> str:
        p = p or lstm.k1_launch_plan(h, n, dev, fused, elem_bytes)
        return (f"cluster {p.cluster}, {p.units} units a CTA, {p.warps} warps, {p.rows} rows a "
                f"cluster, {p.clusters} clusters, "
                f"{lstm._k1_smem(p.units, p.cluster, p.rows, fused, elem_bytes)} bytes of shared "
                f"memory a CTA")

    with torch.inference_mode():
        def lstm_weights(h):
            return ((torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) / h**0.5).bfloat16()

        def hold_k1(w, t_len, n, reverse):
            h = w.shape[0]
            xproj = (torch.randn(t_len, n, 4 * h, generator=gen, device=dev) * 0.8).bfloat16()
            out_k = lstm.lstm_scan_time_major(xproj, w, reverse=reverse)
            out_p = lstm.lstm_scan_plain(xproj, w, reverse=reverse)
            torch.cuda.synchronize()
            e = (out_k.float() - out_p.float()).abs().max().item()
            print(f"lstm_scan H={h} T={t_len} N={n} reverse={reverse} ({k1_split(h, n)}): max abs "
                  f"error {e:.3g}", flush=True)
            if not e <= TOL_LSTM:
                raise AssertionError(f"lstm_scan at H={h} T={t_len} N={n}: max abs error {e} > "
                                     f"{TOL_LSTM}")
            return e

        w_hh_t = lstm_weights(H)
        err = max(hold_k1(w_hh_t, t_len, n, reverse) for t_len, n, reverse in LSTM_SHAPES)
        for h_other, n in LSTM_WIDTHS:
            w_other = lstm_weights(h_other)
            err = max(err, *(hold_k1(w_other, 64, n, reverse) for reverse in (False, True)))
        print(f"  clusters the card runs at once, by width: "
              f"{ {k[1]: c for k, c in lstm._active.items() if k[2:] == (False, 2)} }", flush=True)
        # the timed shapes: hac's long lane, reversed as the first layer runs,
        # and a 512-row batch (the -b 0 sweep's choice), each beside cuDNN
        timed = {}
        for n in LSTM_TIMED_N:
            xproj = (torch.randn(T, n, 4 * H, generator=gen, device=dev) * 0.8).bfloat16()
            cudnn = torch.nn.LSTM(H, H, device=dev, dtype=torch.bfloat16)
            cudnn.flatten_parameters()
            x_in = torch.randn(T, n, H, generator=gen, device=dev).bfloat16()
            k_ms = time_ms(lambda: lstm.lstm_scan_time_major(xproj, w_hh_t, reverse=True), 3)
            lib_ms = time_ms(lambda: cudnn(x_in), 3)
            b_ms, _ = bound_ms(2.0 * T * n * H * 4 * H, PEAK_BF16,
                               2 * (T * n * 4 * H + H * 4 * H + T * n * H))
            timed[n] = dict(ms=k_ms, library_ms=lib_ms, bound_ms=b_ms, us_per_step=k_ms / T * 1e3,
                            split=lstm.k1_launch_plan(H, n, dev)._asdict())
            print(f"lstm_scan T={T} N={n}: {k_ms:.3f} ms, {k_ms / T * 1e3:.3f} us a step "
                  f"({k1_split(H, n)}); cuDNN nn.LSTM at the same N {lib_ms:.3f} ms [{card}]",
                  flush=True)
        # the row's own numbers at N = 128; x_in stays at N = 128 for K16 and
        # K2 below
        xproj = (torch.randn(T, N, 4 * H, generator=gen, device=dev) * 0.8).bfloat16()
        x_in = torch.randn(T, N, H, generator=gen, device=dev).bfloat16()
        n512 = timed[LSTM_TIMED_N[1]]
        report(
            "lstm_scan", "dorado_tpu_torch/csrc/lstm_scan.cu", "dorado_tpu/ops/lstm.py:65",
            err, timed[N]["ms"],
            time_ms(lambda: lstm.lstm_scan_plain(xproj, w_hh_t, reverse=True), 1),
            2.0 * T * N * H * 4 * H, PEAK_BF16, 2 * (T * N * 4 * H + H * 4 * H + T * N * H),
            timed[N]["library_ms"], "(cuDNN nn.LSTM, one layer, incl. its input projection)",
            us_per_step=timed[N]["us_per_step"], split=timed[N]["split"],
            n512_ms=n512["ms"], n512_library_ms=n512["library_ms"],
            n512_bound_ms=n512["bound_ms"], n512_us_per_step=n512["us_per_step"],
            n512_split=n512["split"],
        )
        del xproj

        # ---- K15, K16: the LSTM variants on no path ------------------------
        def hold_k15(w, t_len, n, reverse):
            """K15 against its plain version on the same int8 weights: at most
            MAX_INT8_LSTM_SHARE_OFF of the outputs more than one bf16 step
            apart. Returns the max abs error."""
            h = w.shape[0]
            w_i8, w_scale = lstm.quantize_lstm_weights(w.float())
            xproj = (torch.randn(t_len, n, 4 * h, generator=gen, device=dev) * 0.8).bfloat16()
            out_k = lstm.lstm_scan_time_major_int8(xproj, w_i8, w_scale, reverse=reverse)
            out_p = lstm.lstm_scan_int8_plain(xproj, w_i8, w_scale, reverse=reverse)
            torch.cuda.synchronize()
            a, b = out_k.float(), out_p.float()
            diff = (a - b).abs()
            # one bf16 step at the larger magnitude: 2^(exponent - 7)
            big = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-126)
            step = torch.exp2(torch.floor(torch.log2(big)) - 7)
            off = (diff > step).float().mean().item()
            print(f"lstm_scan_int8 H={h} T={t_len} N={n} reverse={reverse} "
                  f"({k1_split(h, n, elem_bytes=1)}): max abs error {diff.max().item():.3g}; "
                  f"{(diff > 0).float().mean().item():.4%} of outputs differ, {off:.4%} by more "
                  f"than one bf16 step", flush=True)
            if not off < MAX_INT8_LSTM_SHARE_OFF:
                raise AssertionError(f"lstm_scan_int8 at H={h} T={t_len} N={n} reverse={reverse}: "
                                     f"{off:.4%} of outputs more than one bf16 step off")
            return diff.max().item()

        err15 = 0.0
        for t_len, n, h in K15_SHAPES:
            w = w_hh_t if h == H else lstm_weights(h)
            err15 = max(err15, *(hold_k15(w, t_len, n, reverse) for reverse in (False, True)))
        print(f"  K15's clusters the card runs at once, by width: "
              f"{ {k[1]: c for k, c in lstm._active.items() if k[3] == 1} }", flush=True)
        # timed as K1 is, at N = 128 and 512, on its own split and on clusters
        # of 4 (the same sums in another order: equal)
        w_i8, w_scale = lstm.quantize_lstm_weights(w_hh_t.float())
        timed15 = {}
        for n in LSTM_TIMED_N:
            xproj = (torch.randn(T, n, 4 * H, generator=gen, device=dev) * 0.8).bfloat16()
            k_ms = time_ms(lambda: lstm.lstm_scan_time_major_int8(xproj, w_i8, w_scale,
                                                                  reverse=True), 3)
            rows4 = K15_SMALL_ROWS[n]
            p4 = lstm.ClusterPlan(*K15_SMALL_CLUSTER, rows4, -(-n // rows4))
            w_sl4 = lstm.slice_w_hh(w_i8, p4.cluster, p4.units)
            out4 = torch.empty(T, n, H, dtype=torch.bfloat16, device=dev)
            c4_ms = time_ms(lambda: lstm._launch("lstm_scan_int8", xproj, w_sl4, out4, True, p4,
                                                 w_scale), 3)
            if not torch.equal(out4, lstm.lstm_scan_time_major_int8(xproj, w_i8, w_scale,
                                                                    reverse=True)):
                raise AssertionError(f"lstm_scan_int8 at N={n}: clusters of 4 give other outputs")
            b_ms, _ = bound_ms(2.0 * T * n * H * 4 * H, PEAK_INT8,
                               2 * T * n * 4 * H + H * 4 * H + 4 * 4 * H + 2 * T * n * H)
            timed15[n] = dict(ms=k_ms, bound_ms=b_ms, us_per_step=k_ms / T * 1e3,
                              split=lstm.k1_launch_plan(H, n, dev, elem_bytes=1)._asdict(),
                              cluster4_ms=c4_ms, cluster4_split=p4._asdict())
            print(f"lstm_scan_int8 T={T} N={n}: {k_ms:.3f} ms, {k_ms / T * 1e3:.3f} us a step "
                  f"({k1_split(H, n, elem_bytes=1)}); on clusters of 4 "
                  f"({k1_split(H, n, elem_bytes=1, p=p4)}) {c4_ms:.3f} ms; K1 (bf16) at the same "
                  f"N {timed[n]['ms']:.3f} ms [{card}]", flush=True)
        del out4, w_sl4
        xproj = xproj[:, :N].contiguous()  # the plain version is timed at N = 128
        n512 = timed15[LSTM_TIMED_N[1]]
        report(
            "lstm_scan_int8", "dorado_tpu_torch/csrc/lstm_scan.cu", "dorado_tpu/ops/lstm.py:291",
            err15, timed15[N]["ms"],
            time_ms(lambda: lstm.lstm_scan_int8_plain(xproj, w_i8, w_scale, reverse=True), 1),
            2.0 * T * N * H * 4 * H, PEAK_INT8,
            2 * T * N * 4 * H + H * 4 * H + 4 * 4 * H + 2 * T * N * H, None, on_path=False,
            us_per_step=timed15[N]["us_per_step"], split=timed15[N]["split"],
            cluster4_ms=timed15[N]["cluster4_ms"], cluster4_split=timed15[N]["cluster4_split"],
            n512_ms=n512["ms"], n512_bound_ms=n512["bound_ms"],
            n512_us_per_step=n512["us_per_step"], n512_split=n512["split"],
            n512_cluster4_ms=n512["cluster4_ms"], n512_cluster4_split=n512["cluster4_split"],
        )
        del xproj, w_i8, w_scale

        # K16 at every width and batch K1 is held at, both directions: hac's H
        # at N = 128 (the full T) and 512, and LSTM_WIDTHS
        def hold_k16(w_ih, w_hh, bias, x_in, reverse):
            h, (t_len, n) = w_hh.shape[0], x_in.shape[:2]
            out_k = lstm.lstm_fused_time_major(x_in, w_ih, w_hh, bias, reverse=reverse)
            out_p = lstm.lstm_fused_plain(x_in, w_ih, w_hh, bias, reverse=reverse)
            torch.cuda.synchronize()
            e = (out_k.float() - out_p.float()).abs().max().item()
            print(f"lstm_fused H={h} T={t_len} N={n} reverse={reverse} "
                  f"({k1_split(h, n, fused=True)}): max abs error {e:.3g}", flush=True)
            if not e <= TOL_LSTM:
                raise AssertionError(f"lstm_fused at H={h} T={t_len} N={n} reverse={reverse}: max "
                                     f"abs error {e} > {TOL_LSTM}")
            return e

        w_ih_t = lstm_weights(H)
        lstm_bias = torch.randn(4 * H, generator=gen, device=dev) * 0.1
        x_wide = torch.randn(64, 4 * N, H, generator=gen, device=dev).bfloat16()
        err16 = max(hold_k16(w_ih_t, w_hh_t, lstm_bias, x, reverse)
                    for x in (x_in, x_wide) for reverse in (False, True))
        for h_other, n in LSTM_WIDTHS:
            w_ih_o, w_hh_o = lstm_weights(h_other), lstm_weights(h_other)
            bias_o = torch.randn(4 * h_other, generator=gen, device=dev) * 0.1
            x_o = torch.randn(64, n, h_other, generator=gen, device=dev).bfloat16()
            err16 = max(err16, *(hold_k16(w_ih_o, w_hh_o, bias_o, x_o, reverse)
                                 for reverse in (False, True)))
        del x_wide, w_ih_o, w_hh_o, bias_o, x_o
        # timed as K1 is, at N = 128 and 512, each beside cuDNN at the same N
        timed16 = {}
        for n in LSTM_TIMED_N:
            x_n = x_in if n == N else torch.randn(T, n, H, generator=gen, device=dev).bfloat16()
            cudnn = torch.nn.LSTM(H, H, device=dev, dtype=torch.bfloat16)
            cudnn.flatten_parameters()
            k_ms = time_ms(lambda: lstm.lstm_fused_time_major(x_n, w_ih_t, w_hh_t, lstm_bias,
                                                              reverse=True), 3)
            lib_ms = time_ms(lambda: cudnn(x_n), 3)
            b_ms, _ = bound_ms(2.0 * 2 * T * n * H * 4 * H, PEAK_BF16,
                               2 * T * n * H + 2 * 2 * H * 4 * H + 4 * 4 * H + 2 * T * n * H)
            timed16[n] = dict(ms=k_ms, library_ms=lib_ms, bound_ms=b_ms,
                              us_per_step=k_ms / T * 1e3,
                              split=lstm.k1_launch_plan(H, n, dev, fused=True)._asdict())
            print(f"lstm_fused T={T} N={n}: {k_ms:.3f} ms, {k_ms / T * 1e3:.3f} us a step "
                  f"({k1_split(H, n, fused=True)}); cuDNN nn.LSTM at the same N {lib_ms:.3f} ms "
                  f"[{card}]", flush=True)
        del x_n, cudnn
        n512 = timed16[LSTM_TIMED_N[1]]
        report(
            "lstm_fused", "dorado_tpu_torch/csrc/lstm_scan.cu", "dorado_tpu/ops/lstm.py:184",
            err16, timed16[N]["ms"],
            time_ms(lambda: lstm.lstm_fused_plain(x_in, w_ih_t, w_hh_t, lstm_bias, reverse=True),
                    1),
            2.0 * 2 * T * N * H * 4 * H, PEAK_BF16,
            2 * T * N * H + 2 * 2 * H * 4 * H + 4 * 4 * H + 2 * T * N * H,
            timed16[N]["library_ms"],
            "(cuDNN nn.LSTM, one layer of input size H: the same function)",
            on_path=False, us_per_step=timed16[N]["us_per_step"], split=timed16[N]["split"],
            n512_ms=n512["ms"], n512_library_ms=n512["library_ms"],
            n512_bound_ms=n512["bound_ms"], n512_us_per_step=n512["us_per_step"],
            n512_split=n512["split"],
        )
        del w_ih_t, lstm_bias

        # ---- K1 float32: the modbase models' LSTMs -------------------------
        def hold_k1f(w, t_len, n, reverse):
            h = w.shape[0]
            xproj = torch.randn(t_len, n, 4 * h, generator=gen, device=dev) * 0.8
            out_k = lstm.lstm_scan_time_major(xproj, w, reverse=reverse)
            out_p = lstm.lstm_scan_plain(xproj, w, reverse=reverse)
            torch.cuda.synchronize()
            e = (out_k - out_p).abs().max().item()
            print(f"lstm_scan_f32 H={h} T={t_len} N={n} reverse={reverse} "
                  f"({k1_split(h, n, elem_bytes=4)}): max abs error {e:.3g}", flush=True)
            if not e <= TOL_LSTM_F32:
                raise AssertionError(f"lstm_scan_f32 at H={h} T={t_len} N={n} reverse={reverse}: "
                                     f"max abs error {e} > {TOL_LSTM_F32}")
            return e

        def f32_weights(h):
            return (torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) / h**0.5

        timed_f = {}
        errf = 0.0
        for t_len, n, h in K1F_SHAPES:
            w = f32_weights(h)
            errf = max(errf, *(hold_k1f(w, t_len, n, reverse) for reverse in (False, True)))
            xproj = torch.randn(t_len, n, 4 * h, generator=gen, device=dev) * 0.8
            cudnn = torch.nn.LSTM(h, h, device=dev)
            cudnn.flatten_parameters()
            x_f = torch.randn(t_len, n, h, generator=gen, device=dev)
            k_ms = time_ms(lambda: lstm.lstm_scan_time_major(xproj, w, reverse=True), 5)
            # cuDNN's float32 RNN runs in TF32 unless told not to (PyTorch's
            # default): the same function in float32 is timed with it off
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                lib_ms = time_ms(lambda: cudnn(x_f), 5)
            nbytes = 4 * (t_len * n * 4 * h + h * 4 * h + t_len * n * h)
            b_ms, b_by = bound_ms(2.0 * t_len * n * h * 4 * h, PEAK_F32, nbytes)
            timed_f[(t_len, n, h)] = dict(
                ms=k_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                tf32x3_bound_ms=bound_ms(2.0 * t_len * n * h * 4 * h, PEAK_TF32 / 3, nbytes)[0],
                us_per_step=k_ms / t_len * 1e3,
                split=lstm.k1_launch_plan(h, n, dev, elem_bytes=4)._asdict(),
                plain_ms=time_ms(lambda: lstm.lstm_scan_plain(xproj, w, reverse=True), 1))
            print(f"lstm_scan_f32 T={t_len} N={n} H={h}: {k_ms:.4f} ms, {k_ms / t_len * 1e3:.3f} us "
                  f"a step ({k1_split(h, n, elem_bytes=4)}); bound {b_ms:.4f} ms ({b_by}; "
                  f"{timed_f[(t_len, n, h)]['tf32x3_bound_ms']:.4f} ms on 3xTF32); cuDNN "
                  f"nn.LSTM float32, TF32 off, at the same shape {lib_ms:.4f} ms [{smi}]",
                  flush=True)
        del xproj, x_f, cudnn
        # ragged shapes into NaN-filled outputs, through the launch helper
        for t_len, n, h in K1F_RAGGED:
            w = f32_weights(h)
            xproj = torch.randn(t_len, n, 4 * h, generator=gen, device=dev) * 0.8
            for reverse in (False, True):
                plan = lstm.k1_launch_plan(h, n, dev, elem_bytes=4)
                out = torch.full((t_len, n, h), float("nan"), device=dev)
                lstm._launch("lstm_scan_f32", xproj,
                             lstm.slice_w_hh(w, plan.cluster, plan.units), out, reverse, plan)
                out_p = lstm.lstm_scan_plain(xproj, w, reverse=reverse)
                torch.cuda.synchronize()
                e = (out - out_p).abs().max().item()  # NaN where a position was not written
                print(f"lstm_scan_f32 H={h} T={t_len} N={n} reverse={reverse} into a NaN-filled "
                      f"output ({k1_split(h, n, elem_bytes=4)}): max abs error {e:.3g}",
                      flush=True)
                if not e <= TOL_LSTM_F32:
                    raise AssertionError(f"lstm_scan_f32 at H={h} T={t_len} N={n}: max abs "
                                         f"error {e} (NaN: a position was not written)")
                errf = max(errf, e)
        print(f"  K1 float32's clusters the card runs at once, by width: "
              f"{ {k[1]: c for k, c in lstm._active.items() if k[3] == 4} }", flush=True)
        mb, wide, hac_f = (timed_f[K1F_SHAPES[0]], timed_f[K1F_SHAPES[1]],
                           timed_f[K1F_SHAPES[2]])
        report(
            "lstm_scan_f32", "dorado_tpu_torch/csrc/lstm_scan.cu", "dorado_tpu/ops/lstm.py:65",
            errf, mb["ms"], mb["plain_ms"], 2.0 * 32 * N * 256 * 1024, PEAK_F32,
            4 * (32 * N * 1024 + 256 * 1024 + 32 * N * 256), mb["library_ms"],
            "(cuDNN nn.LSTM float32, TF32 off, one layer, incl. its input projection)",
            shape="T=32 N=128 H=256 (the modbase models' chunk batch)",
            us_per_step=mb["us_per_step"], split=mb["split"],
            tf32x3_bound_ms=mb["tf32x3_bound_ms"],
            **{f"n1024_{k}": v for k, v in wide.items()},
            **{f"hac_{k}": v for k, v in hac_f.items()},
        )
        del xproj, out, out_p

        # ---- K2: W8A8 input projection -------------------------------------
        w_ih = (torch.rand(4 * H, H, generator=gen, device=dev) * 2 - 1) / H**0.5
        wq, ws = int8_matmul.quantize_weight_rows(w_ih)
        wq_t = wq.t()  # the transposed view the model passes: used as it is
        bias = torch.randn(4 * H, generator=gen, device=dev) * 0.1
        err = 0.0
        for m in W8A8_ROWS:
            x = torch.randn(m, H, generator=gen, device=dev).bfloat16()
            out_k = int8_matmul.w8a8_matmul_fq(x, wq_t, ws, bias)
            out_p = int8_matmul.w8a8_matmul_fq_plain(x, wq_t, ws, bias)
            torch.cuda.synchronize()
            e = (out_k.float() - out_p.float()).abs().max().item()
            same = torch.equal(out_k, out_p)
            print(f"w8a8_matmul_fq M={m}: bit for bit {same}, max abs error {e:.3g}", flush=True)
            if not same:
                bad = (out_k != out_p).float().mean().item()
                raise AssertionError(
                    f"w8a8_matmul_fq at M={m}: {bad:.3%} of outputs differ from the plain "
                    f"version (max abs error {e})"
                )
            err = max(err, e)
            del x, out_k, out_p
        for m, k_o, o_o in W8A8_OTHER:
            wq_o, ws_o = int8_matmul.quantize_weight_rows(
                (torch.rand(o_o, k_o, generator=gen, device=dev) * 2 - 1) / k_o**0.5)
            b_o = torch.randn(o_o, generator=gen, device=dev) * 0.1
            x = torch.randn(m, k_o, generator=gen, device=dev).bfloat16()
            out_k = int8_matmul.w8a8_matmul_fq(x, wq_o.t(), ws_o, b_o)
            out_p = int8_matmul.w8a8_matmul_fq_plain(x, wq_o.t(), ws_o, b_o)
            torch.cuda.synchronize()
            print(f"w8a8_matmul_fq M={m} K={k_o} O={o_o} ({int8_matmul.w8a8_fq_plan(k_o, o_o)}): "
                  f"bit for bit {torch.equal(out_k, out_p)}", flush=True)
            if not torch.equal(out_k, out_p):
                raise AssertionError(
                    f"w8a8_matmul_fq at M={m}, K={k_o}, O={o_o}: "
                    f"{(out_k != out_p).float().mean().item():.3%} of outputs differ")
            del wq_o, ws_o, b_o, x, out_k, out_p
        x_flat = x_in.reshape(T * N, H)
        w_bf16 = w_ih.bfloat16()

        def int_mm_path():
            # the same function through torch._int_mm, with the quantise and
            # dequantise steps as separate PyTorch passes
            xf = x_flat.float()
            s = xf.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) * (1.0 / 127.0)
            xq = torch.round(xf * torch.reciprocal(s)).to(torch.int8)
            acc = torch._int_mm(xq, wq_t)
            return (acc.float() * s * ws + bias).to(torch.bfloat16)

        if not torch.equal(int_mm_path(), int8_matmul.w8a8_matmul_fq(x_flat, wq_t, ws, bias)):
            raise AssertionError("w8a8_matmul_fq differs from the torch._int_mm path")
        bf16_ms = time_ms(lambda: _linear_f32(x_flat, w_bf16, bias).to(torch.bfloat16), 5)
        m, k, o = T * N, H, 4 * H
        report(
            "w8a8_matmul_fq", "dorado_tpu_torch/csrc/w8a8_matmul_fq.cu",
            "dorado_tpu/ops/int8_matmul.py:267", err,
            time_ms(lambda: int8_matmul.w8a8_matmul_fq(x_flat, wq_t, ws, bias), 10),
            time_ms(lambda: int8_matmul.w8a8_matmul_fq_plain(x_flat, wq_t, ws, bias), 2),
            2.0 * m * k * o, PEAK_INT8, 2 * m * k + k * o + 8 * o + 2 * m * o,
            time_ms(int_mm_path, 5),
            "(torch._int_mm with separate quantise and dequantise passes)",
            bf16_matmul_ms=bf16_ms, plan=str(int8_matmul.w8a8_fq_plan(k, o)),
        )
        print(f"  the bf16 torch.matmul + float32 bias + cast it replaces: {bf16_ms:.3f} ms",
              flush=True)
        del x_in, x_flat, w_ih, w_bf16, wq, wq_t, ws, bias

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

        def hold_fused(t_len, n, s):
            """K3 (shifted) at (T, N, S) against its plain version (within
            TOL_BETA_*), K4 on it against its plain version (choices and final
            carry exact, posts within TOL_POSTS_*) and K7 on the same score
            values (exact): (scores, beta, the posts' max abs error)."""
            sc = (torch.randn(t_len, n, 4 * s, generator=gen, device=dev) * 2).clamp(-5, 5)
            sc = sc.bfloat16()
            beta = crf_cuda.backward_scores_shifted(sc, STAY)
            beta_p = crf_cuda.backward_scores_shifted_plain(sc, STAY)
            posts, ch, fin = crf_cuda.fused_forward_decode(sc, beta, STAY)
            posts_p, ch_p, fin_p = crf_cuda.fused_forward_decode_plain(sc, beta, STAY)
            ch7, fin7 = viterbi_sentinel(sc.float())
            torch.cuda.synchronize()
            what = f"T={t_len} N={n} S={s}"
            d = (beta.float() - beta_p.float()).abs()
            if not bool((d <= TOL_BETA_ABS + TOL_BETA_REL * beta_p.float().abs()).all()):
                raise AssertionError(f"crf_lse_backward at {what}: max abs error {d.max().item()}")
            print(f"crf_lse_backward {what}: max abs error {d.max().item():.3g}", flush=True)
            if not torch.equal(ch, ch_p) or not torch.equal(fin, fin_p):
                raise AssertionError(f"crf_fused_forward at {what}: {(ch != ch_p).sum().item()} "
                                     f"choices differ (or the final carry)")
            d = (posts.float() - posts_p.float()).abs()
            if not bool((d <= TOL_POSTS_ABS + TOL_POSTS_REL * posts_p.float().abs()).all()):
                raise AssertionError(f"crf_fused_forward at {what}: posts max abs error "
                                     f"{d.max().item()}")
            if not torch.equal(ch7, ch) or not torch.equal(fin7, fin):
                raise AssertionError(f"crf_viterbi_forward at {what}: choices differ from K4's "
                                     f"(or the final carry)")
            print(f"crf_fused_forward {what}: posts max abs error {d.max().item():.3g}; choices "
                  f"and final carry equal to the plain version's and to K7's (K7 into "
                  f"sentinel-filled outputs: every position written)", flush=True)
            return sc, beta, d.max().item()

        for shape in K7_EDGE_SHAPES:
            err = max(err, hold_fused(*shape)[2])
        for shape in K4_SHAPES:
            sc64, beta64, e = hold_fused(*shape)
            err = max(err, e)
        # the last shape is the fast model's chunk: timed there
        fast_ms = time_ms(lambda: crf_cuda.fused_forward_decode(sc64, beta64, STAY), 3)
        del sc64, beta64
        report(
            "crf_fused_forward", "dorado_tpu_torch/csrc/crf_fused_forward.cu",
            "dorado_tpu/ops/crf_pallas.py:937", err,
            time_ms(lambda: crf_cuda.fused_forward_decode(scores, beta_k, STAY), 3),
            time_ms(lambda: crf_cuda.fused_forward_decode_plain(scores, beta_k, STAY), 1),
            30.0 * T * N * S, PEAK_F32,
            2 * T * N * 4 * S + 2 * T * N * S + 2 * T * N * S + T * N * S + 4 * N * S, None,
            fast_ms=fast_ms, fast_bound_ms=bound_ms(
                30.0 * T * N * 64, PEAK_F32,
                2 * T * N * 4 * 64 + 5 * T * N * 64 + 4 * N * 64)[0],
        )
        print(f"  crf_fused_forward at the fast model's 64 states (T={T} N={N}): {fast_ms:.3f} ms",
              flush=True)

        # ---- K5: traceback ----------------------------------------------
        def hold_traceback(ch, last, what):
            """K5 against its plain version, exact: through the wrapper, and
            launched into [N, T] outputs filled with a sentinel first. Returns
            the wrapper's (states, moves)."""
            t_len, n, _ = ch.shape
            st_s = torch.full((n, t_len), SENTINEL_STATE, dtype=torch.int32, device=dev)
            mv_s = torch.full((n, t_len), SENTINEL_MOVE, dtype=torch.uint8, device=dev)
            crf_cuda._launch_traceback(ch, last, st_s, mv_s)
            st, mv = crf_cuda.viterbi_traceback(ch, last)
            st_p, mv_p = crf_cuda.viterbi_traceback_plain(ch, last)
            torch.cuda.synchronize()
            if not (torch.equal(st, st_p) and torch.equal(mv, mv_p)
                    and torch.equal(st_s.t(), st_p) and torch.equal(mv_s.t(), mv_p)):
                raise AssertionError(f"crf_traceback at {what}: states or moves differ from the "
                                     f"plain version's (or a position was not written)")
            print(f"crf_traceback {what}: states and moves equal to the plain version's, every "
                  f"position written", flush=True)
            return st, mv

        def traceback_floor_ms(t_len, n, s):
            """The design floor of K5: each step's whole row of S choices read
            once, the states and moves written once."""
            return (t_len * n * s + t_len * n * (4 + 1) + 4 * n) / HBM_BYTES_S * 1e3

        for t_len, n, s in TRACEBACK_SHAPES:
            sc = (torch.randn(t_len, n, 4 * s, generator=gen, device=dev) * 2).clamp(-5, 5)
            ch7, fin7 = crf_cuda.viterbi_forward(sc, STAY)
            last7 = torch.argmax(fin7, dim=-1).to(torch.int32)
            hold_traceback(ch7, last7, f"T={t_len} N={n} S={s}")
        # the last shape is the fast model's chunk: timed there. The
        # tracebacks take about as long as a host launch: their times are the
        # profiler's device times (events around 20 launches beside them)
        fast_ms = device_ms(lambda: crf_cuda.viterbi_traceback(ch7, last7), 20,
                            "traceback_kernel")
        del sc, ch7, fin7
        last = torch.argmax(fin_k, dim=-1).to(torch.int32)
        st_k, mv_k = hold_traceback(ch_k, last, f"T={T} N={N} S={S}")
        report(
            "crf_traceback", "dorado_tpu_torch/csrc/crf_traceback.cu",
            "dorado_tpu/ops/crf_pallas.py:762", 0.0,
            device_ms(lambda: crf_cuda.viterbi_traceback(ch_k, last), 20, "traceback_kernel"),
            time_ms(lambda: crf_cuda.viterbi_traceback_plain(ch_k, last), 1),
            # one choice byte read per step and row, states and moves written
            4.0 * T * N, PEAK_F32, T * N * (1 + 4 + 1) + 4 * N, None,
            fast_ms=fast_ms,
            event_ms=time_ms(lambda: crf_cuda.viterbi_traceback(ch_k, last), 20),
        )
        print(f"  crf_traceback: device time from the profiler; events around 20 launches "
              f"{rows[-1]['event_ms']:.4f} ms; at the fast model's 64 states (T={T} N={N}) "
              f"{fast_ms:.4f} ms; design floor (each step's whole row of S choices read once) "
              f"{traceback_floor_ms(T, N, S):.4f} ms, at 64 states "
              f"{traceback_floor_ms(T, N, 64):.4f} ms  [{card}]", flush=True)
        del beta_p, diff, posts_p, ch_p, last7

        # ---- K6: full-history LSE scans, both directions in one launch -------
        def hold_lse(sc, what):
            """The one-launch pair's histories against their plain versions
            (TOL_LSE_*)."""
            errs = {}
            pair = crf_cuda.forward_backward_scores(sc, STAY)
            for direction, out_k, plain in (
                ("forward", pair[0], crf_scan.forward_scores),
                ("backward", pair[1], crf_scan.backward_scores),
            ):
                out_p = plain(sc, STAY)
                torch.cuda.synchronize()
                d = (out_k - out_p).abs()
                e = d.max().item()
                print(f"crf_lse_scans {direction} {what}: max abs error {e:.3g} on values up to "
                      f"{out_p.abs().max().item():.4g}", flush=True)
                if not bool((d <= TOL_LSE_ABS + TOL_LSE_REL * out_p.abs()).all()):
                    raise AssertionError(f"crf_lse_scans {direction} {what}: max abs error {e}")
                errs[direction] = e
            return errs

        def lse_report(name, replaces, sc, errs, paths):
            """The row of the scans at sc's shape: one launch, both directions
            (the runner's call)."""
            t_len, n, c = sc.shape
            pair_ms = time_ms(lambda: crf_cuda.forward_backward_scores(sc, STAY), 3)
            plain_ms = time_ms(lambda: (crf_scan.forward_scores(sc, STAY),
                                        crf_scan.backward_scores(sc, STAY)), 1)
            # float64 operations and bytes of both directions: the scores
            # read once, two histories written
            ops = 2 * LSE_F64_FLOPS * t_len * n * (c // 4)
            nbytes = 4 * t_len * n * c + 2 * 4 * (t_len + 1) * n * (c // 4)
            print(f"{name}: both directions in one launch {pair_ms:.3f} ms; float64 operation "
                  f"bound {ops / PEAK_F64 * 1e3:.3f} ms, byte bound "
                  f"{nbytes / HBM_BYTES_S * 1e3:.3f} ms [{card}]", flush=True)
            report(
                name, "dorado_tpu_torch/csrc/crf_lse_scan.cu", replaces, max(errs.values()),
                pair_ms, plain_ms, ops, PEAK_F64, nbytes, None, wrappers=["crf_lse_scans"],
                paths=paths, f64_bound_ms=ops / PEAK_F64 * 1e3,
                byte_bound_ms=nbytes / HBM_BYTES_S * 1e3,
            )

        scores32 = scores.float()
        del scores
        small = (torch.randn(64, 8, 4 * 64, generator=gen, device=dev) * 2).clamp(-5, 5)
        hold_lse(small, "T=64 N=8 S=64")
        # T below the register ring's depth and T, N no multiple of anything
        # the kernel works in, at 64, 256 and 1024 states
        for t_len, n, s in K4_SHAPES[:-1]:
            hold_lse((torch.randn(t_len, n, 4 * s, generator=gen, device=dev) * 2).clamp(-5, 5),
                     f"T={t_len} N={n} S={s}")
        errs = hold_lse(scores32, f"T={T} N={N} S={S}")
        lse_report("crf_lse_scan", "dorado_tpu/ops/crf_pallas.py:152", scores32, errs,
                   ["viterbi", "beam", "cli beam", "hac f32 beam", "fast beam", "replicas beam",
                    "sharded 2x1", "sharded 1x2", "rna beam"])

        # ---- K7a: the Viterbi forward pass alone, and viterbi_path -----------
        hold_viterbi(small, "T=64 N=8 S=64")
        ch7, fin7 = hold_viterbi(scores32, f"T={T} N={N} S={S}")
        cross_check_viterbi(ch7, fin7, ch_k, fin_k, (st_k, mv_k), scores32, f"S={S}")
        report(
            "crf_viterbi_forward", "dorado_tpu_torch/csrc/crf_viterbi_forward.cu",
            "dorado_tpu/ops/crf_pallas.py:242", 0.0,
            time_ms(lambda: crf_cuda.viterbi_forward(scores32, STAY), 3),
            time_ms(lambda: crf_cuda.viterbi_forward_plain(scores32, STAY), 1),
            VITERBI_OPS * T * N * S, PEAK_F32, 4 * T * N * 4 * S + T * N * S + 4 * N * S, None,
            paths=["sharded 2x1", "sharded 1x2"],
        )

        # ---- K8: the fused forward pass on float32 streams --------------------
        hold_full(small, crf_cuda.backward_scores(small, STAY), "T=64 N=8 S=64")
        beta32 = crf_cuda.backward_scores(scores32, STAY)
        posts8, err8 = hold_full(scores32, beta32, f"T={T} N={N} S={S}", (ch7, fin7))
        # K4 on the same score values and K3's bf16 beta, handed to K8 as the
        # rows 1..T of its beta history: the same float32 posts before K4
        # rounds them, so one bf16 step apart at most
        beta_hist = torch.cat([torch.zeros_like(beta_k[:1]), beta_k]).float()
        posts_same = crf_cuda.fused_forward_decode_full(scores32, beta_hist, STAY)[0]
        torch.cuda.synchronize()
        step = (posts_same - posts_k.float()).abs()
        rounds_to = torch.equal(posts_same.bfloat16(), posts_k)
        print(f"crf_fused_forward_f32 vs K4 on K4's inputs: max abs difference "
              f"{step.max().item():.3g}, bf16 of K8's posts equal to K4's: {rounds_to}; on its "
              f"own float32 beta: max abs {(posts8 - posts_k.float()).abs().max().item():.3g}",
              flush=True)
        if not bool((step <= TOL_POSTS_ABS + TOL_POSTS_REL * posts_k.float().abs()).all()):
            raise AssertionError("crf_fused_forward_f32: posts more than a bf16 step from K4's")
        report(
            "crf_fused_forward_f32", "dorado_tpu_torch/csrc/crf_fused_forward.cu",
            "dorado_tpu/ops/crf_pallas.py:688", err8,
            time_ms(lambda: crf_cuda.fused_forward_decode_full(scores32, beta32, STAY), 3),
            time_ms(lambda: crf_cuda.fused_forward_decode_full_plain(scores32, beta32, STAY), 1),
            30.0 * T * N * S, PEAK_F32,
            4 * T * N * 4 * S + 4 * (T + 1) * N * S + 4 * T * N * S + T * N * S + 4 * N * S, None,
            on_path=False,
        )
        del scores32, small, beta32, beta_hist, beta_k, posts_k, posts_same, posts8, step
        del ch_k, ch7, st_k
    torch.cuda.empty_cache()

    # ---- the kernels at sup v5.0 shapes ------------------------------------
    def sup_times(name, err, ms, plain_ms, ops, peak, nbytes):
        """Add a kernel's numbers at sup's shape to its row (its hac-shape
        numbers stay the row's own)."""
        b_ms, b_by = bound_ms(ops, peak, nbytes)
        row = next(r for r in rows if r["name"] == name)
        row.update(sup_max_abs_err=err, sup_ms=ms, sup_plain_ms=plain_ms, sup_bound_ms=b_ms,
                   sup_bound_by=b_by)
        print(f"{name} at sup shapes: max_abs_err {err:.3g}  kernel {ms:.3f} ms  plain "
              f"{plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})  [{card}]", flush=True)

    with torch.inference_mode():
        # ---- K9: banded attention with RoPE inside ---------------------------
        # the body's blocks (csrc/attention_banded.cu): 128 queries, 8 warps,
        # q and a two-tile ring of 64 k and 64 v rows of 72 bf16
        print(f"attention_banded: 128 queries a block, 8 warps, {(128 + 4 * 64) * 72 * 2} bytes "
              f"of shared memory a block", flush=True)
        hd, d_head = SUP_D, SUP_D // SUP_HEADS
        err = 0.0
        for n, t_len in reversed(ATTN_SHAPES):  # the timed shape last
            qkv = torch.randn(n, t_len, 3 * hd, generator=gen, device=dev).bfloat16()
            cos, sin = attention.rope_tables(t_len, d_head, 10000.0, dev)
            out_k = attention.windowed_attention_rope(qkv, cos, sin, SUP_HEADS, *SUP_WINDOW)
            out_p = attention.windowed_attention_rope_plain(qkv, cos, sin, SUP_HEADS, *SUP_WINDOW)
            torch.cuda.synchronize()
            diff = (out_k.float() - out_p.float()).abs()
            e = diff.max().item()
            print(f"attention_banded N={n} T'={t_len}: max abs error {e:.3g}, "
                  f"{(out_k != out_p).float().mean().item():.3%} of outputs differ (by one bf16 "
                  f"step at most)", flush=True)
            if not bool(torch.isfinite(out_k).all()) or not bool(
                    (diff <= TOL_ATTN_ABS + TOL_ATTN_REL * out_p.float().abs()).all()):
                raise AssertionError(f"attention_banded at N={n} T'={t_len}: max abs error {e}")
            err = max(err, e)
        # the library call: one scaled_dot_product_attention with the same mask
        # on q and k rotated beforehand (the rotation is not in its time)
        n, t_len = ATTN_SHAPES[0]
        q4, k4, v4 = (qkv[..., i * hd:(i + 1) * hd].reshape(n, t_len, SUP_HEADS, d_head)
                      for i in range(3))
        q_r = attention.rope_rotate(q4, cos, sin).transpose(1, 2).contiguous()
        k_r = attention.rope_rotate(k4, cos, sin).transpose(1, 2).contiguous()
        v_r = v4.transpose(1, 2).contiguous()
        pos = torch.arange(t_len, device=dev)
        mask = attention.band_mask(pos[:, None], pos[None, :], t_len, *SUP_WINDOW,
                                   attention.ref_strip_elems(t_len))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q_r, k_r, v_r, attn_mask=mask).transpose(1, 2).reshape(n, t_len, hd)
        lib_err = (lib.float() - out_p.float()).abs().max().item()
        print(f"  scaled_dot_product_attention with the same mask: max abs {lib_err:.3g} from the "
              f"plain version", flush=True)
        pairs = float(mask.sum().item())  # (query, key) pairs inside the band
        report(
            "attention_banded", "dorado_tpu_torch/csrc/attention_banded.cu",
            "dorado_tpu/ops/attention.py:398", err,
            time_ms(lambda: attention.windowed_attention_rope(
                qkv, cos, sin, SUP_HEADS, *SUP_WINDOW), 10),
            time_ms(lambda: attention.windowed_attention_rope_plain(
                qkv, cos, sin, SUP_HEADS, *SUP_WINDOW), 1),
            # q.k and p.v over the band's pairs, every head and row
            n * SUP_HEADS * pairs * 4.0 * d_head, PEAK_BF16,
            2 * n * t_len * 3 * hd + 2 * n * t_len * hd + 2 * 4 * t_len * d_head // 2,
            time_ms(lambda: sdpa(q_r, k_r, v_r, attn_mask=mask), 5),
            "(scaled_dot_product_attention, dense T' x T' with a boolean mask, q and k "
            "rotated beforehand)",
        )
        k9_out = out_k
        del out_p, diff, lib

        def hold_attention(what, out_k, out_p):
            torch.cuda.synchronize()
            diff = (out_k.float() - out_p.float()).abs()
            e = diff.max().item()
            print(f"{what}: max abs error {e:.3g}, {(out_k != out_p).float().mean().item():.3%} of "
                  f"outputs differ (by one bf16 step at most)", flush=True)
            if not bool(torch.isfinite(out_k).all()) or not bool(
                    (diff <= TOL_ATTN_ABS + TOL_ATTN_REL * out_p.float().abs()).all()):
                raise AssertionError(f"{what}: max abs error {e}")
            return e

        sdpa_ms = time_ms(lambda: sdpa(q_r, k_r, v_r, attn_mask=mask), 5)
        sdpa_what = ("(scaled_dot_product_attention, dense T' x T' with the same boolean mask, "
                     "q and k rotated beforehand)")
        attn_ops = n * SUP_HEADS * pairs * 4.0 * d_head

        # ---- K10: q and k rotated beforehand (the "ext" route) ---------------
        qk = attention.rope_qk(qkv, cos, sin, SUP_HEADS)
        out_k = attention.windowed_attention_prerotated(qk, qkv, SUP_HEADS, *SUP_WINDOW)
        err = hold_attention(f"attention_prerotated N={n} T'={t_len}", out_k,
                             attention.windowed_attention_prerotated_plain(
                                 qk, qkv, SUP_HEADS, *SUP_WINDOW))
        print(f"  equal to K9's output on the unrotated projection: {torch.equal(out_k, k9_out)}",
              flush=True)
        report(
            "attention_prerotated", "dorado_tpu_torch/csrc/attention_banded.cu",
            "dorado_tpu/ops/attention.py:700", err,
            time_ms(lambda: attention.windowed_attention_prerotated(
                qk, qkv, SUP_HEADS, *SUP_WINDOW), 10),
            time_ms(lambda: attention.windowed_attention_prerotated_plain(
                qk, qkv, SUP_HEADS, *SUP_WINDOW), 1),
            # q | k and the v third read once, the output written once
            attn_ops, PEAK_BF16, 2 * n * t_len * 2 * hd + 2 * n * t_len * hd + 2 * n * t_len * hd,
            sdpa_ms, sdpa_what,
            rope_qk_ms=time_ms(lambda: attention.rope_qk(qkv, cos, sin, SUP_HEADS), 3),
        )
        del qk, out_k

        # ---- K11a: halves-major q and k rows, RoPE inside (the "hp" route) ----
        rows_hp = torch.from_numpy(attention.wqkv_halfperm_rows(SUP_HEADS, hd)).to(dev)
        qkv_hp = qkv[..., rows_hp].contiguous()
        out_k = attention.windowed_attention_halfperm(qkv_hp, cos, sin, SUP_HEADS, *SUP_WINDOW)
        err = hold_attention(f"attention_halfperm N={n} T'={t_len}", out_k,
                             attention.windowed_attention_halfperm_plain(
                                 qkv_hp, cos, sin, SUP_HEADS, *SUP_WINDOW))
        print(f"  equal to K9's output on the natural projection: {torch.equal(out_k, k9_out)}",
              flush=True)
        report(
            "attention_halfperm", "dorado_tpu_torch/csrc/attention_banded.cu",
            "dorado_tpu/ops/attention.py:608", err,
            time_ms(lambda: attention.windowed_attention_halfperm(
                qkv_hp, cos, sin, SUP_HEADS, *SUP_WINDOW), 10),
            time_ms(lambda: attention.windowed_attention_halfperm_plain(
                qkv_hp, cos, sin, SUP_HEADS, *SUP_WINDOW), 1),
            attn_ops, PEAK_BF16,
            2 * n * t_len * 3 * hd + 2 * n * t_len * hd + 2 * 4 * t_len * d_head // 2,
            sdpa_ms, sdpa_what,
        )
        del qkv_hp, out_k, k9_out

        # ---- K11b: separate q, k, v, no rotation ------------------------------
        q4, k4, v4 = (torch.randn(n, t_len, SUP_HEADS, d_head, generator=gen, device=dev).bfloat16()
                      for _ in range(3))
        errs = {}
        for win in (WIDE_WINDOW, SUP_WINDOW):  # the timed window last
            errs[win] = hold_attention(
                f"attention_separate N={n} T'={t_len} window {win}",
                attention.windowed_attention_fused(q4, k4, v4, *win),
                attention.windowed_attention_fused_plain(q4, k4, v4, *win))
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q4, k4, v4))
        wide_mask = attention.band_mask(pos[:, None], pos[None, :], t_len, *WIDE_WINDOW,
                                        attention.ref_strip_elems(t_len))
        wide_pairs = float(wide_mask.sum().item())
        wide_ms = time_ms(lambda: attention.windowed_attention_fused(q4, k4, v4, *WIDE_WINDOW), 10)
        wide_bound, _ = bound_ms(n * SUP_HEADS * wide_pairs * 4.0 * d_head, PEAK_BF16,
                                 4 * 2 * n * t_len * hd)
        print(f"attention_separate at window {WIDE_WINDOW}: {wide_ms:.3f} ms, bound "
              f"{wide_bound:.3f} ms [{card}]", flush=True)
        report(
            "attention_separate", "dorado_tpu_torch/csrc/attention_banded.cu",
            "dorado_tpu/ops/attention.py:88", max(errs.values()),
            time_ms(lambda: attention.windowed_attention_fused(q4, k4, v4, *SUP_WINDOW), 10),
            time_ms(lambda: attention.windowed_attention_fused_plain(q4, k4, v4, *SUP_WINDOW), 1),
            attn_ops, PEAK_BF16, 4 * 2 * n * t_len * hd,
            time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), 5),
            "(scaled_dot_product_attention, dense T' x T' with the same boolean mask)",
            on_path=False, wide_window=list(WIDE_WINDOW), wide_max_abs_err=errs[WIDE_WINDOW],
            wide_ms=wide_ms, wide_bound_ms=wide_bound,
            wide_library_ms=time_ms(lambda: sdpa(qh, kh, vh, attn_mask=wide_mask), 5),
        )
        del qkv, q_r, k_r, v_r, mask, wide_mask, q4, k4, v4, qh, kh, vh

        # ---- K14: out_proj or fc2 + bias + alpha * residual + RMS norm -------
        alpha = sup_v50_config().tx.tx.deepnorm_alpha
        site_numbers = {}
        for site, k_in, with_bias in (("fc2", SUP_FFN, False), ("out_proj", SUP_D, True)):
            x = torch.randn(SUP_M, k_in, generator=gen, device=dev).bfloat16()
            w = (torch.randn(SUP_D, k_in, generator=gen, device=dev) / k_in**0.5).bfloat16()
            b = torch.randn(SUP_D, generator=gen, device=dev) * 0.1 if with_bias else None
            b = None if b is None else b.bfloat16()
            res = torch.randn(SUP_M, SUP_D, generator=gen, device=dev).bfloat16()
            nw = (1.0 + 0.1 * torch.randn(SUP_D, generator=gen, device=dev)).bfloat16()
            args = (x, w, b, res, nw, alpha)
            errs = []
            for m in K14_ROWS:
                out_k = fused_norm.matmul_residual_rmsnorm(*(a[:m] if a is x or a is res else a
                                                             for a in args))
                out_p = fused_norm.matmul_residual_rmsnorm_plain(
                    *(a[:m] if a is x or a is res else a for a in args))
                torch.cuda.synchronize()
                diff = (out_k.float() - out_p.float()).abs()
                share = (out_k != out_p).float().mean().item()
                worst = (diff / (out_p.float().abs() + 1.0)).max().item()
                print(f"fused_norm {site} M={m} K={k_in}: max abs error {diff.max().item():.3g}, "
                      f"{share:.3%} of outputs differ; the largest |err| / (|value| + 1) is "
                      f"{worst:.3g} (limit {TOL_NORM_REL:.3g})", flush=True)
                if (not bool(torch.isfinite(out_k).all()) or worst > TOL_NORM_REL
                        or share > MAX_NORM_SHARE_DIFFERENT):
                    raise AssertionError(f"fused_norm {site} at M={m}: max abs error "
                                         f"{diff.max().item()}, {share:.3%} differ")
                errs.append(diff.max().item())

            def unfused():
                return tx_model.rms_norm(
                    torch.nn.functional.linear(x, w, b) + res * alpha, nw)

            site_numbers[site] = dict(
                err=max(errs),
                ms=time_ms(lambda: fused_norm.matmul_residual_rmsnorm(*args), 10),
                plain_ms=time_ms(lambda: fused_norm.matmul_residual_rmsnorm_plain(*args), 2),
                ops=2.0 * SUP_M * k_in * SUP_D,
                nbytes=2 * SUP_M * k_in + 2 * SUP_D * k_in + 2 * 2 * SUP_M * SUP_D
                + 4 * SUP_D * with_bias + 2 * SUP_D,
                library_ms=time_ms(unfused, 5),
            )
            del x, w, b, res, nw, args, out_k, out_p, diff
        fc2 = site_numbers["fc2"]
        fc2_bound, fc2_by = bound_ms(fc2["ops"], PEAK_BF16, fc2["nbytes"])
        print(f"fused_norm at fc2 (K = {SUP_FFN}, no bias): kernel {fc2['ms']:.3f} ms  plain "
              f"{fc2['plain_ms']:.3f} ms  bound {fc2_bound:.3f} ms ({fc2_by})  library "
              f"{fc2['library_ms']:.3f} ms [{card}]", flush=True)
        o = site_numbers["out_proj"]
        report(
            "fused_norm", "dorado_tpu_torch/csrc/fused_norm.cu",
            "dorado_tpu/ops/fused_norm.py:55", max(o["err"], fc2["err"]), o["ms"], o["plain_ms"],
            o["ops"], PEAK_BF16, o["nbytes"], o["library_ms"],
            "(F.linear, then the residual add, rms_norm and weight passes of the unfused route)",
            fc2_max_abs_err=fc2["err"], fc2_ms=fc2["ms"], fc2_plain_ms=fc2["plain_ms"],
            fc2_bound_ms=fc2_bound, fc2_bound_by=fc2_by, fc2_library_ms=fc2["library_ms"],
        )
        print("  (the row's own numbers are at out_proj: K = 512 with a bias; fc2_* at fc2)",
              flush=True)
        torch.cuda.empty_cache()

        # ---- K12, K13: the W8A8 feed-forward ----------------------------------
        k_in, ffn = SUP_D, SUP_FFN
        wy_q, wy_s = int8_matmul.quantize_weight_rows(
            torch.randn(ffn, k_in, generator=gen, device=dev) / k_in**0.5)
        wg_q, wg_s = int8_matmul.quantize_weight_rows(
            torch.randn(ffn, k_in, generator=gen, device=dev) / k_in**0.5)
        w2_q, w2_s = int8_matmul.quantize_weight_rows(
            torch.randn(k_in, ffn, generator=gen, device=dev) / ffn**0.5)
        fc1 = (wy_q.t(), wy_s, wg_q.t(), wg_s)

        def swiglu_int_mm(xq, xs):
            # the same function through two torch._int_mm and elementwise passes
            y = torch._int_mm(xq, wy_q.t()).float() * xs * wy_s
            g = torch._int_mm(xq, wg_q.t()).float() * xs * wg_s
            t = y * (g * torch.reciprocal(1.0 + torch.exp(-g)))
            s = t.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) * (1.0 / 127.0)
            return torch.round(t * torch.reciprocal(s)).to(torch.int8), s

        def int_mm(xq, wq_t):
            # torch._int_mm takes more than 16 rows, a multiple of 8: other
            # counts are padded with zero rows, cut off again
            m = xq.shape[0]
            pad = max(24, -(-m // 8) * 8) - m
            if pad == 0:
                return torch._int_mm(xq, wq_t)
            return torch._int_mm(torch.nn.functional.pad(xq, (0, 0, 0, pad)), wq_t)[:m]

        def fc2_int_mm(tq, ts):
            return (int_mm(tq, w2_q.t()).float() * ts * w2_s).to(torch.bfloat16)

        def hold_swiglu(what, tq_k, ts_k, tq_p, ts_p):
            rel = ((ts_k - ts_p).abs() / ts_p).max().item()
            dq = (tq_k.int() - tq_p.int()).abs()
            share = (dq > 0).float().mean().item()
            print(f"swiglu_w8a8 {what}: row scales within {rel:.3g} relative, int8 output off "
                  f"by one at {share:.5%} of elements (max difference {dq.max().item()})",
                  flush=True)
            if not (rel <= TOL_SWIGLU_SCALE_REL and dq.max().item() <= 1
                    and share <= MAX_SWIGLU_SHARE_OFF_BY_ONE):
                raise AssertionError(f"swiglu_w8a8 {what}: differs from the plain version")
            return float(dq.max().item()), share

        err12 = share12 = 0.0
        for m in reversed(FFN_ROWS):  # the timed shape last
            x = torch.randn(m, k_in, generator=gen, device=dev).bfloat16()
            xq, xs = int8_matmul.quantize_rows(x)
            tq_k, ts_k = int8_matmul.swiglu_w8a8(xq, xs, *fc1)
            tq_p, ts_p = int8_matmul.swiglu_w8a8_plain(xq, xs, *fc1)
            e_o, s_o = hold_swiglu(f"M={m}", tq_k, ts_k, tq_p, ts_p)
            err12, share12 = max(err12, e_o), max(share12, s_o)
            out_k = int8_matmul.w8a8_matmul(tq_k, ts_k, w2_q.t(), w2_s)
            out_p = int8_matmul.w8a8_matmul_plain(tq_k, ts_k, w2_q.t(), w2_s)
            torch.cuda.synchronize()
            # against the plain version and an independent exact product
            same = torch.equal(out_k, out_p) and torch.equal(out_k, fc2_int_mm(tq_k, ts_k))
            print(f"w8a8_matmul M={m}: bit for bit with the plain version and the torch._int_mm "
                  f"route {same}", flush=True)
            if not same:
                raise AssertionError(
                    f"w8a8_matmul at M={m}: {(out_k != out_p).float().mean().item():.3%} of "
                    f"outputs differ from the plain version (or from the torch._int_mm route)")
            del tq_p, ts_p, out_p
        print(f"  w8a8_matmul's plan at sup's fc2: {int8_matmul.w8a8_plan(ffn, k_in)}", flush=True)
        for m_o, k_o, o_o in K13_OTHER:
            xq_o, xs_o = int8_matmul.quantize_rows(
                torch.randn(m_o, k_o, generator=gen, device=dev).bfloat16())
            wq_o, ws_o = int8_matmul.quantize_weight_rows(
                torch.randn(o_o, k_o, generator=gen, device=dev) / k_o**0.5)
            out_o = int8_matmul.w8a8_matmul(xq_o, xs_o, wq_o.t(), ws_o)
            lib_o = (int_mm(xq_o, wq_o.t()).float() * xs_o * ws_o).to(torch.bfloat16)
            same = (torch.equal(out_o, int8_matmul.w8a8_matmul_plain(xq_o, xs_o, wq_o.t(), ws_o))
                    and torch.equal(out_o, lib_o))
            plan = int8_matmul.w8a8_plan(k_o, o_o)
            print(f"w8a8_matmul M={m_o} K={k_o} O={o_o} ({plan}): bit for bit with the plain "
                  f"version and the torch._int_mm route {same}", flush=True)
            if not same:
                raise AssertionError(f"w8a8_matmul at M={m_o} K={k_o} O={o_o}: differs")
            del xq_o, xs_o, wq_o, ws_o, out_o, lib_o
        for m_o, k_o, f_o in SWIGLU_OTHER:
            plan = int8_matmul.swiglu_plan(k_o, f_o)
            wy_o, wys_o = int8_matmul.quantize_weight_rows(
                torch.randn(f_o, k_o, generator=gen, device=dev) / k_o**0.5)
            wg_o, wgs_o = int8_matmul.quantize_weight_rows(
                torch.randn(f_o, k_o, generator=gen, device=dev) / k_o**0.5)
            xq_o, xs_o = int8_matmul.quantize_rows(
                torch.randn(m_o, k_o, generator=gen, device=dev).bfloat16())
            fc1_o = (wy_o.t(), wys_o, wg_o.t(), wgs_o)
            e_o, s_o = hold_swiglu(
                f"M={m_o} K={k_o} F={f_o} ({plan})", *int8_matmul.swiglu_w8a8(xq_o, xs_o, *fc1_o),
                *int8_matmul.swiglu_w8a8_plain(xq_o, xs_o, *fc1_o))
            err12, share12 = max(err12, e_o), max(share12, s_o)
            del wy_o, wg_o, xq_o, xs_o, fc1_o
        # the two-pass form at sup's shape, held and timed beside the one pass
        tq_2, ts_2 = int8_matmul._swiglu_cuda(xq, xs, *fc1, two_pass=True)
        tq_p, ts_p = int8_matmul.swiglu_w8a8_plain(xq, xs, *fc1)
        e_o, s_o = hold_swiglu(f"M={xq.shape[0]} in the two-pass form", tq_2, ts_2, tq_p, ts_p)
        err12, share12 = max(err12, e_o), max(share12, s_o)
        del tq_2, ts_2, tq_p, ts_p
        two_pass_ms = time_ms(lambda: int8_matmul._swiglu_cuda(xq, xs, *fc1, two_pass=True), 10)
        # the branch-free reciprocal of K12's one-pass epilogue at every float
        # of its range
        rcp_bad = int8_matmul.rcp_near_mismatches(dev)
        print(f"  swiglu_w8a8's branch-free reciprocal differs from __frcp_rn at {rcp_bad} of "
              f"the floats in [1, 2^126)", flush=True)
        if rcp_bad:
            raise AssertionError("swiglu_w8a8: the branch-free reciprocal is not exact")
        lib_q, lib_s = swiglu_int_mm(xq, xs)
        print(f"  the torch._int_mm route of swiglu_w8a8 differs from the kernel at "
              f"{(lib_q != tq_k).float().mean().item():.5%} of elements", flush=True)
        del lib_q, lib_s
        m = FFN_ROWS[0]
        report(
            "swiglu_w8a8", "dorado_tpu_torch/csrc/w8a8_matmul.cu",
            "dorado_tpu/ops/int8_matmul.py:119", err12,
            time_ms(lambda: int8_matmul.swiglu_w8a8(xq, xs, *fc1), 10),
            time_ms(lambda: int8_matmul.swiglu_w8a8_plain(xq, xs, *fc1), 2),
            # one pass over both halves of fc1 is the function's work
            2.0 * m * k_in * 2 * ffn, PEAK_INT8,
            m * k_in + 4 * m + 2 * ffn * k_in + 8 * ffn + m * ffn + 4 * m,
            time_ms(lambda: swiglu_int_mm(xq, xs), 3),
            "(two torch._int_mm and the elementwise passes)",
            share_off_by_one=share12, plan=str(int8_matmul.swiglu_plan(k_in, ffn)),
            two_pass_ms=two_pass_ms, rcp_near_mismatches=rcp_bad,
        )
        print("  (max_abs_err of swiglu_w8a8 is the largest difference of an int8 output; "
              f"the same kernel's two-pass form: {two_pass_ms:.3f} ms)", flush=True)
        report(
            "w8a8_matmul", "dorado_tpu_torch/csrc/w8a8_matmul.cu",
            "dorado_tpu/ops/int8_matmul.py:218", 0.0,
            time_ms(lambda: int8_matmul.w8a8_matmul(tq_k, ts_k, w2_q.t(), w2_s), 10),
            time_ms(lambda: int8_matmul.w8a8_matmul_plain(tq_k, ts_k, w2_q.t(), w2_s), 2),
            2.0 * m * ffn * k_in, PEAK_INT8,
            m * ffn + 4 * m + ffn * k_in + 4 * k_in + 2 * m * k_in,
            time_ms(lambda: fc2_int_mm(tq_k, ts_k), 5),
            "(torch._int_mm and a dequantise pass)",
            plan=str(int8_matmul.w8a8_plan(ffn, k_in)),
        )
        del xq, xs, tq_k, ts_k, out_k, wy_q, wg_q, w2_q

        # ---- K2 at sup's qkv projection: K = 512, O = 1536 ---------------------
        o_qkv = 3 * SUP_D
        wq, ws = int8_matmul.quantize_weight_rows(
            torch.randn(o_qkv, k_in, generator=gen, device=dev) / k_in**0.5)
        out_k = int8_matmul.w8a8_matmul_fq(x, wq.t(), ws)
        out_p = int8_matmul.w8a8_matmul_fq_plain(x, wq.t(), ws)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_p):
            raise AssertionError("w8a8_matmul_fq at sup's qkv shape differs from the plain version")
        sup_times(
            "w8a8_matmul_fq", 0.0,
            time_ms(lambda: int8_matmul.w8a8_matmul_fq(x, wq.t(), ws), 10),
            time_ms(lambda: int8_matmul.w8a8_matmul_fq_plain(x, wq.t(), ws), 2),
            2.0 * m * k_in * o_qkv, PEAK_INT8, 2 * m * k_in + k_in * o_qkv + 8 * o_qkv + 2 * m * o_qkv,
        )
        del x, wq, out_k, out_p

        # ---- K3, K4, K5 at 1024 states ------------------------------------------
        t_s, s_s = SUP_T, SUP_S
        scores = (torch.randn(t_s, N, 4 * s_s, generator=gen, device=dev) * 2).clamp(-5, 5)
        scores = scores.bfloat16()
        beta_k = crf_cuda.backward_scores_shifted(scores, STAY)
        beta_p = crf_cuda.backward_scores_shifted_plain(scores, STAY)
        torch.cuda.synchronize()
        diff = (beta_k.float() - beta_p.float()).abs()
        if not bool((diff <= TOL_BETA_ABS + TOL_BETA_REL * beta_p.float().abs()).all()):
            raise AssertionError(f"crf_lse_backward at S=1024: max abs error {diff.max().item()}")
        sup_times(
            "crf_lse_backward", diff.max().item(),
            time_ms(lambda: crf_cuda.backward_scores_shifted(scores, STAY), 3),
            time_ms(lambda: crf_cuda.backward_scores_shifted_plain(scores, STAY), 1),
            17.0 * t_s * N * s_s, PEAK_F32, 2 * t_s * N * 4 * s_s + 2 * t_s * N * s_s,
        )
        del beta_p
        posts_k, ch_k, fin_k = crf_cuda.fused_forward_decode(scores, beta_k, STAY)
        posts_p, ch_p, fin_p = crf_cuda.fused_forward_decode_plain(scores, beta_k, STAY)
        torch.cuda.synchronize()
        if not torch.equal(ch_k, ch_p) or not torch.equal(fin_k, fin_p):
            raise AssertionError(
                f"crf_fused_forward at S=1024: {(ch_k != ch_p).sum().item()} choices differ "
                f"(or the final carry)")
        diff = (posts_k.float() - posts_p.float()).abs()
        if not bool((diff <= TOL_POSTS_ABS + TOL_POSTS_REL * posts_p.float().abs()).all()):
            raise AssertionError(
                f"crf_fused_forward at S=1024: posts max abs error {diff.max().item()}")
        sup_times(
            "crf_fused_forward", diff.max().item(),
            time_ms(lambda: crf_cuda.fused_forward_decode(scores, beta_k, STAY), 3),
            time_ms(lambda: crf_cuda.fused_forward_decode_plain(scores, beta_k, STAY), 1),
            30.0 * t_s * N * s_s, PEAK_F32,
            2 * t_s * N * 4 * s_s + 5 * t_s * N * s_s + 4 * N * s_s,
        )
        del posts_k, posts_p, ch_p, diff, beta_k
        last = torch.argmax(fin_k, dim=-1).to(torch.int32)
        st_k, mv_k = hold_traceback(ch_k, last, f"T={t_s} N={N} S={s_s}")
        sup_times(
            "crf_traceback", 0.0,
            device_ms(lambda: crf_cuda.viterbi_traceback(ch_k, last), 20, "traceback_kernel"),
            time_ms(lambda: crf_cuda.viterbi_traceback_plain(ch_k, last), 1),
            4.0 * t_s * N, PEAK_F32, t_s * N * (1 + 4 + 1) + 4 * N,
        )
        print(f"  crf_traceback design floor at sup shapes: "
              f"{traceback_floor_ms(t_s, N, s_s):.4f} ms  [{card}]", flush=True)

        # ---- K3's full-history outputs: the scans at 1024 states ----------------
        scores32 = scores.float()
        del scores
        errs = hold_lse(scores32, f"T={t_s} N={N} S={s_s}")
        lse_report("crf_lse_scan_1024", "dorado_tpu/ops/crf_pallas.py:461", scores32, errs,
                   ["sup beam", "lstm sup beam"])

        # ---- K7b: the Viterbi forward pass alone at 1024 states ---------------
        ch7, fin7 = hold_viterbi(scores32, f"T={t_s} N={N} S={s_s}")
        cross_check_viterbi(ch7, fin7, ch_k, fin_k, (st_k, mv_k), scores32, f"S={s_s}")
        report(
            "crf_viterbi_forward_1024", "dorado_tpu_torch/csrc/crf_viterbi_forward.cu",
            "dorado_tpu/ops/crf_pallas.py:576", 0.0,
            time_ms(lambda: crf_cuda.viterbi_forward(scores32, STAY), 3),
            time_ms(lambda: crf_cuda.viterbi_forward_plain(scores32, STAY), 1),
            VITERBI_OPS * t_s * N * s_s, PEAK_F32,
            4 * t_s * N * 4 * s_s + t_s * N * s_s + 4 * N * s_s, None,
            wrappers=["crf_viterbi_forward"], paths=[], on_path=False,
        )
        # ---- K8 at 1024 states: against its plain version and K7b -------------
        beta32 = crf_cuda.backward_scores(scores32, STAY)
        _, err8 = hold_full(scores32, beta32, f"T={t_s} N={N} S={s_s}", (ch7, fin7))
        sup_times(
            "crf_fused_forward_f32", err8,
            time_ms(lambda: crf_cuda.fused_forward_decode_full(scores32, beta32, STAY), 3),
            time_ms(lambda: crf_cuda.fused_forward_decode_full_plain(scores32, beta32, STAY), 1),
            30.0 * t_s * N * s_s, PEAK_F32,
            4 * t_s * N * 4 * s_s + 4 * (t_s + 1) * N * s_s + 4 * t_s * N * s_s + t_s * N * s_s
            + 4 * N * s_s,
        )
        del scores32, beta32, ch_k, ch7, st_k, mv_k
    torch.cuda.empty_cache()

    # ---- float32 forms of K2, K13, K10 and K14 ---------------------------------
    kit = types.SimpleNamespace(
        torch=torch, dev=dev, gen=gen, card=card, time_ms=time_ms, report=report, rows=rows,
        int8_matmul=int8_matmul, attention=attention, fused_norm=fused_norm, tx_model=tx_model,
        lstm=lstm, sup_alpha=sup_v50_config().tx.tx.deepnorm_alpha)
    t0 = time.perf_counter()
    float32_kernels(kit)
    print(f"float32 kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    wide_kernels(kit)
    print(f"wide K1 and K11a float32 checks: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    duplex_kernels(kit)
    print(f"K1 and K2 at the stereo shapes: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the model and the pipelines at hac v4.3's full width ---------------
    cfg = hac_v43_config()
    cfg.normalise_basecaller_params()
    plain_model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(SEED))
    model = init_lstm_crf_params(cfg, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.linear1_w.mul_(HEAD_GAIN)
    hac_model = model  # the sup checks below reuse the name ``model``
    # W8A8 is the default precision on the card
    pipe = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True)
    beam_pipe = BasecallerPipeline(cfg, model, batch_size=N, emit_moves=True, decoder="beam")
    for p in (pipe, beam_pipe):
        if p.runner.chunk_size // cfg.stride != T or p.runner.lstm_precision != "w8a8":
            raise AssertionError(
                f"chunk size {p.runner.chunk_size} does not give T = {T}, or not W8A8")
    runner, beam_runner = pipe.runner, beam_pipe.runner

    rs = np.random.RandomState(SEED)
    run_info = smoke_run_info()

    def make_read(i, n, gen=None):
        # from rs unless another generator is given
        return smoke_read(i, n, gen or rs, run_info)

    # two short reads send chunks to the short-chunk lane too
    reads = [
        make_read(i, int(rs.randint(3_000, 7_001) if i < 2 else rs.randint(20_000, 60_001)))
        for i in range(N_READS)
    ]

    # sup v5.0 at full width, W8A8 encoder matmuls (the default on the card)
    sup_cfg = sup_v50_config()
    sup_cfg.normalise_basecaller_params()
    sup_model = init_tx_params(sup_cfg, torch.Generator().manual_seed(SEED))
    sup_pipe = BasecallerPipeline(sup_cfg, sup_model, batch_size=N, emit_moves=True)
    sup_runner = sup_pipe.runner
    if (sup_runner.chunk_sizes != [12 * SUP_TOK, 9 * SUP_TOK] or sup_runner.tx_precision != "w8a8"
            or sup_cfg.num_states != SUP_S or len(sup_runner.model.layers) != 18):
        raise AssertionError("the sup pipeline is not sup v5.0 at chunk 12288 with W8A8")
    # the same model on the halves-major attention route (K11a) with the fused
    # residual norms (K14), W8A8
    hp_pipe = BasecallerPipeline(sup_cfg, sup_model, batch_size=N, emit_moves=True,
                                 tx_attention="hp", tx_fused_norm=True)
    hp_model = hp_pipe.runner.model
    if (hp_model.attention, hp_model.fused_norm, hp_model.precision) != ("hp", True, "w8a8"):
        raise AssertionError("the hp pipeline is not on the hp route with the fused norm, W8A8")
    # the same model with the beam decoder, W8A8
    sup_beam_pipe = BasecallerPipeline(sup_cfg, sup_model, batch_size=N, emit_moves=True,
                                       decoder="beam")
    sup_beam_runner = sup_beam_pipe.runner
    if (sup_beam_runner.decoder, sup_beam_runner.tx_precision) != ("beam", "w8a8"):
        raise AssertionError("the sup beam pipeline is not W8A8 with the beam decoder")
    # 12 long reads of 12 chunks each fill one batch of the long lane and
    # start a second; three short reads go to the 9216 lane
    sup_reads = [
        make_read(100 + i, int(rs.randint(4_000, 9_001)) if i < SUP_SHORT_READS else 140_000)
        for i in range(SUP_SHORT_READS + SUP_LONG_READS)
    ]

    # ---- K17: beam search, on the model's own scores ------------------------
    buf = runner.make_input_buffer(0)
    buf[:] = rs.randn(*buf.shape)
    with torch.inference_mode():
        scores = runner.model(torch.from_numpy(buf).to(dev)).contiguous()
        if scores.shape != (T, N, 4 * S) or scores.dtype != torch.float32:
            raise AssertionError(f"model scores: {tuple(scores.shape)} {scores.dtype}")

        def hold_beam(sc, back_guide, what):
            """Kernel against plain beam on the same scores and back guide:
            (share of positions that differ, rows that differ, the kernel's
            history, the plain forward beam's ms)."""
            hist_k = beam.beam_forward(sc, back_guide, W, BEAM_CUT, STAY)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist_p = beam.beam_forward_plain(sc, back_guide, W, BEAM_CUT, STAY)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            st_k, mv_k = beam.beam_traceback(*hist_k)
            st_p, mv_p = beam.beam_traceback_plain(*hist_p)
            different = (st_k != st_p) | (mv_k != mv_p)
            per_row = different.sum(dim=1)
            rows_different = int((per_row > 0).sum().item())
            positions_different = different.float().mean().item()
            print(
                f"beam_search vs plain at {what}, W={W}: {rows_different} rows differ, "
                f"{positions_different:.4%} of positions; differing steps by row "
                f"{ {i: int(c) for i, c in enumerate(per_row.tolist()) if c} }; "
                f"{mv_k.float().mean().item():.1%} of steps emit a base", flush=True)
            if (rows_different > BEAM_MAX_ROWS_DIFFERENT
                    or per_row.max().item() > BEAM_MAX_ROW_SHARE_DIFFERENT * sc.shape[0]):
                raise AssertionError(
                    f"beam_search at {what}: outcomes differ from the plain beam's")
            # the traceback kernel against its plain version on the same
            # history, also launched into outputs filled with a sentinel first
            st_s = torch.full(st_k.shape, SENTINEL_STATE, dtype=torch.int32, device=dev)
            mv_s = torch.full(mv_k.shape, SENTINEL_MOVE, dtype=torch.uint8, device=dev)
            beam._launch_traceback(*hist_k, st_s, mv_s)
            tb_p = beam.beam_traceback_plain(*hist_k)
            if not (torch.equal(st_k, tb_p[0]) and torch.equal(mv_k, tb_p[1])
                    and torch.equal(st_s, tb_p[0]) and torch.equal(mv_s, tb_p[1])):
                raise AssertionError(f"beam_traceback at {what}: states or moves differ from the "
                                     f"plain version's (or a position was not written)")
            return positions_different, rows_different, hist_k, mv_k, plain_ms

        def beam_traceback_floor_ms(t_len, n):
            """The design floor of the beam traceback: each step's whole state
            and ps rows read once, the states and moves written once."""
            return (t_len * n * W * (4 + 1) + t_len * n * (4 + 1) + 4 * n * W) / HBM_BYTES_S * 1e3

        # 64 states (the kernel's other instantiation) at a short T, and T
        # below the ring's depth and T, N no multiple of anything the kernel
        # works in, at 64, 256 and 1024 states; the traceback also at T = 1
        # and one step below and above its ring's depth
        small = (torch.randn(64, 8, 4 * 64, generator=gen, device=dev) * 2).clamp(-5, 5)
        hold_beam(small, crf_cuda.backward_scores(small, STAY), "T=64 N=8 S=64")
        for t_len, n, s in BEAM_SHAPES:
            sc = (torch.randn(t_len, n, 4 * s, generator=gen, device=dev) * 2).clamp(-5, 5)
            hold_beam(sc, crf_cuda.backward_scores(sc, STAY), f"T={t_len} N={n} S={s}")
        beta = crf_cuda.backward_scores(scores, STAY)
        positions_different, rows_different, hist, mv_k, plain_fwd_ms = hold_beam(
            scores, beta, f"T={T} N={N} S={S}")
        if not mv_k.float().mean().item() > 0.05:
            raise AssertionError("beam_search: the paths emit no bases")
        c = 4 * S
        report(
            "beam_search", "dorado_tpu_torch/csrc/beam_search.cu",
            "dorado_tpu/ops/beam_pallas.py:348", positions_different,
            time_ms(lambda: beam.beam_forward(scores, beta, W, BEAM_CUT, STAY), 3),
            plain_fwd_ms,
            # the W x 4W match both ways, the counts of at most 11 cutoffs, the
            # candidates and the selection: about 2*4W + 5*11 + 60 a lane and step
            float(T * N * W * (8 * W + 115)), PEAK_F32,
            4 * T * N * c + 4 * T * N * S + T * N * W * 5 + N * W * (4 + 4 + 4), None,
            rows_different=rows_different,
        )
        print("  (max_abs_err of beam_search is the share of positions that differ from the "
              "plain beam's)", flush=True)
        report(
            "beam_traceback", "dorado_tpu_torch/csrc/beam_search.cu",
            "dorado_tpu/ops/beam.py:303", 0.0,
            device_ms(lambda: beam.beam_traceback(*hist), 20, "traceback_kernel"),
            time_ms(lambda: beam.beam_traceback_plain(*hist), 1),
            4.0 * T * N, PEAK_F32, T * N * (4 + 1 + 4 + 1) + 4 * N * W, None,
            event_ms=time_ms(lambda: beam.beam_traceback(*hist), 20),
        )
        print(f"  beam_traceback: device time from the profiler; events around 20 launches "
              f"{rows[-1]['event_ms']:.4f} ms; design floor (each step's whole state and ps "
              f"rows read once) {beam_traceback_floor_ms(T, N):.4f} ms  [{card}]", flush=True)
        del scores, beta, hist, small
        torch.cuda.empty_cache()

        # K17 and the beam traceback at 1024 states, on the sup model's own
        # float32 scores (the beam route's head output)
        buf = sup_runner.make_input_buffer(0)
        buf[:] = rs.randn(*buf.shape)
        scores = sup_runner.model(torch.from_numpy(buf).to(dev), score_dtype=torch.float32)
        if scores.shape != (SUP_T, N, 4 * SUP_S) or scores.dtype != torch.float32:
            raise AssertionError(f"sup model scores: {tuple(scores.shape)} {scores.dtype}")
        beta = crf_cuda.backward_scores(scores, STAY)
        positions_different, rows_different, hist, mv_k, plain_fwd_ms = hold_beam(
            scores, beta, f"T={SUP_T} N={N} S={SUP_S}")
        if not mv_k.float().mean().item() > 0.05:
            raise AssertionError("beam_search at 1024 states: the paths emit no bases")
        c = 4 * SUP_S
        sup_times(
            "beam_search", positions_different,
            time_ms(lambda: beam.beam_forward(scores, beta, W, BEAM_CUT, STAY), 3), plain_fwd_ms,
            float(SUP_T * N * W * (8 * W + 115)), PEAK_F32,
            4 * SUP_T * N * c + 4 * SUP_T * N * SUP_S + SUP_T * N * W * 5 + N * W * 12,
        )
        sup_times(
            "beam_traceback", 0.0,
            device_ms(lambda: beam.beam_traceback(*hist), 20, "traceback_kernel"),
            time_ms(lambda: beam.beam_traceback_plain(*hist), 1),
            4.0 * SUP_T * N, PEAK_F32, SUP_T * N * (4 + 1 + 4 + 1) + 4 * N * W,
        )
        print(f"  beam_traceback design floor at sup shapes: "
              f"{beam_traceback_floor_ms(SUP_T, N):.4f} ms  [{card}]", flush=True)
        del scores, beta, hist
    torch.cuda.empty_cache()

    # ---- main paths: the simplex pipeline with each decoder -----------------
    class Discard:
        def write(self, rec):
            pass

    class Parents:
        """A writer's wrapper that keeps each record's read: its own name, or
        its parent's for a subread."""

        def __init__(self, inner):
            self.inner, self.parents, self.subreads = inner, [], 0

        def write(self, rec):
            pi = next((t.value for t in rec.tags if t.tag == "pi"), None)
            self.parents.append(pi or rec.qname)
            self.subreads += pi is not None
            self.inner.write(rec)

    wrappers = {
        "lstm_scan": lstm.lstm_scan_time_major,
        "w8a8_matmul_fq": int8_matmul.w8a8_matmul_fq,
        "crf_lse_backward": crf_cuda.backward_scores_shifted,
        "crf_fused_forward": crf_cuda.fused_forward_decode,
        "crf_traceback": crf_cuda.viterbi_traceback,
        "crf_lse_scan_forward": crf_cuda.forward_scores,
        "crf_lse_scan_backward": crf_cuda.backward_scores,
        "crf_lse_scans": crf_cuda.forward_backward_scores,
        "beam_search": beam.beam_forward,
        "beam_traceback": beam.beam_traceback,
        "attention_banded": attention.windowed_attention_rope,
        "swiglu_w8a8": int8_matmul.swiglu_w8a8,
        "w8a8_matmul": int8_matmul.w8a8_matmul,
        "attention_prerotated": attention.windowed_attention_prerotated,
        "attention_halfperm": attention.windowed_attention_halfperm,
        "attention_separate": attention.windowed_attention_fused,
        "fused_norm": fused_norm.matmul_residual_rmsnorm,
        "crf_viterbi_forward": crf_cuda.viterbi_forward,
        "crf_fused_forward_f32": crf_cuda.fused_forward_decode_full,
        "lstm_scan_int8": lstm.lstm_scan_time_major_int8,
        "lstm_fused": lstm.lstm_fused_time_major,
        "lstm_scan_f32": lstm.lstm_scan_time_major_f32,
        "w8a8_matmul_fq_f32": int8_matmul.w8a8_matmul_fq_f32,
        "w8a8_matmul_f32": int8_matmul.w8a8_matmul_f32,
        "attention_prerotated_f32": attention.windowed_attention_prerotated_f32,
        "fused_norm_f32": fused_norm.matmul_residual_rmsnorm_f32,
        "lstm_scan_wide": lstm.lstm_scan_time_major_wide,
        "lstm_scan_wide_f32": lstm.lstm_scan_time_major_wide_f32,
        "attention_halfperm_f32": attention.windowed_attention_halfperm_f32,
    }
    # each path's kernels and, for the sup paths, their launches a batch
    path_kernels = {
        "viterbi": ["lstm_scan", "w8a8_matmul_fq", "crf_lse_backward", "crf_fused_forward",
                    "crf_traceback"],
        "beam": ["lstm_scan", "w8a8_matmul_fq", "crf_lse_scans", "beam_search",
                 "beam_traceback"],
        "sup viterbi": ["w8a8_matmul_fq", "attention_banded", "swiglu_w8a8", "w8a8_matmul",
                        "crf_lse_backward", "crf_fused_forward", "crf_traceback"],
        "sup hp fused": ["w8a8_matmul_fq", "attention_halfperm", "fused_norm", "swiglu_w8a8",
                         "w8a8_matmul", "crf_lse_backward", "crf_fused_forward", "crf_traceback"],
        "sup beam": ["w8a8_matmul_fq", "attention_banded", "swiglu_w8a8", "w8a8_matmul",
                     "crf_lse_scans", "beam_search", "beam_traceback"],
        # one device step each, below
        "sup ext bf16": ["attention_prerotated", "fused_norm", "crf_lse_backward",
                         "crf_fused_forward", "crf_traceback"],
        # hac's Viterbi path with the modbase caller's K1 float32
        "modbase": ["lstm_scan", "w8a8_matmul_fq", "crf_lse_backward", "crf_fused_forward",
                    "crf_traceback", "lstm_scan_f32"],
        "sup int8": ["attention_banded", "crf_lse_backward", "crf_fused_forward",
                     "crf_traceback"],
        # compute_dtype=torch.float32 (the Viterbi decode stays bf16)
        "hac f32 viterbi": ["lstm_scan_f32", "w8a8_matmul_fq_f32", "crf_lse_backward",
                            "crf_fused_forward", "crf_traceback"],
        "hac f32 beam": ["lstm_scan_f32", "w8a8_matmul_fq_f32", "crf_lse_scans", "beam_search",
                         "beam_traceback"],
        "sup f32": ["w8a8_matmul_fq_f32", "attention_prerotated_f32", "swiglu_w8a8",
                    "w8a8_matmul_f32", "crf_lse_backward", "crf_fused_forward", "crf_traceback"],
        "sup f32 fused": ["w8a8_matmul_fq_f32", "attention_prerotated_f32", "fused_norm_f32",
                          "swiglu_w8a8", "w8a8_matmul_f32", "crf_lse_backward",
                          "crf_fused_forward", "crf_traceback"],
        # fast v4.0: unquantised projections (H = 96)
        "fast viterbi": ["lstm_scan", "crf_lse_backward", "crf_fused_forward", "crf_traceback"],
        "fast beam": ["lstm_scan", "crf_lse_scans", "beam_search", "beam_traceback"],
        "fast f32": ["lstm_scan_f32", "crf_lse_backward", "crf_fused_forward", "crf_traceback"],
        # the LSTM-sup class: K1's wide form, 1024 states
        "lstm sup viterbi": ["lstm_scan_wide", "w8a8_matmul_fq", "crf_lse_backward",
                             "crf_fused_forward", "crf_traceback"],
        "lstm sup beam": ["lstm_scan_wide", "w8a8_matmul_fq", "crf_lse_scans", "beam_search",
                          "beam_traceback"],
        "lstm sup f32": ["lstm_scan_wide_f32", "w8a8_matmul_fq_f32", "crf_lse_backward",
                         "crf_fused_forward", "crf_traceback"],
        # sup at float32 on the "hp" route (K11a at float32)
        "sup hp f32": ["w8a8_matmul_fq_f32", "attention_halfperm_f32", "swiglu_w8a8",
                       "w8a8_matmul_f32", "crf_lse_backward", "crf_fused_forward",
                       "crf_traceback"],
        # duplex: hac's simplex path and the stereo model's, on the same
        # kernels (5 LSTM layers a batch of either); one stereo device step
        # alone; the command line; the modbase models' K1 float32 besides
        "duplex viterbi": ["lstm_scan", "w8a8_matmul_fq", "crf_lse_backward",
                           "crf_fused_forward", "crf_traceback"],
        "duplex beam": ["lstm_scan", "w8a8_matmul_fq", "crf_lse_scans", "beam_search",
                        "beam_traceback"],
        "duplex f32": ["lstm_scan_f32", "w8a8_matmul_fq_f32", "crf_lse_backward",
                       "crf_fused_forward", "crf_traceback"],
        "duplex modbase": ["lstm_scan", "w8a8_matmul_fq", "crf_lse_backward",
                           "crf_fused_forward", "crf_traceback", "lstm_scan_f32"],
    }
    for what in ("viterbi", "beam", "f32"):
        path_kernels[f"stereo {what}"] = path_kernels[f"duplex {what}"]
    # polishing: the counts GRU on cuDNN (no hand-written kernel), the
    # read-level model's four LSTM directions a window on K1 float32
    path_kernels["polish counts"] = []
    path_kernels["polish rl"] = ["lstm_scan_f32"]
    # variant calling: the slot model's four alternating LSTMs a window and
    # the perceiver's decoder LSTM on K1 float32 (the attention on PyTorch's
    # memory-efficient kernel)
    path_kernels["variant slot"] = ["lstm_scan_f32"]
    path_kernels["variant perceiver"] = ["lstm_scan_f32"]
    path_kernels["cli duplex"] = path_kernels["duplex viterbi"]
    # read correction: the model's matmuls on cuBLAS, no hand-written kernel
    path_kernels["correct nn"] = []
    per_batch = {
        "sup viterbi": [18, 18, 18, 18, 1, 1, 1],
        "sup hp fused": [18, 18, 18, 18, 18, 1, 1, 1],
        "sup beam": [18, 18, 18, 18, 1, 1, 1],
        "sup ext bf16": [18, 36, 1, 1, 1],  # the fused norm at out_proj and at fc2
        "sup int8": [18, 1, 1, 1],
        "sup f32": [18, 18, 18, 18, 1, 1, 1],
        "sup f32 fused": [18, 18, 18, 18, 18, 1, 1, 1],
        # five LSTM layers a batch, K2 at each of hac's
        "hac f32 viterbi": [5, 5, 1, 1, 1],
        "fast viterbi": [5, 1, 1, 1],
        "fast f32": [5, 1, 1, 1],
        "lstm sup viterbi": [5, 5, 1, 1, 1],
        "lstm sup beam": [5, 5, 1, 1, 1],
        "lstm sup f32": [5, 5, 1, 1, 1],
        "sup hp f32": [18, 18, 18, 18, 1, 1, 1],
        # a simplex or a stereo batch: 5 LSTM layers, one decode
        **{f"{kind} {what}": [5, 5, 1, 1, 1] for kind in ("duplex", "stereo")
           for what in ("viterbi", "beam", "f32")},
        "polish rl": [4],  # a window
        "variant slot": [4],  # a window
        "variant perceiver": [1],  # a window
    }

    def check_launches(path, counts, batches):
        for name, count in counts.items():
            if (count > 0) != (name in path_kernels[path]):
                raise AssertionError(
                    f"{path} launched {name} {count} times: its path is {path_kernels[path]}")
        if path in per_batch:
            want = {name: batches * k for name, k in zip(path_kernels[path], per_batch[path])}
            got = {name: counts[name] for name in want}
            if got != want:
                raise AssertionError(f"{path}: launches {got}, expected {want} over {batches} "
                                     f"batches")

    hac_what = f"hac v4.3, batch {N}, bf16 with W8A8 projections"
    sup_what = f"sup v5.0, 18 layers, batch {N}, bf16 with W8A8 encoder matmuls"
    hp_what = sup_what + ", hp attention route, fused norms"
    sup_beam_what = sup_what + ", beam decoder"
    launches = {}
    for decoder, p, path_reads, what in (
        ("viterbi", pipe, reads, hac_what), ("beam", beam_pipe, reads, hac_what),
        ("sup viterbi", sup_pipe, sup_reads, sup_what),
        ("sup hp fused", hp_pipe, sup_reads, hp_what),
        ("sup beam", sup_beam_pipe, sup_reads, sup_beam_what),
    ):
        n_reads, samples = len(path_reads), sum(len(r.signal) for r in path_reads)
        # a first run over the same reads pays the one-time set-up of each new
        # batch shape (cuDNN and cuBLAS plans), which the measured run reuses
        t0 = time.perf_counter()
        p.run_reads(path_reads, Discard())
        torch.cuda.synchronize()
        print(f"{decoder}: first run, incl. per-shape set-up: {time.perf_counter() - t0:.3f} s",
              flush=True)
        bam = io.BytesIO()
        writer = BamWriter(bam, p.build_header([run_info]))
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = Parents(writer)
        stats = p.run_reads(path_reads, written)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches[decoder] = {name: w.launches for name, w in wrappers.items()}
        writer.close()

        data = bam.getvalue()
        # splitting is on (the default): every read has its record or subreads
        if (stats.reads_called != writer.records_written
                or set(written.parents) != {r.read_id for r in path_reads}):
            raise AssertionError(f"{decoder}: {writer.records_written} records of "
                                 f"{len(set(written.parents))} of {n_reads} reads written")
        if data[:4] != b"\x1f\x8b\x08\x04":
            raise AssertionError(f"{decoder}: output does not start with the BGZF magic")
        # the sup paths: 18 encoder layers a batch, one decode a batch, a full
        # batch among them
        check_launches(decoder, launches[decoder], stats.batches)
        if decoder.startswith("sup") and (stats.batches < 3 or stats.bases_called == 0):
            raise AssertionError(f"{decoder} pipeline: {stats.batches} batches (at least 3), "
                                 f"{stats.bases_called} bases")
        print(
            f"{decoder} pipeline: {n_reads} reads ({writer.records_written} records, "
            f"{written.subreads} of them subreads), {samples} samples, {stats.batches} batches, "
            f"{stats.bases_called} bases in {elapsed:.3f} s = {samples / elapsed:.0f} samples/s "
            f"({what}) [{card}]; launches "
            f"{ {k: v for k, v in launches[decoder].items() if v} }; "
            f"device idle {stats.device_idle_s:.3f} s, host blocked in dispatch "
            f"{stats.dispatch_wait_s:.3f} s and in finish {stats.finish_wait_s:.3f} s; host "
            f"finish (stitch, split, tags) {stats.host_finish_s:.3f} thread-s",
            flush=True,
        )

    # ---- main paths: float32 compute, and fast v4.0 ------------------------
    kit.__dict__.update(
        wrappers=wrappers, check_launches=check_launches, launches=launches, Discard=Discard,
        Parents=Parents, lstm=lstm, crf_cuda=crf_cuda, crf_scan=crf_scan, beam=beam)
    t0 = time.perf_counter()
    float32_paths(kit, cfg, model, reads, sup_cfg, sup_model, sup_reads)
    fast = fast_phase(kit, reads)
    print(f"float32 and fast phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lstm_sup = lstm_sup_phase(kit, make_read)
    print(f"LSTM-sup phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- main paths: modified-base calling, then the command line ----------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_modbase_") as mod_tmp:
        mod_cfg = hac_5mcg_5hmcg_v3_config()
        levels = np.random.RandomState(SEED).randn(4**mod_cfg.kmer_len).astype(np.float32)
        mod_dir = save_modbase_model(
            mod_cfg, init_modbase_params(mod_cfg, torch.Generator().manual_seed(SEED)),
            Path(mod_tmp) / mod_cfg.model_path.name, refine_levels=levels)
        t0 = time.perf_counter()
        modbase_phase(cfg, model, reads, run_info, mod_dir, wrappers, check_launches, launches,
                      smi)
        print(f"modbase phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        duplex_phase(kit, cfg, model, mod_dir)
        print(f"duplex phase: {time.perf_counter() - t0:.1f} s", flush=True)
        cli_phase(cfg, model, sup_cfg, sup_model, wrappers, check_launches, path_kernels,
                  launches, card, mod_dir, fast, lstm_sup)
    batch_sweep(cfg, model, card)
    torch.cuda.empty_cache()

    # ---- outputs against references on a small input ------------------------
    def sequences(out):
        """[3, N, T] decode output -> each row's called sequence."""
        return [out[0][i][out[2][i].astype(bool)].tobytes().decode() for i in range(out.shape[1])]

    def identity(a, b) -> tuple[float, float]:
        """(lowest, highest) similarity ratio of two decode outputs' rows."""
        ratios = [
            difflib.SequenceMatcher(None, x, y, autojunk=False).ratio()
            for x, y in zip(sequences(a), sequences(b))
        ]
        return min(ratios), max(ratios)

    def planted_scores(t_len, n, S=S):
        """Float32 scores [t_len, n, 4S] that favour one random path per row
        (half stays, half steps), and that path in the decode output's
        layout [3, n, t_len] (bases, unused, moves)."""
        state_len = S.bit_length() // 2
        moves = torch.rand(t_len, n, generator=gen, device=dev) < 0.5
        bases = torch.randint(0, 4, (t_len, n), generator=gen, device=dev)
        sc = torch.randn(t_len, n, 4 * S, generator=gen, device=dev)
        sc = torch.where(moves[..., None], sc, sc - 3.0).clamp(-5, 5)
        state = torch.randint(0, S, (n,), generator=gen, device=dev)
        states = torch.empty(t_len, n, dtype=torch.int64, device=dev)
        rows_idx = torch.arange(n, device=dev)
        for t in range(t_len):
            nxt = ((state << 2) | bases[t]) & (S - 1)
            flat = nxt * 4 + (state >> (2 * (state_len - 1)))
            sc[t, rows_idx[moves[t]], flat[moves[t]]] = 5.0
            state = torch.where(moves[t], nxt, state)
            states[t] = state
        alphabet = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
        truth = torch.stack([
            alphabet[(states & 3)].t(), torch.zeros(n, t_len, dtype=torch.uint8, device=dev),
            moves.t().to(torch.uint8),
        ])
        return sc, truth.cpu().numpy()

    kw = dict(batch_size=N)
    bf16_runner = TorchBasecallRunner(cfg, model, lstm_precision="bf16", **kw)
    cpu_runner = TorchBasecallRunner(cfg, model, device="cpu", lstm_precision="w8a8", **kw)
    sig = np.stack([
        pipe.scaler.scale_read(r.signal, read_scale=0.2)[0][10 : 10 + runner.chunk_size]
        for r in reads[2:6]  # long reads: each fills a whole chunk
    ]).astype(np.float16)
    with torch.inference_mode():
        on_dev = torch.from_numpy(sig).to(dev)
        scores = runner.model(on_dev)
        ref_scores = cpu_runner.model(torch.from_numpy(sig))
        if scores.shape != (T, 4, cfg.outsize) or not bool(torch.isfinite(scores).all()):
            raise AssertionError("model scores are not finite or of the wrong shape")
        score_err = (scores.cpu() - ref_scores).abs()
        if not score_err.mean() <= 0.02 * ref_scores.abs().mean():
            raise AssertionError(f"bf16 model vs float32 model: mean abs error {score_err.mean()}")
        print(
            f"W8A8 model, bf16 on the card vs float32 on the CPU: mean abs {score_err.mean():.4f} "
            f"(max {score_err.max():.4f})", flush=True)

        # W8A8 against bf16 projections, on the card, with the head as drawn
        # (the gain saturates the head's tanh and hides the difference)
        q_scores = TorchBasecallRunner(cfg, plain_model, **kw).model(on_dev)
        b_scores = TorchBasecallRunner(cfg, plain_model, lstm_precision="bf16", **kw).model(on_dev)
        rel = (torch.linalg.norm(q_scores - b_scores) / torch.linalg.norm(b_scores)).item()
        agree = (q_scores.argmax(-1) == b_scores.argmax(-1)).float().mean().item()
        print(f"W8A8 vs bf16 projections on the card: relative norm error {rel:.4f}, "
              f"argmax agreement {agree:.4f}", flush=True)
        if not (rel < MAX_W8A8_REL_ERR and agree > MIN_W8A8_ARGMAX_AGREE):
            raise AssertionError("W8A8 scores are too far from the bf16 model's")

        # the Viterbi decode on the card against the CPU's plain decode
        vit_scores = scores.to(torch.bfloat16)
        on_card = runner.decode_scores(vit_scores).cpu().numpy()
        on_cpu = cpu_runner.decode_scores(vit_scores.float().cpu()).numpy()
        if not (np.array_equal(on_card[0], on_cpu[0]) and np.array_equal(on_card[2], on_cpu[2])):
            raise AssertionError("device decode: sequences or moves differ from the CPU decode")
        emit = on_card[2].astype(bool)
        q = on_card[1][emit].astype(np.int32) - 33
        if emit.sum() == 0 or q.min() < 1 or q.max() > 50:
            raise AssertionError("device decode: no bases, or qual chars out of [1, 50]")
        print(
            f"Viterbi decode: {int(emit.sum())} bases equal to the CPU decode, qual chars "
            f"differing at {np.mean(on_card[1][emit] != on_cpu[1][emit]):.3%}", flush=True)

        # the beam search on the card against the plain beam on the CPU, on
        # the same scores: first with the card's back guide copied over, where
        # only K17's own rounding can part them (its limits above), then
        # through the runners, each with its own back guide
        back_guide = crf_cuda.backward_scores(scores, STAY)
        st_k, mv_k = beam.beam_search_device(scores, back_guide, W, BEAM_CUT, STAY)
        st_c, mv_c = beam.beam_search_plain(scores.cpu(), back_guide.cpu(), W, BEAM_CUT, STAY)
        per_row = ((st_k.cpu() != st_c) | (mv_k.cpu() != mv_c)).sum(dim=1).tolist()
        print(f"beam search on the card vs the CPU's plain beam, the card's back guide on both: "
              f"differing steps by row {per_row} of {T}", flush=True)
        if (sum(c > 0 for c in per_row) > BEAM_MAX_ROWS_DIFFERENT
                or max(per_row) > BEAM_MAX_ROW_SHARE_DIFFERENT * T):
            raise AssertionError(
                "beam search: far from the CPU's plain beam on the same back guide")
        cpu_back_guide = crf_scan.backward_scores(scores.cpu(), STAY)
        back_guide_err = (back_guide.cpu() - cpu_back_guide).abs().max().item()
        beam_card = beam_runner.decode_scores_beam(scores).cpu().numpy()
        beam_cpu = cpu_runner.decode_scores_beam(scores.cpu()).numpy()
        equal = (beam_card[0] == beam_cpu[0]) & (beam_card[2] == beam_cpu[2])
        same = equal.mean()
        emit_b = beam_card[2].astype(bool)
        qb = beam_card[1][emit_b].astype(np.int32) - 33
        print(f"beam decode: {int(emit_b.sum())} bases; {same:.3%} of positions equal to the "
              f"CPU's plain beam decode with its own back guide (the back guides differ by up to "
              f"{back_guide_err:.3g}); differing steps by row "
              f"{(~equal).sum(axis=1).tolist()} of {T}",
              flush=True)
        if (emit_b.sum() == 0 or qb.min() < 1 or qb.max() > 50
                or same < MIN_BEAM_CPU_POSITIONS_EQUAL):
            raise AssertionError("beam decode: no bases, bad qual chars, or far from the CPU's")
        del back_guide

        # the same on ten other samples (windows of four long reads), each held
        # to the same limit; beside each, the CPU's plain beam on a back guide
        # whose log-sum-exps run in float32 (every step's exp, sum and log
        # rounded in float32: K6's and its plain version's arithmetic before
        # they went to float64) against the same beam on the float64 guide,
        # which shows what one float32 step in the guide does to the beam
        def backward_scores_f32(sc):
            t_len, n, c = sc.shape
            idx, flat = (torch.as_tensor(a) for a in crf_scan._backward_gather(c // 4))
            es = torch.exp(sc.float())
            hist = torch.zeros(t_len + 1, n, c // 4)
            carry = hist[t_len]
            for t in reversed(range(t_len)):
                carry = crf_scan.lse_step(carry, es[t], idx, flat, float(np.exp(STAY)))
                hist[t] = carry
            return hist

        windows = [(lo, off) for lo in (2, 6, 10, 3, 12) for off in (10, 5000)]
        card_cpu, f32_f64 = [], []
        for lo, off in windows:
            sig_k = np.stack([
                pipe.scaler.scale_read(r.signal, read_scale=0.2)[0][off : off + runner.chunk_size]
                for r in reads[lo : lo + 4]
            ]).astype(np.float16)
            sc_k = runner.model(torch.from_numpy(sig_k).to(dev))
            dec_k = beam_runner.decode_scores_beam(sc_k).cpu().numpy()
            dec_c = cpu_runner.decode_scores_beam(sc_k.cpu()).numpy()
            card_cpu.append(float(((dec_k[0] == dec_c[0]) & (dec_k[2] == dec_c[2])).mean()))
            sc_c = sc_k.cpu()
            st64, mv64 = beam.beam_search_plain(
                sc_c, crf_scan.backward_scores(sc_c, STAY), W, BEAM_CUT, STAY)
            st32, mv32 = beam.beam_search_plain(sc_c, backward_scores_f32(sc_c), W, BEAM_CUT, STAY)
            f32_f64.append(float(((st64 == st32) & (mv64 == mv32)).float().mean()))
        print(f"beam decode on ten more samples of four reads: positions equal to the CPU's plain "
              f"beam decode, each side on its own back guide: {[f'{x:.3%}' for x in card_cpu]}; "
              f"the plain beam on a float32-arithmetic back guide against the same beam on the "
              f"float64 one: {[f'{x:.3%}' for x in f32_f64]}", flush=True)
        if min(card_cpu) < MIN_BEAM_CPU_POSITIONS_EQUAL:
            raise AssertionError("beam decode: far from the CPU's on another sample")
        del sc_k, sc_c, dec_k, dec_c, st64, mv64, st32, mv32
        # the two decoders against each other. On a random model's scores
        # they need not agree (the best path is not the best sequence), so
        # that identity is only printed; on scores with a planted path (its
        # steps at +5, stays made the best choice elsewhere, noise around)
        # both must recover that path
        b_scores = bf16_runner.model(on_dev)
        vit = bf16_runner.decode_scores(b_scores.to(torch.bfloat16)).cpu().numpy()
        bm = beam_runner.decode_scores_beam(b_scores).cpu().numpy()
        print("beam vs Viterbi sequences on the bf16 model's scores: identity "
              "%.3f-%.3f over %d chunks" % (*identity(vit, bm), len(sig)), flush=True)
        planted, truth = planted_scores(T, 16)
        vit = runner.decode_scores(planted.to(torch.bfloat16)).cpu().numpy()
        bm = beam_runner.decode_scores_beam(planted).cpu().numpy()
        both = identity(vit, bm)
        print("planted path, %d bases over 16 rows: beam vs Viterbi identity %.3f-%.3f, "
              "Viterbi vs planted %.3f-%.3f, beam vs planted %.3f-%.3f"
              % (int(truth[2].sum()), *both, *identity(vit, truth), *identity(bm, truth)),
              flush=True)
        if both[0] < MIN_BEAM_VITERBI_IDENTITY:
            raise AssertionError("beam and Viterbi sequences disagree on a planted path")
    del bf16_runner, cpu_runner, scores, q_scores, b_scores

    # ---- sup outputs against references on a small input --------------------
    # the other routes and precision on the same weights: "ext" with the fused
    # norms unquantised (K10, K14 at both sites), and int8 encoder matmuls
    ext_runner = TorchBasecallRunner(sup_cfg, sup_model, tx_precision="bf16", tx_attention="ext",
                                     tx_fused_norm=True, **kw)
    int8_runner = TorchBasecallRunner(sup_cfg, sup_model, tx_precision="int8", **kw)
    sup_cpu = TorchBasecallRunner(sup_cfg, sup_model, device="cpu", tx_precision="w8a8", **kw)
    sig = np.stack([
        sup_pipe.scaler.scale_read(r.signal, read_scale=0.2)[0][10 : 10 + sup_runner.chunk_size]
        for r in sup_reads[SUP_SHORT_READS : SUP_SHORT_READS + 2]  # long reads
    ]).astype(np.float16)
    with torch.inference_mode():
        on_dev = torch.from_numpy(sig).to(dev)
        scores = sup_runner.model(on_dev)
        t0 = time.perf_counter()
        ref_scores = sup_cpu.model(torch.from_numpy(sig))
        print(f"sup model on the CPU (float32, W8A8, plain versions of the kernels): 2 chunks in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if (scores.shape != (SUP_T, 2, sup_cfg.outsize) or scores.dtype != torch.float32
                or not bool(torch.isfinite(scores).all())):
            raise AssertionError("sup model scores are not finite or of the wrong shape")
        score_err = (scores.cpu() - ref_scores).abs()
        print(
            f"sup W8A8 model, bf16 on the card vs float32 on the CPU: mean abs "
            f"{score_err.mean():.4f} (max {score_err.max():.4f}) on scores of mean abs "
            f"{ref_scores.abs().mean():.4f}", flush=True)
        if not score_err.mean() <= MAX_SUP_BF16_MEAN_ERR * ref_scores.abs().mean():
            raise AssertionError(f"sup bf16 vs float32: mean abs error {score_err.mean()}")

        # W8A8 against bf16 encoder matmuls, on the card
        sup_bf16 = TorchBasecallRunner(sup_cfg, sup_model, tx_precision="bf16", **kw)
        b_scores = sup_bf16.model(on_dev)
        rel = (torch.linalg.norm(scores - b_scores) / torch.linalg.norm(b_scores)).item()
        agree = (scores.argmax(-1) == b_scores.argmax(-1)).float().mean().item()
        print(f"sup W8A8 vs bf16 encoder matmuls on the card: relative norm error {rel:.4f}, "
              f"argmax agreement {agree:.4f}", flush=True)
        if not (rel < MAX_SUP_W8A8_REL_ERR and agree > MIN_SUP_W8A8_ARGMAX_AGREE):
            raise AssertionError("sup W8A8 scores are too far from the bf16 model's")
        # the same over the first layers only, under K2's limit on the norm
        shallow = {}
        for precision, r in (("w8a8", sup_runner), ("bf16", sup_bf16)):
            layers = r.model.layers
            r.model.layers = layers[:SUP_SHALLOW_DEPTH]
            shallow[precision] = r.model(on_dev)
            r.model.layers = layers
        rel = (torch.linalg.norm(shallow["w8a8"] - shallow["bf16"])
               / torch.linalg.norm(shallow["bf16"])).item()
        agree = (shallow["w8a8"].argmax(-1) == shallow["bf16"].argmax(-1)).float().mean().item()
        print(f"  over the first {SUP_SHALLOW_DEPTH} layers: relative norm error {rel:.4f}, argmax "
              f"agreement {agree:.4f}", flush=True)
        if not (rel < MAX_W8A8_REL_ERR and agree > MIN_SUP_SHALLOW_ARGMAX_AGREE):
            raise AssertionError("sup W8A8 scores over the first layers are too far from bf16's")
        del shallow

        # the routes against the default route on the same weights, a copy of
        # the model whose biases and norm weights are drawn from the seed (the
        # random init leaves them 0 and 1, where a route that dropped or
        # misplaced one would go unseen). The attention routes alone compute
        # its function bit for bit (K10 and K11a round as K9 does; "hp" holds
        # wqkv's rows permuted): all layers, unfused norms, held equal
        drawn = tx_model.with_routes(sup_model)
        draw_biases_and_norms(drawn, SEED)
        d_w8a8 = TorchBasecallRunner(sup_cfg, drawn, **kw).model
        d_bf16 = TorchBasecallRunner(sup_cfg, drawn, tx_precision="bf16", **kw).model
        d_hp = TorchBasecallRunner(sup_cfg, drawn, tx_attention="hp", tx_fused_norm=True,
                                   **kw).model
        d_ext = TorchBasecallRunner(sup_cfg, drawn, tx_precision="bf16", tx_attention="ext",
                                    tx_fused_norm=True, **kw).model
        d_scores, d_b_scores = d_w8a8(on_dev), d_bf16(on_dev)
        for what, model, want in (
                ("hp attention, W8A8", tx_model.with_routes(d_w8a8, "hp"), d_scores),
                ("ext attention, bf16", tx_model.with_routes(d_ext, fused_norm=False),
                 d_b_scores)):
            got = model(on_dev)
            diff = (got - want).abs().max().item() if got.shape == want.shape else float("inf")
            print(f"sup {what} vs the default route on the card, all {len(model.layers)} layers: "
                  f"max abs difference {diff}", flush=True)
            if diff != 0:
                raise AssertionError(f"sup {what}: scores differ from the default route's")
            del model, got
        # the fused norms sum the product in another order, so a sum near a
        # bf16 boundary rounds the other way now and then; over many layers of
        # random weights such steps grow, so they are held over the first
        # layers, and a planted fault must fail the same limit
        def shallow(model):
            layers = model.layers
            model.layers = layers[:SUP_SHALLOW_DEPTH]
            try:
                return model(on_dev)
            finally:
                model.layers = layers

        def faulty(model, fault):
            out = tx_model.with_routes(model)
            with torch.no_grad():
                fault(out)
            return out

        def unpermuted_scales(m):  # "hp" with wqkv's scales left in natural order
            m._frozen_scales[0]["wqkv"] = d_w8a8._frozen_scales[0]["wqkv"].clone()

        base = {"w8a8": shallow(d_w8a8), "bf16": shallow(d_bf16)}
        cases = [
            ("hp attention + fused norms, W8A8", d_hp, "w8a8", True),
            ("ext attention + fused norms, bf16", d_ext, "bf16", True),
            ("planted fault: the first norm1 weights x 1.01 (about 1.0078 in bf16)",
             faulty(d_hp, lambda m: m.layers[0].norm1.mul_(1.01)), "w8a8", False),
            ("planted fault: the first layer's wqkv scales unpermuted",
             faulty(d_hp, unpermuted_scales), "w8a8", False),
        ]
        failed = []
        for what, model, precision, within in cases:
            got, want = shallow(model), base[precision]
            err = (got - want).abs().mean().item() / want.abs().mean().item()
            print(f"sup {what} vs the default route, first {SUP_SHALLOW_DEPTH} layers: mean abs "
                  f"difference {err:.3e} of the mean abs score (limit {MAX_SUP_ROUTE_MEAN_ERR})",
                  flush=True)
            if (got.shape != want.shape or not bool(torch.isfinite(got).all())
                    or (err <= MAX_SUP_ROUTE_MEAN_ERR) != within):
                failed.append(what)
        if failed:
            raise AssertionError(f"sup routes: {failed} on the wrong side of the limit")
        del cases, base, drawn, d_w8a8, d_bf16, d_hp, d_ext, d_scores, d_b_scores
        # int8 encoder matmuls: on the card against float32 on the CPU, and
        # against bf16 matmuls on the card (the limits of the W8A8 checks)
        i_scores = int8_runner.model(on_dev)
        i_cpu = TorchBasecallRunner(sup_cfg, sup_model, device="cpu", tx_precision="int8", **kw)
        i_ref = i_cpu.model(torch.from_numpy(sig))
        i_err = (i_scores.cpu() - i_ref).abs()
        rel = (torch.linalg.norm(i_scores - b_scores) / torch.linalg.norm(b_scores)).item()
        agree = (i_scores.argmax(-1) == b_scores.argmax(-1)).float().mean().item()
        print(f"sup int8 model, bf16 on the card vs float32 on the CPU: mean abs "
              f"{i_err.mean():.4f} (max {i_err.max():.4f}); vs bf16 encoder matmuls on the card: "
              f"relative norm error {rel:.4f}, argmax agreement {agree:.4f}", flush=True)
        if not (bool(torch.isfinite(i_scores).all())
                and i_err.mean() <= MAX_SUP_BF16_MEAN_ERR * i_ref.abs().mean()
                and rel < MAX_SUP_W8A8_REL_ERR and agree > MIN_SUP_W8A8_ARGMAX_AGREE):
            raise AssertionError("sup int8 scores are too far from the references")
        del sup_bf16, b_scores, i_cpu, i_scores, i_ref, i_err

        # the Viterbi decode at 1024 states on the card against the CPU's plain decode
        vit_scores = scores.to(torch.bfloat16)
        on_card = sup_runner.decode_scores(vit_scores).cpu().numpy()
        on_cpu = sup_cpu.decode_scores(vit_scores.float().cpu()).numpy()
        if not (np.array_equal(on_card[0], on_cpu[0]) and np.array_equal(on_card[2], on_cpu[2])):
            raise AssertionError("sup device decode: sequences or moves differ from the CPU decode")
        emit = on_card[2].astype(bool)
        q = on_card[1][emit].astype(np.int32) - 33
        if emit.sum() == 0 or q.min() < 1 or q.max() > 50:
            raise AssertionError("sup device decode: no bases, or qual chars out of [1, 50]")
        # The card keeps the posteriors in bf16 (as the TPU path does), the CPU
        # in float32. A confident call's 1 - p then moves in steps of 2^-8, so
        # above phred 24 the card's chars are sparse and far from the CPU's;
        # under phred 20 the two are one step apart at most
        q_cpu = on_cpu[1][emit].astype(np.int32) - 33
        low = q_cpu < SUP_QUAL_HELD_BELOW
        step = np.abs(q - q_cpu)
        print(
            f"sup Viterbi decode: {int(emit.sum())} bases equal to the CPU decode, qual chars "
            f"differing at {np.mean(step > 0):.3%}; where the CPU's phred is under "
            f"{SUP_QUAL_HELD_BELOW} ({int(low.sum())} bases) at {np.mean(step[low] > 0):.3%}, by "
            f"{int(step[low].max())} at most; above it by {int(step[~low].max())} at most",
            flush=True)
        if low.sum() == 0 or step[low].max() > 1:
            raise AssertionError("sup device decode: low qual chars differ from the CPU decode's")
        # the beam decode at 1024 states on the card against the CPU's plain
        # decode of the same scores: on the card's back guide (K17's limits),
        # then through the runners, each with its own back guide
        back_guide = crf_cuda.backward_scores(scores, STAY)
        st_k, mv_k = beam.beam_search_device(scores, back_guide, W, BEAM_CUT, STAY)
        st_c, mv_c = beam.beam_search_plain(scores.cpu(), back_guide.cpu(), W, BEAM_CUT, STAY)
        per_row = ((st_k.cpu() != st_c) | (mv_k.cpu() != mv_c)).sum(dim=1).tolist()
        print(f"sup beam search on the card vs the CPU's plain beam, the card's back guide on "
              f"both: differing steps by row {per_row} of {SUP_T}", flush=True)
        if (sum(c > 0 for c in per_row) > BEAM_MAX_ROWS_DIFFERENT
                or max(per_row) > BEAM_MAX_ROW_SHARE_DIFFERENT * SUP_T):
            raise AssertionError(
                "sup beam search: far from the CPU's plain beam on the same back guide")
        back_guide_err = (back_guide.cpu() - crf_scan.backward_scores(scores.cpu(), STAY)).abs()
        beam_card = sup_beam_runner.decode_scores_beam(scores).cpu().numpy()
        beam_cpu = sup_cpu.decode_scores_beam(scores.cpu()).numpy()
        equal = (beam_card[0] == beam_cpu[0]) & (beam_card[2] == beam_cpu[2])
        emit_b = beam_card[2].astype(bool)
        qb = beam_card[1][emit_b].astype(np.int32) - 33
        print(f"sup beam decode: {int(emit_b.sum())} bases; {equal.mean():.3%} of positions equal "
              f"to the CPU's plain beam decode with its own back guide (the back guides differ by "
              f"up to {back_guide_err.max().item():.3g}); differing steps by row "
              f"{(~equal).sum(axis=1).tolist()} of {SUP_T}", flush=True)
        if (emit_b.sum() == 0 or qb.min() < 1 or qb.max() > 50
                or equal.mean() < MIN_BEAM_CPU_POSITIONS_EQUAL):
            raise AssertionError("sup beam decode: no bases, bad qual chars, or far from the CPU's")
        del back_guide, back_guide_err

        planted, truth = planted_scores(SUP_T, 16, SUP_S)
        vit = sup_runner.decode_scores(planted.to(torch.bfloat16)).cpu().numpy()
        bm = sup_beam_runner.decode_scores_beam(planted).cpu().numpy()
        found, both = identity(vit, truth), identity(vit, bm)
        print("planted path at 1024 states, %d bases over 16 rows: Viterbi vs planted %.3f-%.3f, "
              "beam vs Viterbi %.3f-%.3f, beam vs planted %.3f-%.3f"
              % (int(truth[2].sum()), *found, *both, *identity(bm, truth)), flush=True)
        if found[0] < MIN_PLANTED_IDENTITY:
            raise AssertionError("sup Viterbi decode does not recover a planted path")
        if both[0] < MIN_SUP_BEAM_VITERBI_IDENTITY:
            raise AssertionError("sup beam and Viterbi sequences disagree on a planted path")
    del sup_cpu, scores, ref_scores, planted

    # ---- where each device step's time goes (one full batch, profiled) ------
    from torch.profiler import ProfilerActivity, profile

    # the ext and int8 steps are their routes' main paths: their launches count
    step_busy = {}
    for decoder, r in (("viterbi", runner), ("beam", beam_runner), ("sup viterbi", sup_runner),
                       ("sup hp fused", hp_pipe.runner), ("sup beam", sup_beam_runner),
                       ("sup ext bf16", ext_runner), ("sup int8", int8_runner)):
        buf = r.make_input_buffer(0)
        buf[:] = rs.randn(*buf.shape)
        r.call_chunks(buf, buf.shape[0])
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r.call_chunks(buf, buf.shape[0])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if decoder not in launches:
            launches[decoder] = {name: w.launches for name, w in wrappers.items()}
            check_launches(decoder, launches[decoder], 1)
        by_kernel = sorted(
            ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
             if e.self_device_time_total > 0),
            key=lambda kv: -kv[1],
        )
        busy_ms = sum(ms for _, ms in by_kernel)
        step_busy[decoder] = (busy_ms, buf.shape[0] * buf.shape[1])
        precision = r.tx_precision or r.lstm_precision
        print(
            f"{decoder} device step (batch {buf.shape[0]}, {precision}): wall {wall_ms:.2f} ms, "
            f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}) [{card}]",
            flush=True,
        )
        for key, ms in by_kernel[:14 if decoder.startswith("sup") else 10]:
            print(f"  {ms:9.3f} ms {ms / busy_ms:6.1%}  {key[:90]}")
        for key, ms in by_kernel:
            if "traceback_kernel" in key:
                print(f"  the traceback in this step: {ms:.4f} ms {ms / busy_ms:6.2%}  {key[:90]}")
        if not decoder.startswith("sup"):
            continue
        # the same step by PyTorch operator and input shapes: which plain
        # passes between the kernels take the rest of the time
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            r.call_chunks(buf, buf.shape[0])
            torch.cuda.synchronize()
        by_op = sorted(
            ((e.key, str(e.input_shapes), e.count, e.self_device_time_total / 1e3)
             for e in prof.key_averages(group_by_input_shape=True)
             if e.self_device_time_total > 0),
            key=lambda row: -row[3],
        )
        print(f"{decoder} device step by PyTorch operator (the hand-written kernels are not "
              f"operators and do not show here):", flush=True)
        for key, shapes, count, ms in by_op[:16 if decoder in ("sup viterbi", "sup beam") else 10]:
            print(f"  {ms:9.3f} ms  x{count:<4d} {key} {shapes[:100]}")

    splitter_phase(cfg.stride, smi, step_busy["viterbi"])

    t0 = time.perf_counter()
    kit.__dict__.update(make_read=make_read, smi=smi, path_kernels=path_kernels,
                        per_batch=per_batch)
    polish_phase(kit)
    variant_phase(kit)
    correct_phase(kit)
    demux_phase(kit, cfg, hac_model)
    rna_cram_phase(kit, cfg, hac_model)
    t0 = time.perf_counter()
    multi_gpu_phase(kit, cfg, hac_model)
    print(f"multi-GPU phase: {time.perf_counter() - t0:.1f} s", flush=True)

    for row in rows:
        by_path = {d: sum(launches[d][n] for n in row["wrappers"]) for d in launches
                   if row["paths"] is None or d in row["paths"]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["launches"] <= 0 and row.get("on_path", True):
            raise AssertionError(f"{row['name']} was not launched by a main path")

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
