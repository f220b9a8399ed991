"""Command line of the port: ``python -m dorado_tpu_torch basecaller``,
``duplex``, ``polish``, ``variant``, ``correct``, ``aligner``, ``summary``,
``demux`` and ``trim``.

Port of the ``basecaller`` subcommand of ``dorado_tpu/cli/main.py`` for what
the port's pipeline does: simplex basecalling of POD5 files with a model
directory, to BAM, SAM or FASTQ, splitting reads unless
``--disable-read-splitting`` is given, with the read filters
``--min-qscore``, ``--read-ids``, ``--max-reads`` and ``--resume-from``,
modified-base calling with model directories (``--modified-bases-models``,
``--modified-bases-threshold``, ``--modified-bases-batchsize``), and the
model's compute type (``--dtype``, passed to the pipeline and to ``-b 0``),
inline alignment (``--reference`` with ``--bed-file``: the finish threads
map each record), ``--emit-summary`` (``sequencing_summary.txt`` beside
the output), barcode classification (``--kit-name`` or a custom
``--barcode-arrangement`` with ``--barcode-sequences``, ``--sample-sheet``,
``--barcode-both-ends``), adapter and primer trimming (``--trim``,
``--primer-sequences``) and poly(A) estimation (``--estimate-poly-a``,
``--poly-a-config``), CRAM output (``--emit-cram`` or a ``.cram`` path,
rANS unless ``--no-cram-rans``) and direct-RNA models (a model directory
whose config says RNA; ``--rna-adapters`` trims the RNA adapter of a DNA
model's reads).
Every other option of the JAX command is left out, so argparse rejects it
(among them ``--modified-bases``, which names models for the downloader),
and two are refused with exit code 1 instead of doing something else than
the JAX command would: ``--decoder beam-host``, and a model name or
``{fast,hac,sup}[@version]``, which needs the model downloader: the model
must be a directory.

``duplex`` is the JAX command's ``duplex`` for what the port's
``DuplexPipeline`` does: stereo duplex calling of POD5 files with a simplex
and a stereo model directory (``--stereo-model``), with duplex modified
bases from model directories, the ``--min-qscore`` and ``--read-ids``
filters and ``--dtype``; or, with ``basespace`` as the model, the
consensus of basecalled pairs (a BAM or SAM and ``--pairs``). Its other JAX
options are left out, ``--modified-bases`` among them, and
``--decoder beam-host`` is refused with exit code 1, as ``basecaller``
refuses it.

``polish`` is the JAX command's ``polish``: a draft FASTA polished with
reads from a BAM or SAM, or from a FASTQ that the port's mapper aligns to
the draft, by a GRUModel (counts features) or a read-level model (a
LatentSpaceLSTM, or a variant model's first haplotype, as in the JAX
package) from a model directory (``-m``, names resolved under
``--models-directory`` only), a config (``--model-config``, random
weights), a ``.tensor`` or TorchScript directory (``--model-params``), or
random GRU weights with a warning. With ``--vcf`` or ``--gvcf`` it hands off
to the variant flow with that command's defaults, as the JAX command does.

``variant`` is the JAX command's ``variant``: a VCF (or gVCF) of a draft
against reads, by the counts GRU or a read-level model
(SlotAttentionConsensus, VariantPerceiver, LatentSpaceLSTM) chosen as
``polish`` chooses them, with haplotags from BAM HP tags (``--hp-tag``),
none (``--unphased``) or local phasing (the default), and ``--candidates``
spans with their bed file (``secondary/variant_calling.py``). The polish
and variant models run on one device: ``-x cuda`` (the default, the first
card), ``cuda:N`` or ``cpu``.

``correct`` is the JAX command's ``correct``: all-vs-all overlaps by the
port's mapper on ``-t`` threads, then the pileup vote or, with ``--nn``, the
HERRO-contract model on one device (``-x``: ``cuda``, the default, ``cuda:N``
or ``cpu``), or a HERRO TorchScript module (``--model-path``) there; with
``--resume-from``, index blocks (``-i``, ``--compute-num-blocks``,
``--run-block-id``), PAF out and in (``--to-paf``, ``-p``) and the overlap
index's options. ``aligner`` maps FASTQ, BAM or SAM reads (or a folder of
them) to a FASTA and writes SAM, an unsorted BAM (``--no-sort``) or a
coordinate-sorted BAM with its ``.bai``; ``summary`` writes the sequencing
summary of a BAM or SAM (or a folder of them). ``demux`` classifies the
reads of a BAM, SAM or FASTQ (or a folder of them) by barcode, or groups
them by their BC tags (``--no-classify``), trims the barcodes unless
``--no-trim`` and writes a BAM a barcode (sorted with its ``.bai`` under
``--sort-bam``) and ``barcoding_summary.txt`` (``--emit-summary``).
``trim`` cuts adapters and primers from the reads of a BAM or SAM into BAM,
SAM or FASTQ (``--rna`` is accepted and, as in the JAX command, changes
nothing). Every command that reads records reads CRAM too; ``aligner -o
x.cram`` writes a reference-based CRAM, which, as in the JAX package, no
command reads back: they pass no reference and exit 1.

``-x`` picks the devices: ``cuda`` or ``auto`` (the default) every visible
card, one model replica on each (the JAX command's ``-x auto``, the
reference's ``-x cuda:all``), ``cuda:N`` that card, ``cpu`` the CPU; without
CUDA the command raises rather than falling back to the CPU. ``basecaller``
takes ``--dump-stats-file`` (and ``--dump-stats-filter``): a CSV of the
pipeline's counters and the first card's memory every 100 ms. An uncaught
exception prints the visible cards' state after its traceback.
"""

from __future__ import annotations

import argparse
import datetime
import os
import re
import shlex
import sys
import time
from pathlib import Path

from dorado_tpu_torch.demux.adapters import ReadTrimmer
from dorado_tpu_torch.demux.barcoder import BarcodeClassifier
from dorado_tpu_torch.demux.custom_kit import parse_custom_arrangement, parse_custom_sequences
from dorado_tpu_torch.polytail import load_poly_tail_configs
from dorado_tpu_torch.utils.sample_sheet import SampleSheet

# a registry model name (dna_r10.4.1_e8.2_400bps_hac@v4.3.0) or the variant
# grammar ({auto,fast,hac,sup}[@version], with modified-base variants after
# a comma), as dorado_tpu/models/registry.py parses them
_MODEL_NAME = re.compile(r"^((dna|rna)[\w.]*@v[\d.]+|(auto|fast|hac|sup)(@[\w.]+)?)(,.*)?$", re.I)
_DEVICE_HELP = ("'cuda' or 'auto' (the default: every visible card, one model replica on "
                "each), 'cuda:N' (that card) or 'cpu'")


def _add_basecaller(sub: argparse._SubParsersAction, allow_abbrev: bool = True) -> None:
    p = sub.add_parser("basecaller", help="Run simplex basecalling", allow_abbrev=allow_abbrev)
    p.add_argument("model", help="Model directory")
    p.add_argument("data", help="POD5 file or directory")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("-o", "--output", default="-",
                   help="Output file, directory (gets calls_<timestamp>.<ext>) or - for stdout")
    p.add_argument("--emit-sam", action="store_true", help="Emit SAM instead of BAM")
    p.add_argument("--emit-fastq", action="store_true")
    p.add_argument("--emit-cram", action="store_true",
                   help="Emit CRAM (non-reference mode; also chosen by a .cram output path)")
    p.add_argument("--cram-rans", action=argparse.BooleanOptionalAction, default=True,
                   help="Compress CRAM data-series blocks with rANS 4x8 (on by default); "
                        "--no-cram-rans falls back to gzip")
    p.add_argument("--emit-moves", action="store_true")
    p.add_argument("-c", "--chunksize", type=int, default=None)
    p.add_argument("-b", "--batchsize", type=int, default=None,
                   help="0 = auto (memory cap + benchmark sweep, cached)")
    p.add_argument("--overlap", type=int, default=None)
    p.add_argument("--decoder", choices=["viterbi", "beam", "beam-host"], default="viterbi",
                   help="viterbi = exact max-scoring path (default); beam = the reference's "
                        "beam search; beam-host is not supported by the port")
    p.add_argument("--trim", choices=["all", "adapters", "primers", "none"], default="none",
                   help="Trim adapters and/or primers from the basecalls (TrimmerNode)")
    p.add_argument("--no-trim", action="store_true", help="Alias for --trim none")
    p.add_argument("--primer-sequences", default=None,
                   help="Custom primer sequences FASTA for trimming")
    p.add_argument("--kit-name", default=None, help="Barcoding kit (e.g. SQK-NBD114-24)")
    p.add_argument("--sample-sheet", default=None,
                   help="MinKNOW sample sheet CSV (barcode aliasing + filtering)")
    p.add_argument("--barcode-both-ends", action="store_true")
    p.add_argument("--barcode-arrangement", default=None,
                   help="Custom barcode arrangement TOML")
    p.add_argument("--barcode-sequences", default=None,
                   help="Custom barcode sequences FASTA")
    p.add_argument("--estimate-poly-a", action="store_true")
    p.add_argument("--poly-a-config", default=None, help="Poly(A) estimation config TOML")
    p.add_argument("--disable-read-splitting", action="store_true")
    p.add_argument("--rna-adapters", action="store_true", help="Force RNA adapter trimming")
    p.add_argument("--modified-bases-models", default=None,
                   help="Comma-separated paths to modified-base model directories")
    p.add_argument("--modified-bases-threshold", type=float, default=0.05)
    p.add_argument("--modified-bases-batchsize", type=int, default=None)
    p.add_argument("--min-qscore", type=float, default=0.0)
    p.add_argument("--resume-from", default=None,
                   help="Resume from a partial BAM, SAM or non-reference CRAM")
    p.add_argument("--read-ids", default=None,
                   help="File with one read id per line; only these are basecalled")
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--run-for", type=int, default=None,
                   help="Stop basecalling after N seconds")
    p.add_argument("--reference", default=None,
                   help="Align basecalls inline against this FASTA (AlignerNode)")
    p.add_argument("--bed-file", default=None,
                   help="BED regions for --reference alignments (bh tags)")
    p.add_argument("--emit-summary", action="store_true",
                   help="Write sequencing_summary.txt beside the output")
    p.add_argument("-x", "--device", default="cuda", help=_DEVICE_HELP)
    p.add_argument("--dump-stats-file", default=None,
                   help="Write the pipeline's and the first card's stats to this CSV file "
                   "every 100 ms")
    p.add_argument("--dump-stats-filter", default="",
                   help="Only the stats whose name holds this text")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="Compute type of the model (default: bfloat16 on the card, float32 "
                   "on the CPU). float32 on the card runs the transformer's attention on "
                   "the pre-rotated route; its 'hp' route (an API option) is refused there")
    p.set_defaults(func=_run_basecaller)


def _resolve_model_dir(arg: str) -> Path | None:
    path = Path(arg)
    if path.is_dir():
        return path
    if os.sep not in arg and _MODEL_NAME.match(arg):
        print(f"> {arg!r} is a model name: the port has no model downloader yet, so pass "
              f"the path of a model directory", file=sys.stderr)
        return None
    print(f"> Model directory not found: {arg}", file=sys.stderr)
    return None


def _print_devices(devices) -> None:
    print(f"> Devices: {len(devices)} ({', '.join(str(d) for d in devices)})", file=sys.stderr)


def _summarise(stats, elapsed_s: float) -> None:
    """The final summary lines of the JAX command (utils/stats.py)."""
    def p(s):
        print(s, file=sys.stderr)

    p(f"> Reads basecalled: {stats.reads_called}")
    if elapsed_s > 0:
        p(f"> Basecalled @ Samples/s: {stats.samples_processed / elapsed_s:.3e}")
        p(f"> Basecalled @ Bases/s: {stats.bases_called / elapsed_s:.3e}")
        if stats.samples_incl_padding:
            p(f"> Basecalled @ Samples/s incl. padding: "
              f"{stats.samples_incl_padding / elapsed_s:.3e}")
    if stats.samples_incl_padding:
        pct = 100.0 * (1.0 - stats.samples_processed / stats.samples_incl_padding)
        p(f"> Padding percentage: {pct:.1f}%")
    if elapsed_s > 0:
        p(f"> Device idle: {100.0 * stats.device_idle_s / elapsed_s:.1f}%")
        p(
            f"> Stage times: dispatch-wait {stats.dispatch_wait_s:.1f}s / device-fetch "
            f"{stats.device_fetch_s:.1f}s / host-decode {stats.host_decode_s:.1f}s / "
            f"host-finish {stats.host_finish_s:.1f} thread-s (wall {elapsed_s:.1f}s)"
        )
    if stats.reads_skipped:
        p(f"> Reads skipped (POD5 decode faults): {stats.reads_skipped}")


def _run_basecaller(args: argparse.Namespace) -> int:
    import torch

    from dorado_tpu_torch.basecall.runner import resolve_devices
    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.io.pod5 import find_pod5_files
    from dorado_tpu_torch.models.load import build_model, load_model
    from dorado_tpu_torch.pipeline import BasecallerPipeline

    if args.decoder == "beam-host":
        print("> --decoder beam-host is not supported by the port: use viterbi or beam",
              file=sys.stderr)
        return 1
    model_dir = _resolve_model_dir(args.model)
    if model_dir is None:
        return 1
    # --resume-from: replay the file's records and skip their reads (the
    # parent's id for a split read), after checking that it was made with
    # this model (resume_loader/ResumeLoader.cpp:16-60)
    skip_read_ids = set()
    resume_records = []
    if args.resume_from:
        try:
            header_text, resume_records = read_records(args.resume_from)
        except ValueError as exc:  # not a BAM, or a reference-based CRAM
            print(f"> {exc}", file=sys.stderr)
            return 1
        err = _validate_resume_cl(header_text, model_dir, args.modified_bases_models)
        if err:
            print(f"> {err}", file=sys.stderr)
            return 1
        for rec in resume_records:
            pid = next((t.value for t in rec.tags if t.tag == "pi"), None)
            skip_read_ids.add(pid if pid else rec.qname)
        print(f"> Resuming: {len(skip_read_ids)} reads already basecalled", file=sys.stderr)
    only_read_ids = _read_ids(args.read_ids)

    # the sample sheet's aliases match each read's run (flow cell, position,
    # experiment): cli_lib/basecaller.cpp:865 reads it with
    # skip_index_matching=false
    sample_sheet = SampleSheet(args.sample_sheet) if args.sample_sheet else None
    barcode_classifier = _barcode_classifier(args, sample_sheet)
    trim = "none" if args.no_trim else args.trim
    trimmer = None
    if trim != "none":
        trimmer = ReadTrimmer(
            adapters=trim in ("all", "adapters"), primers=trim in ("all", "primers"),
            kit_name=args.kit_name,
            custom_primers=(parse_custom_sequences(args.primer_sequences)
                            if args.primer_sequences else None))
    poly_a_config = load_poly_tail_configs(args.poly_a_config) if args.poly_a_config else None

    devices = resolve_devices(args.device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16, None: None}[args.dtype]
    config, params = load_model(model_dir)
    model = build_model(config, params)
    modbase_caller = None
    if args.modified_bases_models:
        from dorado_tpu_torch.modbase.caller import ModBaseCaller
        from dorado_tpu_torch.modbase.config import load_modbase_config

        modbase_caller = ModBaseCaller(
            [load_modbase_config(p) for p in args.modified_bases_models.split(",")],
            canonical_stride=config.stride, is_rna=config.is_rna_model, device=devices[0],
            **({"batch_size": args.modified_bases_batchsize}
               if args.modified_bases_batchsize else {}),
        )

    batchsize = args.batchsize
    if batchsize == 0:
        from dorado_tpu_torch.basecall.batch_size import auto_batch_size

        chunk = args.chunksize or config.basecaller.chunk_size
        # the first card's sweep sizes every replica's batch
        batchsize = auto_batch_size(
            config, model, chunk, device=devices[0], decoder=args.decoder, compute_dtype=dtype
        )
        print(f"> Auto batch size: {batchsize}", file=sys.stderr)

    # inline alignment (AlignerNode, pipeline_creation.cpp): the finish
    # threads map each record against the reference before it is written
    aligner = None
    if args.reference:
        from dorado_tpu_torch.alignment.aligner import RecordAligner
        from dorado_tpu_torch.alignment.bed_file import BedFile
        from dorado_tpu_torch.alignment.index import ReferenceIndex

        print(f"> Indexing {args.reference}", file=sys.stderr)
        aligner = RecordAligner(ReferenceIndex.build(args.reference),
                                bed=BedFile.load(args.bed_file) if args.bed_file else None)
    pipeline = BasecallerPipeline(
        config, model, chunk_size=args.chunksize, batch_size=batchsize, overlap=args.overlap,
        emit_moves=args.emit_moves, device=devices, decoder=args.decoder, compute_dtype=dtype,
        split_reads=not args.disable_read_splitting, min_qscore=args.min_qscore,
        skip_read_ids=skip_read_ids, only_read_ids=only_read_ids, max_reads=args.max_reads,
        modbase_caller=modbase_caller, modbase_threshold=args.modified_bases_threshold,
        barcode_classifier=barcode_classifier, barcode_both_ends=args.barcode_both_ends,
        sample_sheet=sample_sheet, estimate_poly_a=args.estimate_poly_a,
        poly_a_config=poly_a_config, trimmer=trimmer, aligner=aligner,
        force_rna_adapter_trim=args.rna_adapters,
    )
    try:
        files = find_pod5_files(args.data, recursive=args.recursive)
    except RuntimeError as exc:  # FAST5 input
        print(f"> {exc}", file=sys.stderr)
        return 1
    if not files:
        print(f"> No POD5 files found under {args.data}", file=sys.stderr)
        return 1
    header = pipeline.build_header(files, cli_line=args.cli_line)
    if aligner is not None:
        header.references = list(zip(aligner.index.names, aligner.index.lengths))

    output = args.output
    if output != "-" and (Path(output).is_dir() or output.endswith(("/", os.sep))):
        # a directory: calls_<timestamp>.<ext> inside it (hts_writer/Structure.cpp:44-55)
        Path(output).mkdir(parents=True, exist_ok=True)
        ts = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%d_T%H-%M-%S")
        ext = (".fastq" if args.emit_fastq else ".sam" if args.emit_sam
               else ".cram" if args.emit_cram else ".bam")
        output = str(Path(output) / f"calls_{ts}{ext}")
        print(f"> Output: {output}", file=sys.stderr)
    # CRAM with --emit-cram or for a .cram path, as the JAX command chooses it
    emit_cram = args.emit_cram or output.endswith(".cram")
    writer, fh = _open_writer(output, args, header, cram=emit_cram, rans=args.cram_rans)
    sink, summary_fh = writer, None
    if args.emit_summary:
        from dorado_tpu_torch.io.summary import StreamingSummaryWriter, _parse_rg_run_ids

        summary_dir = Path(".") if output == "-" else Path(output).parent
        summary_fh = open(summary_dir / "sequencing_summary.txt", "w")
        sink = _SummaryTee(writer, StreamingSummaryWriter(
            summary_fh, has_barcodes=bool(args.kit_name or args.barcode_arrangement),
            has_alignment=aligner is not None,
            rg_runs=_parse_rg_run_ids(header.to_text()), model_stride=config.stride))
    sampler = stats_fh = None
    if args.dump_stats_file:
        from dorado_tpu_torch.utils.device_monitor import DeviceMonitor
        from dorado_tpu_torch.utils.stats import StatsSampler

        stats_fh = open(args.dump_stats_file, "w")
        sampler = StatsSampler(
            {"basecaller": pipeline.sample_stats,
             "device": DeviceMonitor(devices[0]).sample_stats},
            dump_stream=stats_fh, dump_filter=args.dump_stats_filter,
        )
        sampler.start()
    try:
        t0 = time.perf_counter()
        for rec in resume_records:
            writer.write(rec)
        stats = pipeline.run(args.data, sink, recursive=args.recursive,
                             max_seconds=args.run_for)
        writer.close()
    finally:
        if sampler is not None:
            sampler.stop()
            stats_fh.close()
        if fh is not None:
            fh.close()
        if summary_fh is not None:
            summary_fh.close()
            print(f"> Sequencing summary: {sink.summary.rows} rows", file=sys.stderr)
    _print_devices(devices)
    _summarise(stats, time.perf_counter() - t0)
    return 0


def _read_ids(path: str | None) -> set[str] | None:
    """The read ids of a --read-ids file, one a line; None without one."""
    if path is None:
        return None
    with open(path) as fh:
        return {line.strip() for line in fh if line.strip()}


def _barcode_classifier(args: argparse.Namespace, sample_sheet: SampleSheet | None):
    """The classifier of ``--kit-name``, or of ``--barcode-arrangement`` with
    its ``--barcode-sequences``, limited to the sample sheet's barcodes;
    None without either."""
    kit_name, kit_info, custom = args.kit_name, None, None
    if args.barcode_arrangement:
        kit_name, kit_info = parse_custom_arrangement(args.barcode_arrangement)
        if args.barcode_sequences:
            custom = parse_custom_sequences(args.barcode_sequences)
    if not kit_name:
        return None
    return BarcodeClassifier(
        kit_name, allowed_barcodes=sample_sheet.get_barcode_values() if sample_sheet else None,
        kit_info=kit_info, custom_barcodes=custom)


class _SummaryTee:
    """A writer that also hands each record to a summary writer (the
    basecaller's ``--emit-summary``; resumed records are not summarised)."""

    def __init__(self, inner, summary):
        self.inner = inner
        self.summary = summary

    def write(self, rec) -> None:
        self.inner.write(rec)
        self.summary.write(rec)


def _validate_resume_cl(
    header_text: str, model_dir: Path, modified_bases_models: str | None
) -> str | None:
    """Refuse to resume from a file made with other models: the file's
    ``@PG ID:basecaller CL:`` line, re-parsed with this command's parser,
    must name a model directory of the same name and modified-base models
    of the same names, as the JAX command's check compares them
    (cli/cli_lib/basecaller.cpp:636-693): the directory names of
    ``--modified-bases-models``, or else the variants of ``--modified-bases``
    (which this command does not take, so a file made with them never
    matches). An error message, or None when they agree."""
    cl = None
    for line in header_text.splitlines():
        fields = line.split("\t")
        if line.startswith("@PG") and "ID:basecaller" in fields:
            for f in fields:
                if f.startswith("CL:"):
                    cl = f[3:]
    if cl is None:
        return ("Failed to parse resume parameters: the --resume-from file has no basecaller "
                "@PG 'CL' (Command Line) header. This can happen if the HTS file headers "
                "were dropped.")
    tokens = shlex.split(cl)
    if "basecaller" not in tokens:
        return "Failed to parse resume parameters from the @PG CL header."
    parser = argparse.ArgumentParser(prog="dorado_tpu_torch", exit_on_error=False)
    # no abbreviations: --modified-bases stays an unknown option, not an
    # ambiguous prefix of --modified-bases-models and the like
    _add_basecaller(parser.add_subparsers(dest="command"), allow_abbrev=False)
    try:
        resumed, unknown = parser.parse_known_args(
            ["basecaller", *tokens[tokens.index("basecaller") + 1 :]])
    except (argparse.ArgumentError, SystemExit):
        return "Failed to parse resume parameters from the @PG CL header."

    def mods_of(models, variants=()):
        if models:
            return tuple(sorted(Path(m).name for m in models.split(",")))
        return tuple(sorted(variants))

    variants = []
    for i, t in enumerate(unknown):
        if t.startswith("--modified-bases="):
            variants.append(t.split("=", 1)[1])
        elif t == "--modified-bases":
            for v in unknown[i + 1 :]:
                if v.startswith("-"):
                    break
                variants.append(v)
    current = (model_dir.name, mods_of(modified_bases_models))
    recorded = (Path(resumed.model).name, mods_of(resumed.modified_bases_models, variants))
    if current != recorded:
        return ("Inconsistent models used in this pipeline and those used in the "
                f"--resume-from file. Current: {current}; Resumed: {recorded}.")
    return None


def _add_duplex(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("duplex", help="Run duplex basecalling")
    p.add_argument("model", help="Simplex model directory, or 'basespace'")
    p.add_argument("data", help="POD5 file or directory (basespace: a BAM or SAM)")
    p.add_argument("--stereo-model", default=None,
                   help="Stereo model directory (required unless the model is 'basespace')")
    p.add_argument("--pairs", default=None,
                   help="File of 'template complement' read-id pairs (basespace mode)")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("-o", "--output", default="-", help="Output file or - for stdout")
    p.add_argument("--emit-sam", action="store_true", help="Emit SAM instead of BAM")
    p.add_argument("--emit-fastq", action="store_true")
    p.add_argument("--modified-bases-models", default=None,
                   help="Comma-separated paths to modified-base model directories")
    p.add_argument("--modified-bases-threshold", type=float, default=0.05)
    p.add_argument("-c", "--chunksize", type=int, default=None)
    p.add_argument("-b", "--batchsize", type=int, default=None)
    p.add_argument("--decoder", choices=["viterbi", "beam", "beam-host"], default="viterbi",
                   help="as basecaller's --decoder (beam-host is not supported by the port)")
    p.add_argument("--overlap", type=int, default=None)
    p.add_argument("--min-qscore", type=float, default=0.0)
    p.add_argument("--read-ids", default=None,
                   help="File with one read id per line; only these are basecalled")
    p.add_argument("-x", "--device", default="cuda", help=_DEVICE_HELP)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="Compute type of both models (default: bfloat16 on the card, "
                   "float32 on the CPU)")
    p.set_defaults(func=_run_duplex)


def _open_writer(output: str, args: argparse.Namespace, header, cram: bool = False,
                 rans: bool = True):
    """(writer, the file it writes or None for stdout) for ``output`` (a
    path, or - for stdout) and --emit-sam / --emit-fastq; else CRAM (rANS
    blocks, or gzip with ``rans=False``) when ``cram`` is set, else BAM."""
    from dorado_tpu_torch.io.cram import CramWriter
    from dorado_tpu_torch.io.sam import BamWriter, FastqWriter, SamWriter

    text = args.emit_fastq or args.emit_sam
    if output == "-":
        fh = None
        stream = sys.stdout if text else sys.stdout.buffer
    else:
        fh = stream = open(output, "w" if text else "wb")
    if args.emit_fastq:
        return FastqWriter(stream, header), fh
    if args.emit_sam:
        return SamWriter(stream, header), fh
    if cram:
        return CramWriter(stream, header, rans=rans), fh
    return BamWriter(stream, header), fh


def _run_duplex(args: argparse.Namespace) -> int:
    if args.model == "basespace":
        return _run_basespace_duplex(args)
    import torch

    from dorado_tpu_torch.basecall.runner import resolve_devices
    from dorado_tpu_torch.duplex.pipeline import DuplexPipeline
    from dorado_tpu_torch.io.pod5 import find_pod5_files
    from dorado_tpu_torch.models.load import build_model, load_model

    if args.decoder == "beam-host":
        print("> --decoder beam-host is not supported by the port: use viterbi or beam",
              file=sys.stderr)
        return 1
    if not args.stereo_model:
        print("> stereo duplex requires --stereo-model", file=sys.stderr)
        return 1
    model_dir = _resolve_model_dir(args.model)
    stereo_dir = _resolve_model_dir(args.stereo_model)
    if model_dir is None or stereo_dir is None:
        return 1
    devices = resolve_devices(args.device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16, None: None}[args.dtype]
    only_read_ids = _read_ids(args.read_ids)
    try:
        files = find_pod5_files(args.data, recursive=args.recursive)
    except RuntimeError as exc:  # FAST5 input
        print(f"> {exc}", file=sys.stderr)
        return 1
    if not files:
        print(f"> No POD5 files found under {args.data}", file=sys.stderr)
        return 1
    config, params = load_model(model_dir)
    stereo_config, stereo_params = load_model(stereo_dir)
    modbase_caller = None
    if args.modified_bases_models:
        from dorado_tpu_torch.modbase.caller import ModBaseCaller
        from dorado_tpu_torch.modbase.config import load_modbase_config

        modbase_caller = ModBaseCaller(
            [load_modbase_config(p) for p in args.modified_bases_models.split(",")],
            canonical_stride=config.stride, is_rna=config.is_rna_model, device=devices[0],
        )
    pipeline = DuplexPipeline(
        config, build_model(config, params), stereo_config,
        build_model(stereo_config, stereo_params), chunk_size=args.chunksize,
        batch_size=args.batchsize, overlap=args.overlap, device=devices, decoder=args.decoder,
        compute_dtype=dtype, min_qscore=args.min_qscore, only_read_ids=only_read_ids,
        modbase_caller=modbase_caller, modbase_threshold=args.modified_bases_threshold,
    )
    header = pipeline.simplex.build_header(files, cli_line=args.cli_line)
    writer, fh = _open_writer(args.output, args, header)
    try:
        stats = pipeline.run(args.data, writer, recursive=args.recursive)
        writer.close()
    finally:
        if fh is not None:
            fh.close()
    _print_devices(devices)
    print(f"> Simplex reads basecalled: {stats.simplex_reads}", file=sys.stderr)
    print(f"> Duplex reads basecalled: {stats.duplex_reads}", file=sys.stderr)
    if stats.simplex_reads:
        rate = 200.0 * stats.duplex_reads / stats.simplex_reads
        print(f"> Duplex rate: {rate:.2f}%", file=sys.stderr)
    return 0


def _run_basespace_duplex(args: argparse.Namespace) -> int:
    """The consensus of basecalled pairs: the records of a BAM or SAM and a
    pairs file (cli_lib/duplex.cpp:431-456, basespace mode)."""
    from dorado_tpu_torch.duplex.basespace import basespace_duplex_call
    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.io.sam import SamHeader, SamRecord, SamTag
    from dorado_tpu_torch.utils.sequence import mean_qscore_from_qstring

    if not args.pairs:
        print("> basespace mode requires --pairs", file=sys.stderr)
        return 1
    _, records = read_records(args.data)
    by_id = {r.qname: r for r in records}
    with open(args.pairs) as fh:
        pairs = [parts[:2] for parts in (line.split() for line in fh) if len(parts) >= 2]
    writer, fh = _open_writer(args.output, args, SamHeader())
    n = 0
    try:
        for t_id, c_id in pairs:
            t, c = by_id.get(t_id), by_id.get(c_id)
            if t is None or c is None:
                continue
            result = basespace_duplex_call(t.seq, t.qual, c.seq, c.qual)
            if result is None:
                continue
            seq, qstring = result
            writer.write(SamRecord(qname=f"{t_id};{c_id}", seq=seq, qual=qstring, tags=[
                SamTag("qs", "f", mean_qscore_from_qstring(qstring)), SamTag("dx", "i", 1),
            ]))
            n += 1
        writer.close()
    finally:
        if fh is not None:
            fh.close()
    print(f"> Duplex reads basecalled: {n}", file=sys.stderr)
    return 0


def _add_polish(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("polish", help="Polish a draft assembly with aligned reads")
    p.add_argument("reads", help="Aligned BAM/SAM (or FASTQ to self-align)")
    p.add_argument("draft", help="Draft assembly FASTA")
    p.add_argument("--model-params", default=None,
                   help="GRU model params dir (.tensor files) or a TorchScript model.pt (or "
                   "its directory); random weights if no model is given (testing only)")
    p.add_argument("--model-config", default=None,
                   help="Model config TOML selecting the architecture (GRUModel, "
                   "LatentSpaceLSTM, SlotAttentionConsensus or VariantPerceiver) and its "
                   "kwargs; random weights")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--window-len", type=int, default=10000)
    p.add_argument("--regions", default=None,
                   help="Comma-separated contig[:start-end] regions to polish (1-based, "
                   "inclusive)")
    p.add_argument("--min-mapq", type=int, default=0)
    p.add_argument("--min-depth", type=int, default=0,
                   help="Below this coverage the draft base is kept")
    p.add_argument("--qualities", action="store_true",
                   help="Emit FASTQ with per-base consensus qualities")
    p.add_argument("--hp-tag", action="store_true",
                   help="Source the haplotag feature column from BAM HP tags (default: "
                   "unphased, matching the reference polish)")
    p.add_argument("--no-fill-gaps", action="store_true",
                   help="Do not fill uncovered spans from the draft; emit one record per "
                   "covered run (polish.cpp:213)")
    p.add_argument("--vcf", action="store_true",
                   help="Emit variants as VCF instead of polished FASTA: the variant command's "
                   "flow with its defaults (polish.cpp:173)")
    p.add_argument("--gvcf", action="store_true",
                   help="Emit gVCF instead of polished FASTA (polish.cpp:177)")
    p.add_argument("--RG", dest="rg", default="", help="Read group to select (polish.cpp:222)")
    p.add_argument("--ignore-read-groups", action="store_true",
                   help="Process all read groups (polish.cpp:223)")
    p.add_argument("--window-overlap", type=int, default=None,
                   help="Overlap between consensus windows (default 1000)")
    p.add_argument("--ambig-ref", dest="ambig_ref", action="store_true",
                   help="Call over ambiguous reference bases (--vcf/--gvcf)")
    p.add_argument("--fill-char", default=None,
                   help="Fill uncovered spans with this character instead of the draft bases")
    # the reference's device-batching options: accepted and not used, as the
    # JAX command does (one window a forward)
    p.add_argument("-b", "--batchsize", type=int, default=None)
    p.add_argument("--draft-batchsize", default=None)
    p.add_argument("--encoding-batchsize", type=int, default=None)
    p.add_argument("--bam-chunk", type=int, default=None)
    p.add_argument("--bam-subchunk", type=int, default=None)
    p.add_argument("--bacteria", action="store_true", help="Resolve a bacterial polishing model")
    p.add_argument("-m", "--model", default=None,
                   help="Polish model: 'auto' (resolved from the BAM's basecall_model "
                   "header), a model name (a directory under --models-directory) or a "
                   "directory (polish.cpp:515-640)")
    p.add_argument("--models-directory", default=".", help="Where model names are found")
    p.add_argument("-x", "--device", default="cuda",
                   help="'cuda' (the default: the first card), 'cuda:N' or 'cpu'")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="Threads that map FASTQ reads to the draft (0 = one a CPU core)")
    p.set_defaults(func=_run_polish)


def _read_fastq(path: str) -> list[tuple[str, str, str]]:
    """(name, sequence, quality string) of each record of a FASTQ file."""
    records = []
    with open(path) as fh:
        while True:
            h = fh.readline().strip()
            if not h:
                break
            seq = fh.readline().strip()
            fh.readline()
            qual = fh.readline().strip()
            records.append((h[1:].split()[0], seq, qual))
    return records


def _phred(qual: str):
    import numpy as np

    if not qual or qual == "*":
        return None
    return np.frombuffer(qual.encode(), dtype=np.uint8).astype(np.int16) - 33


def _collect_alignments(args: argparse.Namespace):
    """reads (FASTQ self-aligned by the port's mapper, or a BAM/SAM) ->
    {contig: [AlignedRead]} with the read-level feature inputs (qual, mapq,
    qname, mv/HP/NM tags) the encoders read (encoder_read_alignment.cpp:
    449-520); None (with a message) when the read groups are ambiguous."""
    import numpy as np

    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.secondary.pileup import AlignedRead

    min_mapq = args.min_mapq or 0
    if args.reads.endswith((".fastq", ".fq")):
        from concurrent.futures import ThreadPoolExecutor

        from dorado_tpu_torch.alignment import Mapper, ReferenceIndex
        from dorado_tpu_torch.utils.sequence import reverse_complement

        mapper = Mapper(ReferenceIndex.build(args.draft))
        records = _read_fastq(args.reads)
        # the banded alignments run in C++ without the interpreter lock: map
        # on threads, in the file's order
        with ThreadPoolExecutor(args.threads or os.cpu_count() or 1) as pool:
            mapped = list(pool.map(lambda rec: mapper.map(rec[1]), records))
        by_contig: dict[str, list] = {}
        for (qname, seq, qstring), alignments in zip(records, mapped):
            qual = _phred(qstring)
            for a in alignments:
                if a.mapq < min_mapq:
                    continue
                s = reverse_complement(seq) if a.is_reverse else seq
                q = qual[::-1].copy() if (a.is_reverse and qual is not None) else qual
                by_contig.setdefault(a.ref_name, []).append(AlignedRead(
                    a.ref_start, a.cigar, s, a.is_reverse, qual=q, mapq=a.mapq, qname=qname))
        return by_contig
    header_text, records = read_records(args.reads)
    # read-group selection (secondary/common/bam_info.cpp:103-118): several
    # RGs need --RG or --ignore-read-groups; --RG must name an existing one
    rg_ids = [
        f.split(":", 1)[1]
        for line in header_text.splitlines() if line.startswith("@RG")
        for f in line.split("\t")[1:] if f.startswith("ID:")
    ]
    if args.rg and rg_ids and args.rg not in rg_ids:
        print(f"> Read group '{args.rg}' not found in the input BAM.", file=sys.stderr)
        return None
    if not args.rg and len(rg_ids) > 1 and not args.ignore_read_groups:
        print("> The input BAM contains more than one read group. Specify --RG to select "
              "one, or --ignore-read-groups to process all.", file=sys.stderr)
        return None
    by_contig = {}
    for rec in records:
        # unmapped, secondary and supplementary records (0x904) carry no
        # alignment the pileup can use (medaka_bamiter.cpp)
        if rec.flag & (4 | 0x900) or rec.rname == "*" or rec.cigar == "*":
            continue
        if args.rg and next((t.value for t in rec.tags if t.tag == "RG"), None) != args.rg:
            continue
        if rec.mapq < min_mapq:
            continue
        tags = {t.tag: t for t in rec.tags}
        mv, hp, nm = tags.get("mv"), tags.get("HP"), tags.get("NM")
        by_contig.setdefault(rec.rname, []).append(AlignedRead(
            rec.pos - 1, rec.cigar, rec.seq, bool(rec.flag & 16),
            qual=_phred(rec.qual), mapq=rec.mapq, qname=rec.qname,
            moves=np.asarray(mv.value, dtype=np.int64) if mv is not None else None,
            haplotag=int(hp.value) if hp is not None else 0,
            nm=int(nm.value) if nm is not None else None,
        ))
    return by_contig


def _feature_opts(mc, hap_source: str = "unphased") -> dict:
    """Read-level encoder options from a parsed model config's
    [feature_encoder] kwargs (encoder_factory.cpp:96-118)."""
    kw = mc.get("feature_encoder_kwargs", {}) if mc else {}

    def b(name, default=False):
        v = kw.get(name, default)
        return v == "true" if isinstance(v, str) else bool(v)

    return {
        "include_dwells": b("include_dwells"),
        "include_haplotags": b("include_haplotype"),
        "include_snp_qv": b("include_snp_qv"),
        "hap_source": hap_source,
        "max_reads": int(kw.get("max_reads", 100)),
    }


def _parse_regions(spec: str | None):
    """"ctg" or "ctg:start-end" (1-based inclusive, the htslib convention)
    -> {ctg: (start0, end) or None}."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if ":" in part:
            name, rng = part.split(":", 1)
            lo, _, hi = rng.partition("-")
            out[name] = (int(lo) - 1, int(hi) if hi else None)
        else:
            out[part] = None
    return out


def _run_polish(args: argparse.Namespace) -> int:
    import torch

    from dorado_tpu_torch.basecall.runner import resolve_device
    from dorado_tpu_torch.secondary.polish import PolishPipeline

    if args.vcf or args.gvcf:
        # polish --vcf/--gvcf is the variant-calling flow with the polish
        # model (cram-polish-17-vcf.t), with the variant command's defaults;
        # its haplotags are computed unless --hp-tag
        for name, default in (("unphased", False), ("pass_qual_filter", 3.0),
                              ("candidates", None), ("variant_flanking_bases", 100)):
            if not hasattr(args, name):
                setattr(args, name, default)
        return _run_variant(args)
    device = resolve_device(args.device)
    mc = None
    feature_kind = "counts"
    if args.model:
        from dorado_tpu_torch.io.bam_reader import read_records
        from dorado_tpu_torch.secondary.model_resolver import (
            load_resolved_model, resolve_model_dir,
        )

        header_text = ""
        if args.model == "auto" and not args.reads.endswith((".fastq", ".fq")):
            header_text = read_records(args.reads)[0]
        try:
            mdir = resolve_model_dir(args.model, header_text, bacteria=args.bacteria,
                                     models_directory=args.models_directory)
            model, mc, feature_kind = load_resolved_model(mdir, device)
        except (ValueError, RuntimeError) as exc:
            print(f"> {exc}", file=sys.stderr)
            return 1
        print(f"> Model: {mdir.name} ({feature_kind})", file=sys.stderr)
    elif args.model_config:
        from dorado_tpu_torch.secondary.architectures import model_factory, parse_model_config

        mc = parse_model_config(args.model_config)
        # an unknown type raises ValueError and a config without its model's
        # kwargs KeyError, as the JAX command's factory does
        model = model_factory(mc["model_type"], mc["model_kwargs"])
        if mc["model_type"] != "GRUModel":
            feature_kind = "read_level"
        print(f"> Model: {mc['model_type']}", file=sys.stderr)
    elif args.model_params and (args.model_params.endswith(".pt")
                                or (Path(args.model_params) / "model.pt").exists()):
        # an opaque TorchScript blob (model_factory.cpp:186-201)
        from dorado_tpu_torch.secondary.model import TorchScriptConsensusModel

        ts_path = Path(args.model_params)
        if ts_path.is_dir():
            ts_path = ts_path / "model.pt"
        model = TorchScriptConsensusModel(ts_path, device)
        print(f"> Model: TorchScript ({ts_path})", file=sys.stderr)
    elif args.model_params:
        from dorado_tpu_torch.secondary.model import load_gru_tensor_dir

        model = load_gru_tensor_dir(args.model_params)
    else:
        from dorado_tpu_torch.secondary.model import init_gru_model

        print("> WARNING: no --model-params given; using random weights (structural test "
              "mode only)", file=sys.stderr)
        model = init_gru_model(torch.Generator().manual_seed(0))

    by_contig = _collect_alignments(args)
    if by_contig is None:
        return 1
    kwargs = {}
    if args.window_overlap is not None:
        kwargs["window_overlap"] = args.window_overlap
    if args.fill_char:
        kwargs["fill_char"] = args.fill_char[0]
    pipeline = PolishPipeline(
        model, window_len=args.window_len, feature_kind=feature_kind,
        min_depth=args.min_depth, device=device,
        feature_opts=_feature_opts(mc if (args.model_config or args.model) else None,
                                   hap_source="bam" if args.hp_tag else "unphased"),
        **kwargs,
    )
    results = pipeline.run(args.draft, by_contig, regions=_parse_regions(args.regions),
                           with_quals=args.qualities, fill_gaps=not args.no_fill_gaps)
    fh = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for name, result in results:
            if args.qualities:
                seq, qual = result
                fh.write(f"@{name}\n{seq}\n+\n{qual}\n")
                continue
            fh.write(f">{name}\n")
            for i in range(0, len(result), 80):
                fh.write(result[i:i + 80] + "\n")
    finally:
        if fh is not sys.stdout:
            fh.close()
    stats = pipeline.stats
    print(f"> Polished {stats.contigs} contig(s), {stats.windows} window(s) on {device}: host "
          f"features {stats.features_s:.1f} s, model forwards {stats.forward_s:.1f} s",
          file=sys.stderr)
    return 0


def _add_variant(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("variant", help="Call variants against a draft reference")
    p.add_argument("reads", help="Aligned BAM/SAM (or FASTQ to self-align)")
    p.add_argument("draft", help="Reference FASTA")
    p.add_argument("--model-params", default=None,
                   help="A TorchScript model.pt (or its directory); a directory of .tensor "
                   "files is not read (the random counts GRU runs), as in the JAX command")
    p.add_argument("--model-config", default=None,
                   help="Model config TOML (GRUModel, LatentSpaceLSTM, SlotAttentionConsensus "
                   "or VariantPerceiver) and its kwargs; random weights")
    p.add_argument("-o", "--output", default="-",
                   help="The VCF file, or a directory to write variants.vcf into")
    p.add_argument("--window-len", type=int, default=10000)
    p.add_argument("--regions", default=None,
                   help="Comma-separated contig[:start-end] regions to call (1-based, inclusive)")
    p.add_argument("--min-mapq", type=int, default=0)
    p.add_argument("--gvcf", action="store_true",
                   help="Emit a reference record for every covered position")
    p.add_argument("--ambig-ref", action="store_true",
                   help="Call variants over ambiguous reference bases")
    p.add_argument("--pass-qual-filter", type=float, default=3.0,
                   help="QUAL below this is marked LowQual (variant.cpp:105)")
    p.add_argument("--hp-tag", action="store_true",
                   help="Take haplotags from BAM HP tags instead of computing local phasing "
                   "(variant.cpp:492-495 BAM_HAP_TAG)")
    p.add_argument("--unphased", action="store_true",
                   help="Leave the haplotag column empty (variant.cpp:492-495 UNPHASED)")
    p.add_argument("--RG", dest="rg", default="",
                   help="Read group to select (bam_info.cpp:115 semantics)")
    p.add_argument("--ignore-read-groups", action="store_true", help="Process all read groups")
    p.add_argument("--candidates", default=None,
                   help="Candidate variant sites (contig and 0-based position a line) whose "
                   "flanked spans replace the whole contigs (variant.cpp:300); their spans go "
                   "to <output>.processed_regions.bed")
    p.add_argument("--variant-flanking-bases", type=int, default=100,
                   help="Span on each side of a candidate site")
    p.add_argument("--window-overlap", type=int, default=None,
                   help="Margin on each side of a calling window (default min(1000, "
                   "window-len / 2))")
    p.add_argument("-m", "--model", default=None,
                   help="Variant model: 'auto', a model name (a directory under "
                   "--models-directory) or a directory")
    p.add_argument("--models-directory", default=".", help="Where model names are found")
    # the reference's candidate filter and device-batching options: accepted
    # and not used, as the JAX command does (the candidate spans already
    # restrict inference; one window a forward)
    p.add_argument("--candidate-filtering", action="store_true")
    p.add_argument("-b", "--batchsize", type=int, default=None)
    p.add_argument("--ref-batchsize", default=None)
    p.add_argument("--encoding-batchsize", type=int, default=None)
    p.add_argument("--bam-chunk", type=int, default=None)
    p.add_argument("--bam-subchunk", type=int, default=None)
    p.add_argument("-x", "--device", default="cuda",
                   help="'cuda' (the default: the first card), 'cuda:N' or 'cpu'")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="Threads that map FASTQ reads to the draft (0 = one a CPU core)")
    p.set_defaults(func=_run_variant)


def _run_variant(args: argparse.Namespace) -> int:
    """The variant command (and ``polish --vcf/--gvcf``): the JAX command's
    model selection and haplotag sources, then ``VariantCaller.run``."""
    import torch

    from dorado_tpu_torch.alignment.index import read_fasta
    from dorado_tpu_torch.basecall.runner import resolve_device
    from dorado_tpu_torch.secondary.variant import VcfWriter
    from dorado_tpu_torch.secondary.variant_calling import VariantCaller, read_candidates

    device = resolve_device(args.device)
    by_contig = _collect_alignments(args)
    if by_contig is None:
        return 1
    feature_kind = "counts"
    mc = None
    if args.model:
        from dorado_tpu_torch.io.bam_reader import read_records
        from dorado_tpu_torch.secondary.model_resolver import (
            load_resolved_model, resolve_model_dir,
        )

        header_text = ""
        if args.model == "auto" and not args.reads.endswith((".fastq", ".fq")):
            header_text = read_records(args.reads)[0]
        try:
            mdir = resolve_model_dir(args.model, header_text,
                                     models_directory=args.models_directory)
            model, mc, feature_kind = load_resolved_model(mdir, device)
        except (ValueError, RuntimeError) as exc:
            print(f"> {exc}", file=sys.stderr)
            return 1
        print(f"> Model: {mdir.name} ({feature_kind})", file=sys.stderr)
    elif args.model_config:
        from dorado_tpu_torch.secondary.architectures import model_factory, parse_model_config

        mc = parse_model_config(args.model_config)
        model = model_factory(mc["model_type"], mc["model_kwargs"])  # raises as in _run_polish
        if mc["model_type"] != "GRUModel":
            feature_kind = "read_level"
        print(f"> Model: {mc['model_type']}", file=sys.stderr)
    elif args.model_params and (args.model_params.endswith(".pt")
                                or (Path(args.model_params) / "model.pt").exists()):
        from dorado_tpu_torch.secondary.model import TorchScriptConsensusModel

        ts_path = Path(args.model_params)
        if ts_path.is_dir():
            ts_path = ts_path / "model.pt"
        model = TorchScriptConsensusModel(ts_path, device)
        print(f"> Model: TorchScript ({ts_path})", file=sys.stderr)
    else:
        from dorado_tpu_torch.secondary.model import init_gru_model

        # as the JAX command: a .tensor --model-params directory is not
        # read here, and the random counts GRU runs
        if args.model_params:
            print("> Custom model params loading shares the polish path", file=sys.stderr)
        model = init_gru_model(torch.Generator().manual_seed(0))

    # the haplotag source (variant.cpp:492-495, no bin-file input): --hp-tag
    # BAM HP tags, --unphased none, else local phasing computed a window
    hap_source = "bam" if args.hp_tag else "unphased" if args.unphased else "compute"
    caller = VariantCaller(
        model, feature_kind=feature_kind, feature_opts=_feature_opts(mc, hap_source=hap_source),
        device=device, window_len=args.window_len, window_overlap=args.window_overlap,
        min_qual=args.pass_qual_filter, ambig_ref=args.ambig_ref, gvcf=args.gvcf)

    contigs = read_fasta(args.draft)
    candidates = None
    if args.candidates:
        candidates = read_candidates(args.candidates, args.variant_flanking_bases)
        print(f"> Candidate windows: {sum(len(s) for s in candidates.values())} spans over "
              f"{len(candidates)} contig(s)", file=sys.stderr)
    if args.output != "-" and Path(args.output).is_dir():
        # the reference's -o is a directory holding variants.vcf (and the bed)
        args.output = str(Path(args.output) / "variants.vcf")
    fh = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        writer = VcfWriter(fh, [(n, len(s)) for n, s in contigs], gvcf=args.gvcf)
        processed = caller.run(contigs, by_contig, writer, regions=_parse_regions(args.regions),
                               candidates=candidates)
    finally:
        if fh is not sys.stdout:
            fh.close()
    if candidates is not None and args.output != "-":
        bed_path = Path(args.output).with_suffix(".processed_regions.bed")
        with open(bed_path, "w") as bf:
            for ctg, lo, hi in processed:
                bf.write(f"{ctg}\t{lo}\t{hi}\n")
        print(f"> Processed regions -> {bed_path}", file=sys.stderr)
    stats = caller.stats
    print(f"> Called {stats.records} variant(s) over {stats.windows} window(s) on {device}: "
          f"host features {stats.features_s:.1f} s, model forwards {stats.forward_s:.1f} s, "
          f"decode {stats.decode_s:.1f} s", file=sys.stderr)
    return 0


def _add_correct(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("correct", help="Error-correct reads via all-vs-all consensus")
    p.add_argument("reads", help="FASTQ of reads")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--min-depth", type=int, default=2)
    p.add_argument("--nn", action="store_true",
                   help="HERRO-style NN scorer at supported positions (seeded random weights "
                        "unless --model-path)")
    p.add_argument("--model-path", default=None,
                   help="HERRO TorchScript model (e.g. herro-v1), run on -x's device")
    p.add_argument("--resume-from", default=None,
                   help="Skip-set file of already-corrected read names; resumes after the "
                        "furthest skipped read in input order")
    p.add_argument("-i", "--index-size", default="8G",
                   help="Bases per index block; decrease to shard runs")
    p.add_argument("--compute-num-blocks", action="store_true",
                   help="Print the number of index blocks and exit")
    p.add_argument("--run-block-id", type=int, default=None,
                   help="Correct only the targets of this index block")
    p.add_argument("--to-paf", action="store_true",
                   help="Write all-vs-all overlaps as PAF and skip consensus")
    p.add_argument("-p", "--from-paf", default=None,
                   help="Consume overlaps from a PAF (from --to-paf) instead of computing them")
    p.add_argument("--kmer-size", type=int, default=15, help="Overlap-index k-mer size")
    p.add_argument("--ovl-window-size", type=int, default=10,
                   help="Overlap-index minimizer window")
    p.add_argument("--min-chain-score", type=int, default=None,
                   help="Minimum overlap chain score")
    p.add_argument("-x", "--device", default="cuda",
                   help="The NN's device: 'cuda' (the default: the first card), 'cuda:N' or "
                        "'cpu'")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="Host threads that map the overlaps (0 = every core)")
    p.set_defaults(func=_run_correct)


def _load_skip_set(path: str) -> set[str]:
    """First whitespace/':'-delimited token per non-blank line — ':' because
    correct can emit multiple outputs per input with a ':<num>' suffix
    (cli_lib/correct.cpp:253-277)."""
    out = set()
    with open(path) as fh:
        for line in fh:
            token = re.split(r"[: \t]", line.strip(), maxsplit=1)[0]
            if token:
                out.add(token)
    return out


def _parse_size(s: str) -> int:
    """'8G'/'100000'-style sizes (utils::arg_parse::parse_string_to_size)."""
    s = str(s).strip().upper()
    mult = 1
    if s and s[-1] in "KMG":
        mult = {"K": 10**3, "M": 10**6, "G": 10**9}[s[-1]]
        s = s[:-1]
    return int(float(s) * mult)


def _read_paf(path: str) -> list[tuple]:
    """The overlap tuples of a PAF written by ``--to-paf`` (its ``cg:Z``
    CIGAR last); lines without one are skipped."""
    records = []
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 12:
                continue
            cigar = next((t[5:] for t in reversed(f[12:]) if t.startswith("cg:Z:")), "")
            if cigar:
                records.append((f[0], int(f[1]), int(f[2]), int(f[3]), f[4], f[5], int(f[6]),
                                int(f[7]), int(f[8]), int(f[9]), int(f[10]), int(f[11]),
                                cigar))
    return records


def _run_correct(args: argparse.Namespace) -> int:
    from dorado_tpu_torch.correct import ReadCorrector

    reads = [(name, seq) for name, seq, _ in _read_fastq(args.reads)]
    targets = None
    if args.resume_from:
        if not Path(args.resume_from).exists():
            print(f"> Input resume index file {args.resume_from} does not exist!",
                  file=sys.stderr)
            return 1
        skip_set = _load_skip_set(args.resume_from)
        # everything up to and including the furthest skipped read in input
        # order is done (find_furthest_skipped_read); the remaining targets
        # still overlap against the full read set
        furthest = max((i for i, (name, _) in enumerate(reads)
                        if name.split(":")[0] in skip_set), default=-1)
        if furthest >= 0:
            print(f"> Resuming after read {reads[furthest][0]} ({furthest + 1}/{len(reads)} "
                  f"inputs already corrected)", file=sys.stderr)
            targets = {name for name, _ in reads[furthest + 1 :]}
    # index blocks: reads accumulate until the block reaches --index-size
    # bases (mm2 batch semantics; correct.cpp:125-129)
    index_size = _parse_size(args.index_size)
    blocks: list[list[str]] = [[]]
    cum = 0
    for name, seq in reads:
        blocks[-1].append(name)
        cum += len(seq)
        if cum >= index_size:
            blocks.append([])
            cum = 0
    blocks = [b for b in blocks if b]
    if args.compute_num_blocks:
        print(len(blocks))
        return 0
    if args.run_block_id is not None:
        if not 0 <= args.run_block_id < len(blocks):
            print(f"> --run-block-id {args.run_block_id} out of range (0..{len(blocks) - 1})",
                  file=sys.stderr)
            return 1
        block = set(blocks[args.run_block_id])
        targets = block if targets is None else targets & block

    nn_scorer = None
    device = args.device
    if args.model_path:
        from dorado_tpu_torch.basecall.runner import resolve_device
        from dorado_tpu_torch.correct.nn_model import TorchScriptScorer

        nn_scorer = TorchScriptScorer(args.model_path, resolve_device(device))
        print(f"> Loaded TorchScript scorer from {args.model_path}", file=sys.stderr)
    corrector = ReadCorrector(
        min_depth=args.min_depth, use_nn=args.nn, nn_scorer=nn_scorer,
        kmer_size=args.kmer_size, ovl_window_size=args.ovl_window_size,
        min_chain_score=args.min_chain_score, device=device, threads=args.threads,
    )
    overlap_records = None
    if args.from_paf:
        overlap_records = _read_paf(args.from_paf)
        print(f"> Loaded {len(overlap_records)} PAF overlaps", file=sys.stderr)
    fh = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        if args.to_paf:
            recs = corrector.compute_overlap_records(reads, targets)
            for r in recs:
                fh.write("\t".join(str(v) for v in r[:12]) + f"\tcg:Z:{r[12]}\n")
            print(f"> Wrote {len(recs)} PAF overlaps", file=sys.stderr)
            return 0
        for name, seq in corrector.correct(reads, targets=targets,
                                           overlap_records=overlap_records):
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i : i + 80] + "\n")
    finally:
        if fh is not sys.stdout:
            fh.close()
    st = corrector.stats
    print(f"> Corrected {st.reads_corrected}/{st.reads_total} reads ({st.overlaps} overlaps)",
          file=sys.stderr)
    if corrector.use_nn:
        where = nn_scorer.device if nn_scorer is not None else corrector.device
        print(f"> {st.windows} window(s) on {where}: mapping {st.mapping_s:.1f} s, window "
              f"extraction {st.extract_s:.1f} s, host features {st.features_s:.1f} s, model "
              f"forwards {st.forward_s:.1f} s, decode {st.decode_s:.1f} s", file=sys.stderr)
    return 0


def _add_aligner(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("aligner", help="Align reads to a reference (from-scratch mapper)")
    p.add_argument("reference", help="Reference FASTA")
    p.add_argument("reads", help="Reads: BAM/SAM/FASTQ file or a folder of them")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--emit-sam", action="store_true")
    p.add_argument("-k", type=int, default=15)
    p.add_argument("-w", type=int, default=10)
    p.add_argument("--bed-file", default=None, help="BED regions; adds bh:i overlap-count tags")
    p.add_argument("--no-sort", action="store_true", help="Skip coordinate sorting of BAM output")
    p.add_argument("--mm2-opts", default=None,
                   help="minimap2-style option string, e.g. '-k 15 -w 10'")
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("-r", "--recursive", action="store_true",
                   help="Search the reads folder recursively")
    p.add_argument("--allow-sec-supp", action="store_true",
                   help="Re-align input secondary/supplementary records instead of skipping "
                        "them")
    p.set_defaults(func=_run_aligner)


def _parse_mm2_opts(opts: str | None, k: int, w: int) -> tuple[int, int, int]:
    """(k, w, secondary hits) from a minimap2-style option string: -k, -w,
    -N and --secondary=yes/no (alignment/minimap2_args parity for that
    subset); other options are reported and ignored. minimap2 keeps up to 5
    secondary alignments by default."""
    n_secondary = 5
    toks = (opts or "").split()
    i = 0
    while i < len(toks):
        tok = toks[i]
        value = toks[i + 1] if i + 1 < len(toks) else None
        if tok == "-k" and value is not None:
            k, i = int(value), i + 1
        elif tok == "-w" and value is not None:
            w, i = int(value), i + 1
        elif tok == "-N" and value is not None:
            n_secondary, i = int(value), i + 1
        elif tok.startswith("-k") and len(tok) > 2:
            k = int(tok[2:])
        elif tok.startswith("-w") and len(tok) > 2:
            w = int(tok[2:])
        elif tok == "--secondary=no":
            n_secondary = 0
        elif tok != "--secondary=yes":
            print(f"> Ignoring unsupported mm2 option {tok!r}", file=sys.stderr)
        i += 1
    return k, w, n_secondary


def _run_aligner(args: argparse.Namespace) -> int:
    from dorado_tpu_torch.alignment.aligner import RecordAligner
    from dorado_tpu_torch.alignment.bed_file import BedFile
    from dorado_tpu_torch.alignment.index import ReferenceIndex
    from dorado_tpu_torch.io.cram import CramWriter
    from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamWriter
    from dorado_tpu_torch.io.sorted_bam import SortedBamWriter

    out_is_stdout = args.output == "-"
    k, w, n_secondary = _parse_mm2_opts(args.mm2_opts, args.k, args.w)
    try:
        _, records = _read_inputs(args.reads, args.recursive)
    except (ValueError, FileNotFoundError) as exc:  # not a BAM, an RR=true CRAM, no files
        print(f"> {exc}", file=sys.stderr)
        return 1

    print(f"> Indexing {args.reference}", file=sys.stderr)
    index = ReferenceIndex.build(args.reference, k=k, w=w)
    aligner = RecordAligner(index, bed=BedFile.load(args.bed_file) if args.bed_file else None,
                            n_secondary=n_secondary)
    if not args.allow_sec_supp:
        # input secondary/supplementary records are dropped before
        # re-alignment by default (aligner.cpp:183 skip_sec_supp)
        records = [r for r in records if not r.flag & 0x900]
    if args.max_reads is not None:
        records = records[: args.max_reads]

    header = SamHeader()
    header.sort_order = "unsorted" if args.no_sort else "coordinate"
    header.references = list(zip(index.names, index.lengths))
    header.programs.append({"ID": "aligner", "PN": "dorado_tpu_torch", "CL": args.cli_line})
    if args.emit_sam:
        fh = None if out_is_stdout else open(args.output, "w")
        writer = SamWriter(fh or sys.stdout, header)
    elif not out_is_stdout and args.output.endswith(".cram"):
        # a .cram path: reference-based slices (RR=true) against the index's
        # contigs, as the JAX command writes them; no .bai
        fh = open(args.output, "wb")
        writer = CramWriter(fh, header, ref_seqs=dict(zip(index.names, index.seqs)))
    else:
        fh = None if out_is_stdout else open(args.output, "wb")
        stream = fh or sys.stdout.buffer
        if args.no_sort:
            writer = BamWriter(stream, header)
        else:
            # bounded-memory coordinate sort with a spill-to-disk merge; a
            # sorted file gets its .bai (hts_file.cpp:446-509)
            writer = SortedBamWriter(
                stream, header, index_path=None if out_is_stdout else f"{args.output}.bai")

    n_mapped = 0
    aligned, unmapped = [], []
    for rec in records:
        secondaries = aligner.align(rec)
        if rec.flag & 4:
            unmapped.append(rec)
            continue
        n_mapped += 1
        # minimap2 emits the secondary hits before the primary
        aligned += secondaries + [rec]
    ref_order = {name: i for i, name in enumerate(index.names)}
    aligned.sort(key=lambda r: (ref_order.get(r.rname, 1 << 30), r.pos))
    try:
        for rec in aligned + unmapped:
            writer.write(rec)
        writer.close()
    finally:
        if fh is not None:
            fh.close()
    print(f"> Mapped {n_mapped}/{len(records)} reads", file=sys.stderr)
    return 0


def _add_summary(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("summary", help="Create sequencing summary from a BAM/SAM/CRAM")
    p.add_argument("reads", help="Basecalled BAM, SAM or CRAM file, or a folder of them")
    p.add_argument("-r", "--recursive", action="store_true")
    p.set_defaults(func=_run_summary)


def _run_summary(args: argparse.Namespace) -> int:
    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.io.summary import write_summary

    reads_path = Path(args.reads)
    read_files = [reads_path]
    if reads_path.is_dir():
        read_files = sorted(p for p in reads_path.glob("**/*" if args.recursive else "*")
                            if p.suffix in (".bam", ".sam", ".cram"))
        if not read_files:
            print(f"> No read files found in {args.reads}", file=sys.stderr)
            return 1
    header, records = "", []
    try:
        for rf in read_files:
            text, recs = read_records(rf)
            header = header or text
            records += recs
    except ValueError as exc:  # not a BAM, or a reference-based CRAM
        print(f"> {exc}", file=sys.stderr)
        return 1
    n = write_summary(records, sys.stdout, header_text=header)
    print(f"> Summarised {n} reads", file=sys.stderr)
    return 0


def _add_demux(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("demux", help="Demultiplex basecalled reads by barcode")
    p.add_argument("reads", help="Basecalled BAM, SAM, CRAM or FASTQ file, or a folder of them")
    p.add_argument("--kit-name", default=None,
                   help="Barcoding kit (or use --barcode-arrangement)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--emit-summary", action="store_true",
                   help="Write barcoding_summary.txt into the output directory")
    p.add_argument("--barcode-both-ends", action="store_true")
    p.add_argument("--sample-sheet", default=None,
                   help="MinKNOW sample sheet CSV (barcode aliasing + filtering)")
    p.add_argument("--barcode-arrangement", default=None,
                   help="Custom barcode arrangement TOML")
    p.add_argument("--barcode-sequences", default=None,
                   help="Custom barcode sequences FASTA")
    p.add_argument("--no-classify", action="store_true",
                   help="Group by existing BC tags instead of classifying")
    p.add_argument("--no-trim", action="store_true",
                   help="Keep the barcodes on the reads (default: trim them)")
    p.add_argument("--sort-bam", action="store_true",
                   help="Sort each output BAM by coordinate and write its .bai")
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--read-ids", default=None,
                   help="File with one read id per line; only these are demultiplexed")
    p.add_argument("-r", "--recursive", action="store_true",
                   help="Search the reads folder recursively")
    p.set_defaults(func=_run_demux)


def _read_inputs(reads: str, recursive: bool):
    """(header text of the first BAM, SAM or CRAM, records) of a BAM, SAM,
    CRAM or FASTQ file or of a folder of them (``recursive``: and its
    subfolders); raises ValueError for a reference-based CRAM and
    FileNotFoundError for a folder of none."""
    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.io.sam import SamRecord

    path = Path(reads)
    files = [path]
    if path.is_dir():
        # the reference's HtsReader loop over a folder (demux.cpp, aligner.cpp)
        files = sorted(p for p in path.glob("**/*" if recursive else "*")
                       if p.suffix in (".bam", ".sam", ".cram", ".fastq", ".fq"))
        if not files:
            raise FileNotFoundError(f"No read files found in {reads}")
    header_text, records = "", []
    for f in files:
        if f.suffix in (".fastq", ".fq"):
            records += [SamRecord(qname=n, seq=q, qual=u) for n, q, u in _read_fastq(str(f))]
            continue
        text, recs = read_records(f)
        header_text = header_text or text
        records += recs
    return header_text, records


def _run_demux(args: argparse.Namespace) -> int:
    from collections import defaultdict

    from dorado_tpu_torch.demux.barcoder import (
        UNCLASSIFIED, determine_barcode_trim_interval, normalize_barcode_name,
    )
    from dorado_tpu_torch.demux.trimmer import trim_record
    from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamTag
    from dorado_tpu_torch.io.sorted_bam import SortedBamWriter

    try:
        header_text, records = _read_inputs(args.reads, args.recursive)
    except (ValueError, FileNotFoundError) as exc:  # not a BAM, an RR=true CRAM, no files
        print(f"> {exc}", file=sys.stderr)
        return 1
    # BAM input carries no run index: aliases are looked up by barcode alone
    sample_sheet = (SampleSheet(args.sample_sheet, skip_index_matching=True)
                    if args.sample_sheet else None)
    classifier = None
    kit_display = args.kit_name or ""
    if args.barcode_arrangement:
        kit_display = parse_custom_arrangement(args.barcode_arrangement)[0]
    if not args.no_classify:
        classifier = _barcode_classifier(args, sample_sheet)
        if classifier is None:
            print("> demux requires --kit-name (or --barcode-arrangement) unless --no-classify "
                  "groups by existing BC tags.", file=sys.stderr)
            return 1
        kit_display = classifier.kit_info["name"]
    only_ids = _read_ids(args.read_ids)

    by_barcode = defaultdict(list)
    original_barcode: dict[str, str] = {}  # read -> its barcode where an alias replaced it
    n_done = 0
    for rec in records:
        if only_ids is not None and rec.qname not in only_ids:
            continue
        if args.max_reads is not None and n_done >= args.max_reads:
            break
        n_done += 1
        if args.no_classify:
            name = next((t.value for t in rec.tags if t.tag == "BC"), UNCLASSIFIED)
            by_barcode[name].append(rec)
            continue
        seq = rec.seq if rec.seq != "*" else ""
        result = classifier.classify(seq, barcode_both_ends=args.barcode_both_ends)
        if result.barcode_name == UNCLASSIFIED:
            name = UNCLASSIFIED
        else:
            # the sample sheet's alias replaces the barcode in BC and in the
            # grouping (BarcodeClassifierNode.cpp:131-137)
            name = f"{kit_display}_{normalize_barcode_name(result.barcode_name)}"
            original_barcode[rec.qname] = name
            if sample_sheet is not None:
                name = sample_sheet.get_alias(name) or name
        rec.tags = [t for t in rec.tags if t.tag != "BC"] + [SamTag("BC", "Z", name)]
        if not args.no_trim and result.barcode_name != UNCLASSIFIED:
            # the barcodes' span cut off the read (Trimmer.cpp:40-91)
            interval = determine_barcode_trim_interval(result, len(rec.seq))
            if interval != (0, len(rec.seq)):
                trim_record(rec, interval)
        by_barcode[name].append(rec)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    header = SamHeader()
    header.comments = [line.split("\t", 1)[-1] for line in header_text.splitlines()
                       if line.startswith("@CO")]
    for name, recs in sorted(by_barcode.items()):
        path = out_dir / f"{name}.bam"
        with open(path, "wb") as fh:
            writer = (SortedBamWriter(fh, header, index_path=f"{path}.bai") if args.sort_bam
                      else BamWriter(fh, header))
            for rec in recs:
                writer.write(rec)
            writer.close()
        print(f"> {name}: {len(recs)} reads -> {path}", file=sys.stderr)
    if args.emit_summary:
        # the barcoding summary beside the demultiplexed files (demux.cpp:260-264)
        spath = out_dir / "barcoding_summary.txt"
        with open(spath, "w") as fh:
            fh.write("read_id\tbarcode_arrangement\tbarcode_kit\talias\n")
            for name, recs in sorted(by_barcode.items()):
                for rec in recs:
                    orig = original_barcode.get(rec.qname, name)
                    fh.write(f"{rec.qname}\t{orig}\t{kit_display}\t"
                             f"{name if name != orig else ''}\n")
        print(f"> Barcoding summary -> {spath}", file=sys.stderr)
    return 0


def _add_trim(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("trim", help="Trim adapters and primers from basecalled reads")
    p.add_argument("reads", help="Basecalled BAM, SAM or CRAM file")
    p.add_argument("-o", "--output", default="-", help="Output file or - for stdout")
    p.add_argument("--emit-sam", action="store_true", help="Emit SAM instead of BAM")
    p.add_argument("--emit-fastq", action="store_true")
    p.add_argument("--kit-name", default=None)
    p.add_argument("--sequencing-kit", default=None,
                   help="Sequencing kit (used where --kit-name is not given)")
    p.add_argument("--primer-sequences", default=None, help="Custom primer sequences FASTA")
    p.add_argument("--no-trim-primers", action="store_true")
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--read-ids", default=None,
                   help="File with one read id per line; only these are trimmed")
    # read by neither the JAX command nor this one: both trim as for DNA
    p.add_argument("--rna", action="store_true",
                   help="Input is direct RNA (accepted; the trim is the same)")
    p.set_defaults(func=_run_trim)


def _run_trim(args: argparse.Namespace) -> int:
    from dorado_tpu_torch.io.bam_reader import read_records
    from dorado_tpu_torch.io.sam import SamHeader

    trimmer = ReadTrimmer(
        adapters=True, primers=not args.no_trim_primers,
        kit_name=args.kit_name or args.sequencing_kit,
        custom_primers=(parse_custom_sequences(args.primer_sequences)
                        if args.primer_sequences else None))
    try:
        _, records = read_records(args.reads)
    except ValueError as exc:  # not a BAM, or a reference-based CRAM
        print(f"> {exc}", file=sys.stderr)
        return 1
    only_ids = _read_ids(args.read_ids)
    if only_ids is not None:
        records = [r for r in records if r.qname in only_ids]
    if args.max_reads is not None:
        records = records[: args.max_reads]
    writer, fh = _open_writer(args.output, args, SamHeader())
    n_trimmed = 0
    try:
        for rec in records:
            before = len(rec.seq)
            trimmer.trim(rec)
            n_trimmed += len(rec.seq) != before
            writer.write(rec)
        writer.close()
    finally:
        if fh is not None:
            fh.close()
    print(f"> Trimmed {n_trimmed}/{len(records)} reads", file=sys.stderr)
    return 0


def crash_hook(exc_type, exc, tb) -> None:
    """An uncaught exception: its summary and traceback, then each visible
    card's state (the reference's crash reports, gpu_monitor's
    get_devices_status_info). The ``sys.excepthook`` of a command-line run
    (``python -m dorado_tpu_torch``); ``main`` called in-process leaves the
    caller's hook as it is."""
    import traceback

    print(f"[dorado_tpu_torch] terminating with uncaught exception: {exc}", file=sys.stderr)
    traceback.print_exception(exc_type, exc, tb)
    try:
        from dorado_tpu_torch.utils.device_monitor import describe_devices

        for line in describe_devices():
            print(f"[dorado_tpu_torch] {line}", file=sys.stderr)
    except Exception:
        pass


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="dorado_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_basecaller(sub)
    _add_duplex(sub)
    _add_polish(sub)
    _add_variant(sub)
    _add_correct(sub)
    _add_aligner(sub)
    _add_summary(sub)
    _add_demux(sub)
    _add_trim(sub)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    # the @PG CL line: the command as given, shell-quoted
    args.cli_line = shlex.join(["dorado_tpu_torch", *argv])
    return args.func(args)


if __name__ == "__main__":
    sys.excepthook = crash_hook
    sys.exit(main())
