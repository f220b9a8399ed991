"""Several processes: process groups, input sharding, stats, barrier, merge.

Port of ``dorado_tpu/parallel/distributed.py``, a library (the command line
does not call it). The reference runs one process (shared-memory queues);
a run over several processes, one host or many, follows the "aggregate only
at the end" form: each process basecalls its share of the POD5 files into
its own BAM, one small all-reduce sums the end-of-run counters, a barrier
fences the end, and process 0 appends the other processes' BAMs to its own
(the reference appends every read to one writer, BasecallerNode.cpp:488).

The process group is ``torch.distributed`` on the gloo backend over TCP:
what it carries are host numbers (the counters), and two processes may
share one card, which NCCL refuses.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.distributed as dist

from dorado_tpu_torch.io.bam_reader import stream_bam
from dorado_tpu_torch.io.bgzf import BGZF_EOF, BgzfWriter
from dorado_tpu_torch.io.sam import encode_bam_record


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join the process group of a run over several processes:
    ``coordinator_address`` is process 0's ``host:port`` (or a ``tcp://``
    URL), which every process gives with the group's size and its own rank.
    Without an address nothing is started. Returns (rank, world size): (0, 1)
    for a single process."""
    if coordinator_address is not None:
        url = coordinator_address
        if "://" not in url:
            url = f"tcp://{url}"
        dist.init_process_group(
            "gloo", init_method=url, world_size=num_processes, rank=process_id
        )
    return _rank(), _world_size()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_files_for_host(
    files: list[Path], process_index: int | None = None, process_count: int | None = None
) -> list[Path]:
    """This process's POD5 files: a static round robin over the sorted
    list, so processes share the input and never the chunks."""
    pi = _rank() if process_index is None else process_index
    pc = _world_size() if process_count is None else process_count
    return [f for i, f in enumerate(sorted(files)) if i % pc == pi]


def host_output_path(output: str | Path, process_index: int | None = None) -> Path:
    """A process's output file: process 0 keeps the name the user gave (so a
    single process writes where it always did), process i writes
    ``<stem>.host<i><suffix>``."""
    pi = _rank() if process_index is None else process_index
    output = Path(output)
    if pi == 0:
        return output
    return output.with_suffix(f".host{pi}{output.suffix}")


def all_reduce_stats(values: dict[str, float]) -> dict[str, float]:
    """The sums over every process of each process's counters (reads,
    bases, samples): one float64 all-reduce over the sorted keys at the end
    of a run; the values themselves in a single process. Every process must
    give the same keys."""
    if _world_size() == 1:
        return dict(values)
    keys = sorted(values)
    local = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(local, op=dist.ReduceOp.SUM)
    return {k: float(v) for k, v in zip(keys, local.tolist())}


def barrier(name: str = "sync") -> None:
    """Block until every process reaches this point (``name`` says which
    fence it is, as the JAX barrier is named); nothing in a single process."""
    if _world_size() == 1:
        return
    dist.barrier()


def _bam_header_info(path: Path) -> tuple[int, bytes] | None:
    """(byte offset where the record blocks start, the decompressed header)
    of ``path`` when its header ends on a BGZF block boundary, as the port's
    ``BamWriter`` writes it (it flushes after the header); None when records
    share the header's last block (another writer), so that the merge must
    re-encode. The header lets the merge check that a shard's reference and
    read-group tables, which BAM records name by position, are process 0's
    before it splices."""
    with open(path, "rb") as fh:
        payload = b""
        header_ulen = None
        coffset = 0
        while True:
            head = fh.read(18)
            if len(head) < 18 or head[:4] != b"\x1f\x8b\x08\x04":
                return None
            xlen = struct.unpack("<H", head[10:12])[0]
            extra = head[12:18] + fh.read(xlen - 6)
            bsize = None
            i = 0
            while i + 4 <= len(extra):
                slen = struct.unpack("<H", extra[i + 2 : i + 4])[0]
                if extra[i] == 0x42 and extra[i + 1] == 0x43 and slen == 2:
                    bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
                i += 4 + slen
            if bsize is None:
                return None
            cdata = fh.read(bsize - 18 - xlen + 6 - 8)
            fh.read(8)  # crc + isize
            payload += zlib.decompress(cdata, -15)
            coffset += bsize
            if header_ulen is None and len(payload) >= 12:
                if payload[:4] != b"BAM\x01":
                    return None
                l_text = struct.unpack("<i", payload[4:8])[0]
                if len(payload) >= 12 + l_text:
                    n_ref = struct.unpack("<i", payload[8 + l_text : 12 + l_text])[0]
                    pos = 12 + l_text
                    ok = True
                    for _ in range(n_ref):
                        if len(payload) < pos + 4:
                            ok = False
                            break
                        pos += 8 + struct.unpack("<i", payload[pos : pos + 4])[0]
                    if ok and pos <= len(payload):
                        header_ulen = pos
            if header_ulen is not None:
                if len(payload) == header_ulen:
                    return coffset, payload
                if len(payload) > header_ulen:
                    return None  # records share the header's last block
            if len(payload) > (1 << 24):  # a runaway header: re-encode instead
                return None


def _count_records(path: Path, start: int) -> int:
    """The records of a BAM from byte ``start`` (a block boundary) on, by
    the 4-byte length walk over the inflated blocks: no record is decoded."""
    n = 0
    pending = b""
    need = 0  # bytes of the current record still to skip
    with open(path, "rb") as fh:
        fh.seek(start)
        while True:
            head = fh.read(18)
            if len(head) < 18:
                break
            xlen = struct.unpack("<H", head[10:12])[0]
            extra = head[12:18] + fh.read(xlen - 6)
            bsize = None
            i = 0
            while i + 4 <= len(extra):
                if extra[i] == 0x42 and extra[i + 1] == 0x43:
                    bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
                i += 4 + struct.unpack("<H", extra[i + 2 : i + 4])[0]
            cdata = fh.read(bsize - 12 - xlen - 8)
            fh.read(8)
            buf = pending + zlib.decompress(cdata, -15)
            pos = 0
            while True:
                if need:
                    take = min(need, len(buf) - pos)
                    pos += take
                    need -= take
                    if need:
                        break
                if pos + 4 > len(buf):
                    break
                need = struct.unpack("<i", buf[pos : pos + 4])[0]
                pos += 4
                n += 1
            pending = buf[pos:]
    return n


def _ends_with_eof(path: Path) -> bool:
    with open(path, "rb") as fh:
        fh.seek(max(0, path.stat().st_size - len(BGZF_EOF)))
        return fh.read() == BGZF_EOF


def _splice(output: Path, shards: list[Path], spans: dict[Path, int]) -> None:
    """Append each shard's record blocks to ``output`` as raw compressed
    bytes: ``output``'s EOF marker is cut, each shard's header blocks and EOF
    marker are skipped, and one EOF marker closes the file."""
    with open(output, "r+b") as out_f:
        out_f.seek(0, os.SEEK_END)
        size = out_f.tell()
        out_f.seek(max(0, size - len(BGZF_EOF)))
        if out_f.read(len(BGZF_EOF)) == BGZF_EOF:
            out_f.seek(size - len(BGZF_EOF))
            out_f.truncate()
        else:
            out_f.seek(0, os.SEEK_END)
        for s in shards:
            with open(s, "rb") as in_f:
                in_f.seek(spans[s])
                remaining = s.stat().st_size - spans[s] - len(BGZF_EOF)
                while remaining > 0:
                    chunk = in_f.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    out_f.write(chunk)
                    remaining -= len(chunk)
        out_f.write(BGZF_EOF)


def _reencode(output: Path, shards: list[Path]) -> int:
    """Stream ``output``'s records and then every shard's into a new file
    under ``output``'s header, and put it in ``output``'s place; returns the
    shards' records."""
    appended = 0
    tmp = output.with_suffix(output.suffix + ".merge")
    with open(tmp, "wb") as out_f:
        bgzf = None
        ref_ids: dict[str, int] = {}
        for src in [output, *shards]:
            with open(src, "rb") as in_f:
                header_text, refs, records = stream_bam(in_f)
                if bgzf is None:
                    bgzf = BgzfWriter(out_f)
                    text = header_text.encode()
                    blob = b"BAM\x01" + struct.pack("<i", len(text)) + text
                    blob += struct.pack("<i", len(refs))
                    for name, length in refs:
                        nb = name.encode() + b"\x00"
                        blob += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
                    bgzf.write(blob)
                    ref_ids = {name: i for i, (name, _) in enumerate(refs)}
                for rec in records:
                    bgzf.write(encode_bam_record(rec, ref_ids))
                    if src != output:
                        appended += 1
        if bgzf is not None:
            bgzf.close()
    os.replace(tmp, output)
    return appended


def merge_host_bams(output: str | Path, process_count: int) -> int:
    """Append the other processes' BAMs (``host_output_path``) to process
    0's ``output``, in process order, and remove them; returns the count of
    records appended.

    Where every shard's header is byte for byte process 0's, ends on a BGZF
    block boundary and the shard ends in the EOF marker (files of the port's
    ``BamWriter``), the shards' record blocks are spliced in as raw
    compressed bytes, with no record decoded or re-encoded, so the merge
    runs at the file system's speed (samtools cat's way). Otherwise (another
    writer, other headers, a shard cut short by a crash, whose last 28 bytes
    the splice would drop) every record is re-encoded under process 0's
    header."""
    output = Path(output)
    shards = [host_output_path(output, pi) for pi in range(1, process_count)]
    shards = [s for s in shards if s.exists()]
    if not shards:
        return 0
    own = _bam_header_info(output)
    infos = {s: _bam_header_info(s) for s in shards}
    splice = own is not None and all(
        info is not None and info[1] == own[1] and _ends_with_eof(s)
        for s, info in infos.items()
    )
    if splice:
        spans = {s: infos[s][0] for s in shards}
        try:
            # zlib releases the GIL: the shards' counts run side by side
            with ThreadPoolExecutor(max_workers=min(8, len(shards))) as pool:
                counts = list(pool.map(_count_records, shards, [spans[s] for s in shards]))
        except Exception:  # a shard that does not parse: re-encode, record by record
            splice = False
    if splice:
        _splice(output, shards, spans)
        appended = sum(counts)
    else:
        appended = _reencode(output, shards)
    for s in shards:
        s.unlink()
    return appended
