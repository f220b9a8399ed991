"""Runs over several processes (``parallel.distributed``) on the CPU: two
real processes in one gloo process group over 127.0.0.1 run the checks of
the JAX package's two-process worker (``tests/test_distributed.py``): file
sharding, the stats all-reduce, the barrier and the BAM merge. The merge
writes the same bytes as the JAX package's on the same shard files, on its
splice path and on both of its re-encoding paths (a shard cut short, a
header that differs); the small helpers give the JAX package's results.
"""

import os
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from dorado_tpu.parallel import distributed as jax_distributed
from dorado_tpu_torch.io.bam_reader import read_bam
from dorado_tpu_torch.io.bgzf import BGZF_EOF
from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamRecord
from dorado_tpu_torch.parallel import distributed

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent(
    """
    import sys
    from pathlib import Path

    sys.path.insert(0, {repo!r})
    from dorado_tpu_torch.io.bam_reader import read_bam
    from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamRecord
    from dorado_tpu_torch.parallel.distributed import (
        all_reduce_stats, barrier, host_output_path, init_distributed,
        merge_host_bams, shard_files_for_host,
    )

    pid, coord, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    assert init_distributed(coord, num_processes=2, process_id=pid) == (pid, 2)

    files = [Path(f"f{{i}}.pod5") for i in range(7)]
    mine = shard_files_for_host(files)
    assert len(mine) == (4 if pid == 0 else 3), mine

    # each process writes its own BAM
    out = Path(outdir) / "calls.bam"
    n_mine = 3 if pid == 0 else 2
    with open(host_output_path(out), "wb") as f:
        w = BamWriter(f, SamHeader())
        for i in range(n_mine):
            w.write(SamRecord(qname=f"h{{pid}}-r{{i}}", seq="ACGT", qual="IIII"))
        w.close()

    stats = all_reduce_stats({{"reads": float(n_mine), "bases": 4.0 * n_mine}})
    assert stats == {{"bases": 20.0, "reads": 5.0}}, stats

    barrier("pre-merge")
    if pid == 0:
        assert merge_host_bams(out, 2) == 2
        names = [r.qname for r in read_bam(out)[1]]
        assert names == ["h0-r0", "h0-r1", "h0-r2", "h1-r0", "h1-r1"], names
    barrier("post-merge")
    print(f"WORKER_OK {{pid}}")
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_run(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=str(REPO)))
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), coord, str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:  # a worker that hangs (the other one failed) is ended here
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"WORKER_OK {pid}" in out, err[-3000:]
    assert not (tmp_path / "calls.host1.bam").exists()


def test_single_process_helpers():
    assert distributed.init_distributed() == (0, 1)
    values = {"reads": 3.0, "bases": 12.0}
    assert distributed.all_reduce_stats(values) == values
    distributed.barrier("alone")


@pytest.mark.parametrize("pi,pc", [(0, 1), (0, 2), (1, 2), (2, 3), (3, 4)])
def test_file_shards_and_output_names_match_jax(pi, pc):
    files = [Path(f"run/{c}{i}.pod5") for i, c in enumerate("gbfdaec")]
    assert distributed.shard_files_for_host(files, pi, pc) == \
        jax_distributed.shard_files_for_host(files, pi, pc)
    for out in ("calls.bam", "out/x.sam", Path("/data/calls")):
        assert distributed.host_output_path(out, pi) == jax_distributed.host_output_path(out, pi)


def _write_shard(path, names, seq="ACGTACGT", header=None):
    with open(path, "wb") as f:
        w = BamWriter(f, header or SamHeader())
        for q in names:
            w.write(SamRecord(qname=q, seq=seq, qual="I" * len(seq)))
        w.close()


def _shards(root: Path, case: str) -> Path:
    """Process 0's BAM and two more processes' shards under ``root``."""
    root.mkdir()
    out = root / "calls.bam"
    _write_shard(out, [f"h0-r{i}" for i in range(4)])
    for pid, n in ((1, 3), (2, 5)):
        header = None
        if case == "header" and pid == 2:
            header = SamHeader()
            header.programs.append({"ID": "other", "PN": "x"})
        shard = distributed.host_output_path(out, pid)
        _write_shard(shard, [f"h{pid}-r{i}" for i in range(n)], header=header)
        if case == "truncated" and pid == 1:
            shard.write_bytes(shard.read_bytes()[: -len(BGZF_EOF)])  # a crashed writer
    return out


@pytest.mark.parametrize("case", ["splice", "truncated", "header"])
def test_merge_writes_the_bytes_of_the_jax_merge(tmp_path, case):
    out = _shards(tmp_path / "port", case)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    ref = tmp_path / "jax" / "calls.bam"
    spliced = out.read_bytes()[: -len(BGZF_EOF)]
    span = distributed._bam_header_info(distributed.host_output_path(out, 1))[0]
    shard1 = distributed.host_output_path(out, 1).read_bytes()
    assert distributed.merge_host_bams(out, 3) == jax_distributed.merge_host_bams(ref, 3) == 8
    assert out.read_bytes() == ref.read_bytes()
    names = [r.qname for r in read_bam(out)[1]]
    assert names == [f"h0-r{i}" for i in range(4)] + [f"h1-r{i}" for i in range(3)] + \
        [f"h2-r{i}" for i in range(5)]
    assert not any(distributed.host_output_path(out, p).exists() for p in (1, 2))
    # the splice appends the shards' record blocks verbatim; the other cases
    # re-encode every record
    assert out.read_bytes().startswith(spliced + shard1[span : -len(BGZF_EOF)]) == (
        case == "splice")
