"""Time the two traceback kernels (K5, csrc/crf_traceback.cu; the beam
traceback, csrc/beam_search.cu) against other forms of their sources, on
one card in one process:

    python3 time_traceback_forms.py NAME=DIR [NAME=DIR ...]

Each DIR holds a form's crf_traceback.cu and beam_search.cu with the
headers they include (common.cuh, tma_map.cuh): the parent commit's csrc
(name it "old": its K5 writes [T, N] and has no SASS chain to print), or
an edited copy. A form named "clk" is an edited copy whose two C entry
points take one more argument, a long long pointer, into which lane 0 of
each row writes its clock64() sums of the waits on the ring, the chain and
the rest of each chunk, and its total: printed as cycles a step.

Holds this tree's kernels and every form against the plain versions at
hac's and sup's shapes (chip_smoke.py holds the tree's at ragged shapes
too); times this tree and the forms in turns (this tree, the forms, the forms in reverse, this
tree; events around 20 launches); and prints, for this tree and each form,
the SASS of one step of each chain: from a step's shared-memory load to
the next one's."""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from dorado_tpu_torch.ops import _cuda, beam, crf_cuda  # noqa: E402

NAMES = ("crf_traceback", "beam_search")
VP, INT = ctypes.c_void_p, ctypes.c_int


def chain_sass(lib: Path, kernel: str) -> list[str]:
    """The instructions of ``kernel`` in ``lib`` from its first LDS to its
    second: one step of the unrolled chain."""
    sass = subprocess.run([str(Path(_cuda._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    body = sass[sass.index(kernel):].split("Function :")[0]
    ops = [line.split("*/", 1)[1].split(";")[0].strip() for line in body.splitlines()
           if line.strip().startswith("/*") and "*/" in line and ";" in line]
    loads = [i for i, op in enumerate(ops) if op.split(" ")[0].startswith("LDS")]
    return ops[loads[0]:loads[1] + 1]


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("time_traceback_forms: CUDA is not available")
    forms = {arg.split("=", 1)[0]: Path(arg.split("=", 1)[1]) for arg in sys.argv[1:]}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    procs = [
        (d / f"{n}.so", subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(d / f"{n}.so"), str(d / f"{n}.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
        for d in forms.values() for n in NAMES
    ]
    libs = _cuda.build_kernels(NAMES)
    for so, proc in procs:
        if proc.wait() != 0:
            sys.exit(f"time_traceback_forms: {so} did not build")
    k5, bt = {}, {}
    for f, d in forms.items():
        extra = [VP] if f == "clk" else []
        k5[f] = ctypes.CDLL(str(d / "crf_traceback.so")).crf_traceback
        k5[f].argtypes = [VP] * 4 + [INT] * 3 + [VP] + extra
        bt[f] = ctypes.CDLL(str(d / "beam_search.so")).beam_traceback
        bt[f].argtypes = [VP] * 5 + [INT] * 2 + [VP] + extra
    # the parent's kernels load from device memory: no shared-memory chain
    for f, (k5_lib, bt_lib) in {"tree": (libs["crf_traceback"], libs["beam_search"]),
                                **{f: (d / "crf_traceback.so", d / "beam_search.so")
                                   for f, d in forms.items() if f != "old"}}.items():
        print(f"{f}: one step of K5's chain at 256 states: "
              f"{' | '.join(chain_sass(k5_lib, 'traceback_kernelILi256'))}")
        print(f"{f}: one step of the beam traceback's chain: "
              f"{' | '.join(chain_sass(bt_lib, 'beam_traceback_kernel'))}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    all_ok = True

    def compare(what, t, n, tree, form_args, plain, t_major_old):
        """Hold this tree's kernel and every form against the plain version,
        time all in turns and print the clock copy's cycles a step."""
        nonlocal all_ok
        got = tree()
        torch.cuda.synchronize()
        ok = torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        all_ok &= ok
        print(f"{what} T={t} N={n}: this tree's kernel {'equal' if ok else 'DIFFERS'}")
        clk = torch.zeros(n, 4, dtype=torch.int64, device=dev)
        runs = {"tree": tree}
        outputs = []  # each form's outputs live while it is timed
        for f, fn in form_args.items():
            old_layout = f == "old" and t_major_old
            st = torch.empty((t, n) if old_layout else (n, t), dtype=torch.int32, device=dev)
            mv = torch.empty((t, n) if old_layout else (n, t), dtype=torch.uint8, device=dev)
            outputs.append((st, mv))
            args = fn(st, mv) + ([clk.data_ptr()] if f == "clk" else [])
            lib = (k5 if what.startswith("K5") else bt)[f]
            runs[f] = lambda lib=lib, args=args: lib(*args)
            if runs[f]() != 0:
                sys.exit(f"time_traceback_forms: form {f} failed to launch")
            torch.cuda.synchronize()
            got = (st, mv) if old_layout or not t_major_old else (st.t(), mv.t())
            ok = torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
            all_ok &= ok
            print(f"  {f}: {'equal' if ok else 'DIFFER'}")
        ms = {}
        for f in ["tree", *forms, *reversed(forms), "tree"]:
            ms.setdefault(f, []).append(time_ms(runs[f]))
        print(f"{what} T={t} N={n}: " + ", ".join(f"{f} {v[0]:.4f} {v[1]:.4f} ms"
                                                  for f, v in ms.items()), flush=True)
        if "clk" in forms:
            c = (clk.double().mean(dim=0) / t).tolist()
            print(f"  cycles a step (mean over rows): wait {c[0]:.1f} chain {c[1]:.1f} "
                  f"rest {c[2]:.1f} all {c[3]:.1f}", flush=True)

    for t, n, s in [(1666, 128, 256), (2048, 128, 1024), (1666, 128, 64)]:
        ch = torch.randint(0, 5, (t, n, s), generator=gen, device=dev).to(torch.int8)
        ch[torch.rand(t, n, s, generator=gen, device=dev) < 0.01] = -3
        ch[torch.rand(t, n, s, generator=gen, device=dev) < 0.01] = 9
        last = torch.randint(0, s, (n,), generator=gen, device=dev).to(torch.int32)
        plain = crf_cuda.viterbi_traceback_plain(ch, last)
        compare(f"K5 S={s}", t, n, lambda: crf_cuda.viterbi_traceback(ch, last),
                {f: (lambda st, mv: [ch.data_ptr(), last.data_ptr(), st.data_ptr(),
                                     mv.data_ptr(), t, n, s, stream]) for f in forms},
                plain, True)
    for t, n in [(1666, 128), (2048, 128)]:
        hs = torch.randint(0, 1 << 20, (t, n, 32), generator=gen, device=dev).to(torch.int32)
        parent = torch.randint(0, 32, (t, n, 32), generator=gen, device=dev)
        stay = torch.rand(t, n, 32, generator=gen, device=dev) < 0.3
        ps = (parent | (stay.long() << 7)).to(torch.uint8)
        fin = torch.randn(n, 32, generator=gen, device=dev)
        fin[:, 5] = fin.max(dim=1).values + 1  # a tie for the best: the first wins
        fin[:, 9] = fin[:, 5]
        plain = beam.beam_traceback_plain(hs, ps, fin)
        compare("beam traceback", t, n, lambda: beam.beam_traceback(hs, ps, fin),
                {f: (lambda st, mv: [hs.data_ptr(), ps.data_ptr(), fin.data_ptr(), st.data_ptr(),
                                     mv.data_ptr(), t, n, stream]) for f in forms},
                plain, False)
    print("all forms equal to the plain versions" if all_ok else "SOME FORMS DIFFER")
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
