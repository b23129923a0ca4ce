#!/usr/bin/env python3
"""Times one tree's Stream-K GEMM on the card, on the rotating harness of
`chip_smoke.py:split_stream_kernels`: the member 32x512x17408 bf16 at
G = 8, four operand sets (71 MB together, beyond the 50 MB L2) taken in
turn, each call queued behind a sleep of the card and timed with CUDA
events (mean of 50 calls).

    python3 probes/stream_k_fixup/ab.py TREE LABEL [--variants flat,fence,...]

TREE is the root of a checkout: this one, or a parent commit unpacked by
``git archive``.  Its ``src/`` is imported and its Stream-K source built.

A tree whose launcher is `stream_k_matmul` (one launch) is timed as it
is and, with ``--variants``, beside copies of its source patched by text
(`VARIANTS`), each built with the tree's flags, in turns (tree,
variants..., variants reversed, tree):

- ``flat``: `fixup_runs` returning n, one run (the last contributor of a
  cut tile sums all n shares, as the ragged walk does);
- ``fence``: the count by fence, atomicAdd, fence (a grid barrier's
  pattern) in place of one ``atom.add.acq_rel.gpu``;
- ``memset``: the counters also zeroed by a ``cudaMemsetAsync`` on the
  stream before every launch;
- ``nohints``: the walk's slabs copied with no L2 eviction policy;
- to take the time apart (results wrong, not checked): ``nofinish``, no
  sums after the walk (shares published, runs counted); ``noarrive``,
  shares stored but never counted.

The stream's counters are zeroed before each variant is run; the probe
prints how many the tree left nonzero, and the time of a ``zero_`` of
them.

A tree with the two-launch pair (`stream_k_partials`, then
`stream_k_fixup`) is timed as the pair per call, and each of the two
alone (the fixup on partials just written, in L2).  `torch.matmul` on
the same sets is timed in every tree.  Every checked variant is first
held to the tree's plain version.  Prints the card's name and power
limit, then one JSON line per timing.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from itertools import cycle
from pathlib import Path

import torch

SLEEP_CYCLES = 500_000_000
M, N, K, G = 32, 512, 17408, 8
SETS = 4


def device_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Mean device time of one call: the card sleeps while the host queues
    ``reps`` calls, and CUDA events time them from the sleep's end."""
    for _ in range(warmup):
        fn()
    cycles = SLEEP_CYCLES
    for _ in range(3):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = time.perf_counter() - h0
        ev[2].record()
        ev[2].synchronize()
        if host < ev[0].elapsed_time(ev[1]) / 1e3:
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 4
    raise RuntimeError("the host could not queue the calls ahead of the card")


def rotating(fn, sets):
    it = cycle(sets)
    return lambda: fn(*next(it))


def check(out, ref, a, b, what: str) -> float:
    """`chip_smoke.py:check_close`'s tolerance (bf16 output)."""
    err = (out.float() - ref.float()).abs()
    tol = 2.0 ** -7 * ref.float().abs() + 2.0 ** -16 * (a.float().abs() @ b.float().abs())
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max |err| {err.max().item():.4g}")
    return float(err.max())


# name: [(regex, replacement)], applied to the tree's gemm_stream_k.cu
# (a replacement string, or a function of the match for literal text).
VARIANTS = {
    "flat": [(r"(int fixup_runs\(int n\) \{)[^}]*\}", r"\1\n  return n;\n}")],
    "fence": [(r'int n;\n\s*asm volatile\("atom\.add\.acq_rel\.gpu\.global\.s32 %0, \[%1\], 1;"'
               r'\n\s*: "=r"\(n\) : "l"\(counter\) : "memory"\);',
               "__threadfence();\n      int n = atomicAdd(counter, 1);\n      __threadfence();")],
    "memset": [(r"(cudaStream_t s = static_cast<cudaStream_t>\(stream\);)",
                r"\1\n  cudaError_t e = cudaMemsetAsync(counters, 0, 4 * live * sizeof(int), s);"
                r"\n  if (e != cudaSuccess) return (int)e;")],
    "nohints": [(r"\n\s*const uint64_t stream = l2_policy<true>\(\), keep = l2_policy<false>\(\);", ""),
                (r"K, M, keep\);", "K, M);"), (r"M, K, keep\);", "M, K);"),
                (r"N, K, stream\);", "N, K);"), (r"K, N, stream\);", "K, N);")],
    "nofinish": [(r"if \(owed0 >= 0\) tiles\.finish\(owed0, staged0\);\n\s*"
                  r"if \(owed1 >= 0\) tiles\.finish\(owed1, staged1\);", "")],
    "noarrive": [(r"(bool arrive\(int\* counter, int of\) const \{)", r"\1\n    return false;")],
}
CHECKED = ("tree", "flat", "fence", "memset", "nohints")


def variant_library(K_mod, name: str):
    """The tree's Stream-K source patched as `VARIANTS` says, built with the
    tree's nvcc flags into its build directory and loaded with the
    launcher's signatures."""
    import ctypes
    b = K_mod._build
    src = (b.CSRC / "gemm_stream_k.cu").read_text()
    for pattern, repl in VARIANTS[name]:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"variant {name}: {pattern!r} matched {n} times")
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = b.BUILD_DIR / f"probe_{name}_stream_k.cu"
    path.write_text(src)
    out = b.BUILD_DIR / f"probe_{name}_stream_k.so"
    subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC), "-o", str(out),
                    str(path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in K_mod._STREAM_K_SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels.gemm import kernel as K_mod
    from repro_torch.kernels.gemm import ref as R_mod

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    sets = [(torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16),
             torch.randn((K, N), generator=gen, device="cuda", dtype=torch.bfloat16)
             .mul_(K ** -0.5)) for _ in range(SETS)]
    a, b = sets[0]
    geo = K_mod.card_geometry(M, N, K, torch.bfloat16, False, False, G, a.device)
    kw = dict(bm=geo.rows, bn=geo.cols, bk=geo.bk, grid_g=geo.workgroups)
    base = dict(tree=args.label, shape=f"{M}x{N}x{K} g{G}", W=geo.workgroups,
                live=geo.live, contributors=int(geo.counts.max()))

    def emit(variant, ms, **more):
        print(json.dumps({**base, "variant": variant, "ms": ms, **more}))

    times = {}
    if hasattr(K_mod, "stream_k_matmul"):
        c = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
        floats, n_cnt = K_mod.stream_k_workspace(geo.live, geo.rows, geo.cols)
        ws = torch.empty(floats, device="cuda")
        cnt = K_mod.stream_counters(a.device, n_cnt)

        def one(x, y):
            K_mod.stream_k_matmul(x, y, grid_g=G, out=c, workspace=ws)

        from concurrent.futures import ThreadPoolExecutor
        names = [v for v in args.variants.split(",") if v]
        libs = {"tree": K_mod._build.load("gemm_stream_k", K_mod._STREAM_K_SIGNATURES)}
        with ThreadPoolExecutor(len(names) or 1) as pool:
            libs.update(zip(names, pool.map(lambda v: variant_library(K_mod, v), names)))
        runs = K_mod.fixup_runs(int(geo.counts.max()))
        plain = {"tree": R_mod.stream_k_matmul_ref(a, b, **kw),
                 "fence": R_mod.stream_k_matmul_ref(a, b, **kw),
                 "memset": R_mod.stream_k_matmul_ref(a, b, **kw),
                 "nohints": R_mod.stream_k_matmul_ref(a, b, **kw),
                 "flat": R_mod.gemm_stream_k_ref(a, b, **kw)}
        for name, lib in libs.items():
            cnt.zero_()   # a variant that is not checked may leave them dirty
            K_mod._build._LIBS["gemm_stream_k"] = lib
            one(a, b)
            err = (check(c, plain[name], a, b, f"stream_k_matmul ({name})")
                   if name in CHECKED else None)
            times[name] = dict(err=err, ms=[])
        for name in ["tree", *names, *names[::-1], "tree"]:
            cnt.zero_()
            K_mod._build._LIBS["gemm_stream_k"] = libs[name]
            times[name]["ms"].append(device_ms(rotating(one, sets)))
        K_mod._build._LIBS["gemm_stream_k"] = libs["tree"]
        emit("counters left nonzero by the tree", [int((cnt != 0).sum())])
        emit("zero_ of the counters (a fill kernel)", [device_ms(cnt.zero_)])
        for name, t in times.items():
            emit(f"one launch, {name}", t["ms"], max_abs_err=t["err"],
                 runs_of=int(geo.counts.max()) if name == "flat" else runs)
    else:
        p = torch.empty((geo.slots, M, N), device="cuda")
        counts = torch.from_numpy(geo.counts).to("cuda")
        c = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
        fix = dict(bm=geo.rows, bn=geo.cols, dtype=torch.bfloat16)

        def walk(x, y):
            K_mod.stream_k_partials(x, y, grid_g=G, out=p)

        def fixup():
            K_mod.stream_k_fixup(counts, p, out=c, **fix)

        def pair(x, y):
            walk(x, y)
            fixup()

        pair(a, b)
        err = check(c, R_mod.gemm_stream_k_ref(a, b, **kw), a, b, "walk + fixup")
        for name, fn in (("pair", rotating(pair, sets)), ("walk", rotating(walk, sets)),
                         ("fixup", fixup), ("pair", rotating(pair, sets))):
            times.setdefault(name, []).append(device_ms(fn))
        for name, ms in times.items():
            emit(f"two launches: {name}", ms,
                 **({"max_abs_err": err} if name == "pair" else {}))
    emit("torch.matmul", [device_ms(rotating(torch.matmul, sets))])
    return 0


if __name__ == "__main__":
    sys.exit(main())
