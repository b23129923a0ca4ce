#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # one NVIDIA H100; builds the kernels

Phases, each fatal on failure (nothing here catches an error):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port compiled with ``nvcc``, one
   process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs — a few dozen small cases with ragged M/N/K (and, for the
   single GEMM and the split-K and Stream-K kernels, every ``ta``/``tb``
   layout; split 2-8 with wholly empty slices, Stream-K with G from 1 to
   more workgroups than MAC iterations), then the serving path's shapes,
   where the kernel, its plain version and the one PyTorch call computing
   the same function are timed with CUDA events;
4. per-class serving: a full-width, full-depth Qwen3-14B weight set (40
   layers × the four fused bf16 decode GEMMs, ~26.4 GB, random from a
   seed) served through the port's `Runtime` to tenants at batches
   [8, 8, 8, 8] (grouped launches) and [4, 8, 8, 8, 16] (ragged
   launches), each window run twice (cold plan cache, then warm); every
   result is held against the plain version, and the launch counters,
   zeroed just before the first window, must show the single, grouped
   and ragged kernels;
5. bundle (mixed) serving: the fused weights freed, the seven unfused
   decode GEMMs of every layer (q, k, v, o, gate, up, down; the same
   26.4 GB) submitted per tenant and layer as one bundle
   (`Runtime.submit(sequence)`), flushed per layer, in three windows —
   one tenant at batch 1 with 16 slots available, tenants [4, 8, 8, 16]
   with 4, and the same with 2 — each cold then warm, plus one planned
   mixed schedule that carries Stream-K members; every result is held
   against the plain version, and the counters, zeroed before the first
   of these windows, must show the single, split-K partial and reduce,
   and Stream-K walk and fixup kernels.  Then each warm window's
   launches run again, concurrently on streams, back to back on one
   stream at the same tiles, and back to back at the isolated tiles,
   each timed on the card: the concurrent-versus-sequential ratios are
   printed, not gated; and each window runs once more under the
   profiler;
6. one JSON line ``{"kernels": [...]}`` and, last, the device line.

Tolerance of every comparison of a GEMM or of partials (float32, kernel
vs plain version on the same inputs): |kernel − plain| ≤ 2⁻⁷·|plain| +
2⁻¹⁶·(|A|·|B|), with |A|·|B| over the same K range.  The first term is
the bf16 output rounding: both sides round an f32 sum to 8 significant
bits once, and two sums a hair apart may land one bf16 ulp (≤ 2⁻⁸
relative, 2⁻⁷ just below a power of two) apart; it is 0 for f32 outputs.
The second is the f32 summation-order difference, which grows with K:
the kernel sums 16-wide tensor-core products in K order, the plain
version in cuBLAS's order, each add rounding at 2⁻²⁴ of its partial sum;
at random signs these errors add like a random walk, ~√K·2⁻²⁴·Σ|a·b| ≤
2⁻¹⁶·Σ|a·b| for K ≤ 2¹⁶.  A dropped or doubled k tile or a wrong group
moves the result by far more.  The reduce and the fixup must equal their
plain versions exactly: both add the same f32 partials in slot order and
round once.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from collections import Counter
from dataclasses import replace
from itertools import cycle
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    Schedule,
    execute_schedule,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gemm import (  # noqa: E402
    TileConfig,
    gemm,
    gemm_ref,
    splitk_partials_ref,
    splitk_reduce_ref,
    stream_k_fixup_ref,
    stream_k_partials_ref,
)
from repro_torch.kernels.gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.gemm.ref import element_counts  # noqa: E402
from repro_torch.kernels.grouped_gemm import (  # noqa: E402
    grouped_gemm_ref,
    ragged_gemm_ref,
)
from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel  # noqa: E402
from repro_torch.kernels.grouped_gemm.ops import block_groups  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    Runtime,
    RuntimeConfig,
    decode_step_descs,
    decode_step_requests,
)

SEED = 0
# H100 SXM data-sheet peaks (dense): HBM bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPLACES = {
    "matmul": "src/repro/kernels/gemm/kernel.py:45 _matmul_kernel",
    "splitk_partials": "src/repro/kernels/gemm/kernel.py:65 _matmul_splitk_kernel",
    "splitk_reduce": "src/repro/kernels/gemm/kernel.py:86 _reduce_kernel",
    "stream_k_partials": "src/repro/kernels/gemm/kernel.py:215 _stream_k_kernel",
    "stream_k_fixup": "src/repro/kernels/gemm/kernel.py:247 _stream_k_fixup_kernel",
    "grouped_matmul": "src/repro/kernels/grouped_gemm/kernel.py:41 _grouped_kernel",
    "ragged_matmul": "src/repro/kernels/grouped_gemm/kernel.py:93 _ragged_kernel",
}
SOURCES = {
    "matmul": "src/repro_torch/csrc/gemm.cu",
    "splitk_partials": "src/repro_torch/csrc/gemm_split_k.cu",
    "splitk_reduce": "src/repro_torch/csrc/gemm_split_k.cu",
    "stream_k_partials": "src/repro_torch/csrc/gemm_stream_k.cu",
    "stream_k_fixup": "src/repro_torch/csrc/gemm_stream_k.cu",
    "grouped_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
    "ragged_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
}
LAUNCHERS = {
    "matmul": gemm_kernel.matmul,
    "splitk_partials": gemm_kernel.splitk_partials,
    "splitk_reduce": gemm_kernel.splitk_reduce,
    "stream_k_partials": gemm_kernel.stream_k_partials,
    "stream_k_fixup": gemm_kernel.stream_k_fixup,
    "grouped_matmul": grouped_kernel.grouped_matmul,
    "ragged_matmul": grouped_kernel.ragged_matmul,
}
# Kernels each serving path must launch at least once.
PER_CLASS_KERNELS = ("matmul", "grouped_matmul", "ragged_matmul")
MIXED_KERNELS = ("matmul", "splitk_partials", "splitk_reduce",
                 "stream_k_partials", "stream_k_fixup")
LAYOUTS = ((False, False), (False, True), (True, False), (True, True))
SLEEP_CYCLES = 500_000_000   # ~0.25 s of the card's clock: time to queue work


# ---------------------------------------------------------------- helpers
def check_close(out, ref, a_abs_b_abs, what: str) -> float:
    """Hold ``out`` to ``ref`` (same shape, finite) within the module's
    stated tolerance; returns the max absolute error."""
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{what}: non-finite output")
    rel = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 0.0
    err = (o - r).abs()
    tol = rel * r.abs() + 2.0 ** -16 * a_abs_b_abs
    if bool((err > tol).any()):
        i = int((err - tol).argmax())
        raise AssertionError(
            f"{what}: max |err| {err.max().item():.4g}, worst element "
            f"{i} err {err.flatten()[i].item():.4g} > tol {tol.flatten()[i].item():.4g}")
    return float(err.max())


def abs_product(a, b):
    """|A|·|B| in f32, batched when the operands are."""
    return torch.matmul(a.float().abs(), b.float().abs())


def time_ms(fn, reps: int = 20, warmup: int = 3, queued: bool = True) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls
    (`rotating` makes each call take the next operand set).  ``queued``:
    the calls are queued behind a sleep of the card (`device_s`), so a
    kernel shorter than its launch's host cost is timed on the card, not
    at the host's launch rate; a function that waits for the card itself
    (a device-to-host read) passes False and is timed as it runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        t = device_s(lambda: [fn() for _ in range(reps)])
        if t is not None:
            return t * 1e3 / reps
        print("# note: a timed call waits for the card; timed as it runs")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_s(enqueue):
    """Device time (s) of everything ``enqueue`` queues, with no host gaps:
    the card first sleeps while the host queues the work, and CUDA events
    time the work from the sleep's end.  When queueing outlasts the sleep,
    the sleep grows fourfold and the run repeats, at most twice; then None
    (the work waits for the card itself)."""
    cycles = SLEEP_CYCLES
    for _ in range(3):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        h0 = time.perf_counter()
        enqueue()
        host = time.perf_counter() - h0
        ev[2].record()
        ev[2].synchronize()
        slept = ev[0].elapsed_time(ev[1]) / 1e3
        if host < slept:
            return ev[1].elapsed_time(ev[2]) / 1e3
        cycles *= 4
    return None


def rotating(fn, sets):
    """``fn`` as a no-argument call that takes the next of ``sets`` (tuples
    of arguments) each time: operand sets together beyond the 50 MB L2
    make every call read its operands from HBM."""
    it = cycle(sets)
    return lambda: fn(*next(it))


def randn(shape, gen, dtype=torch.bfloat16, scale: float = 1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    return x.mul_(scale) if scale != 1.0 else x


def bound(bytes_: int, flops: int, dtype) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over HBM rate vs operations
    over the dtype's peak, whichever is larger."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


# ------------------------------------------------------------------ build
def build_phase() -> None:
    t0 = time.perf_counter()
    paths = _build.build()
    secs = time.perf_counter() - t0
    print(f"# build: {sorted(p.name for p in paths.values())} in {secs:.1f} s")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        text = log.read_text() if log.exists() else ""
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", text))
        if regs:
            print(f"#   {name}.cu: {len(regs)} kernels, registers ≤ {max(regs)}, "
                  f"static smem ≤ {max(smem)} B, spill stores {spills} B")


# ---------------------------------------------------------------- kernels
def small_cases(gen) -> int:
    """Ragged shapes in every layout and type, against the plain versions."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (M, N, K) in ((1, 1, 1), (5, 70, 33), (16, 64, 128), (17, 129, 300),
                          (70, 200, 257), (130, 65, 64)):
            for ta in (False, True):
                for tb in (False, True):
                    bm = 8 if (M + K) % 2 else 64
                    a = randn((K, M) if ta else (M, K), gen, dtype)
                    b = randn((N, K) if tb else (K, N), gen, dtype)
                    out = gemm_kernel.matmul(a, b, ta=ta, tb=tb, bm=bm)
                    a_, b_ = (a.T if ta else a), (b.T if tb else b)
                    check_close(out, gemm_ref(a, b, ta=ta, tb=tb),
                                abs_product(a_, b_),
                                f"matmul {M}x{N}x{K} ta{ta:d} tb{tb:d} {dtype}")
                    n += 1
        for (G, M, N, K, bm) in ((1, 3, 10, 7, 8), (3, 16, 64, 128, 16),
                                 (4, 9, 130, 200, 8), (2, 70, 100, 96, 64)):
            a = randn((G, M, K), gen, dtype)
            b = randn((G, K, N), gen, dtype)
            out = grouped_kernel.grouped_matmul(a, b, bm=bm)
            check_close(out, grouped_gemm_ref(a, b), abs_product(a, b),
                        f"grouped G{G} {M}x{N}x{K} bm{bm} {dtype}")
            n += 1
        for (sizes, N, K, bm) in (([8, 8], 64, 64, 8), ([16, 0, 32], 100, 130, 16),
                                  ([8, 24, 8, 8], 65, 257, 8),
                                  ([32, 64], 70, 96, 32), ([128, 256], 64, 80, 128)):
            G, Mtotal = len(sizes), sum(sizes)
            a = randn((Mtotal, K), gen, dtype)
            b = randn((G, K, N), gen, dtype)
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            bg = block_groups(gs, -(-Mtotal // bm), bm, G)
            out = grouped_kernel.ragged_matmul(a, b, bg, bm=bm)
            check_close(out, ragged_gemm_ref(a, b, gs), ragged_abs(a, b, gs),
                        f"ragged {sizes} N{N} K{K} bm{bm} {dtype}")
            n += 1
    return n


def ragged_abs(a, b, group_sizes):
    """|A|·|B[g]| row by row, in f32 (the ragged tolerance's scale)."""
    return ragged_gemm_ref(a.float().abs(), b.float().abs(), group_sizes)


def main_path_kernels(gen) -> dict:
    """The serving path's shapes: compare, then time kernel, plain version
    and the PyTorch call computing the same function.  Every operand set
    holds ≥ 178 MB of weights, beyond the 50 MB L2, so each timed call
    streams its weights from HBM."""
    rows = {}
    bf16 = torch.bfloat16

    # single: the fused FFN gate+up of one tenant at batch 8
    M, N, K = 8, 34816, 5120
    a, b = randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5)
    out = gemm_kernel.matmul(a, b, bm=8)
    err = check_close(out, gemm_ref(a, b), abs_product(a, b), "matmul main")
    rows["matmul"] = dict(
        shape=f"{M}x{N}x{K}", instantiation=gemm_kernel.instantiation(bf16, 8),
        max_abs_err=err,
        ms=time_ms(lambda: gemm_kernel.matmul(a, b, bm=8)),
        plain_ms=time_ms(lambda: gemm_ref(a, b), reps=5),
        library_ms=time_ms(lambda: torch.matmul(a, b)),
        bound=bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf16))

    # grouped: four tenants' ffn-down at batch 8
    G, M, N, K = 4, 8, 5120, 17408
    a, b = randn((G, M, K), gen), randn((G, K, N), gen, scale=K ** -0.5)
    out = grouped_kernel.grouped_matmul(a, b, bm=8)
    err = check_close(out, grouped_gemm_ref(a, b), abs_product(a, b),
                      "grouped main")
    rows["grouped_matmul"] = dict(
        shape=f"G{G} {M}x{N}x{K}",
        instantiation=gemm_kernel.instantiation(bf16, 8),
        max_abs_err=err,
        ms=time_ms(lambda: grouped_kernel.grouped_matmul(a, b, bm=8)),
        plain_ms=time_ms(lambda: grouped_gemm_ref(a, b), reps=5),
        library_ms=time_ms(lambda: torch.bmm(a, b)),
        bound=bound(G * (M * K + K * N + M * N) * 2, 2 * G * M * N * K, bf16))
    # The scheduler's torch.stack of the members' B for such a launch.
    ws = [b[g].clone() for g in range(G)]
    stack_ms = time_ms(lambda: torch.stack(ws), reps=5)
    stack_gb = G * K * N * 2 / 1e9
    print(f"# stack copy of B for a grouped ffn-down launch (G={G}, "
          f"{stack_gb:.3f} GB): {stack_ms:.4f} ms")
    del ws

    # ragged: five tenants' ffn-down at batches [16, 8, 8, 8, 4], bm = 16
    sizes, bm, N, K = [16, 8, 8, 8, 4], 16, 5120, 17408
    padded = [-(-s // bm) * bm for s in sizes]
    G, Mtotal = len(sizes), sum(padded)
    a = torch.zeros((Mtotal, K), dtype=bf16, device="cuda")
    off = 0
    for s, p in zip(sizes, padded):
        a[off:off + s] = randn((s, K), gen)
        off += p
    b = randn((G, K, N), gen, scale=K ** -0.5)
    gs = torch.tensor(padded, dtype=torch.int32, device="cuda")
    bg = block_groups(gs, Mtotal // bm, bm, G)
    out = grouped_kernel.ragged_matmul(a, b, bg, bm=bm)
    err = check_close(out, ragged_gemm_ref(a, b, gs), ragged_abs(a, b, gs),
                      "ragged main")
    # The padded members are all bm rows, so one bmm computes the same
    # function on these inputs.
    rows["ragged_matmul"] = dict(
        shape=f"sizes {sizes} (padded to {bm}) N{N} K{K}",
        instantiation=gemm_kernel.instantiation(bf16, bm),
        max_abs_err=err,
        ms=time_ms(lambda: grouped_kernel.ragged_matmul(a, b, bg, bm=bm)),
        plain_ms=time_ms(lambda: ragged_gemm_ref(a, b, gs), reps=5, queued=False),
        library_ms=time_ms(lambda: torch.bmm(a.view(G, bm, K), b)),
        bound=bound((Mtotal * K + G * K * N + Mtotal * N) * 2,
                    2 * Mtotal * N * K, bf16))
    for name, r in rows.items():
        print(f"# {name:<15} {r['shape']:<40} [{r['instantiation']}] kernel "
              f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} | torch "
              f"{r['library_ms']:.4f} | bound {r['bound'][0]:.4f} "
              f"({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


# ------------------------------------------------- split-K and Stream-K
SPLIT_CASES = (  # M, N, K, bm, bk, split_k
    (5, 70, 600, 8, 128, 4),       # ⌈K/bk⌉ = 5 at split 4: slot 3 is empty
    (1, 130, 1100, 8, 128, 8),     # 9 k blocks at split 8: slots 5-7 empty
    (16, 64, 257, 16, 128, 2),
    (17, 200, 4096, 32, 128, 4),
    (70, 129, 300, 64, 64, 3),
    (8, 300, 1000, 8, 256, 8),     # 4 k blocks: the split drops to 4
)
STREAM_CASES = (  # M, N, K, bm, bn, bk, G
    (5, 70, 600, 8, 128, 128, 1),
    (13, 70, 300, 8, 128, 128, 3),
    (33, 200, 520, 16, 128, 128, 5),
    (16, 256, 1024, 8, 128, 256, 7),
    (70, 129, 1000, 64, 256, 128, 8),
    (100, 300, 700, 128, 128, 256, 40),   # G above the 9 MAC iterations
    (3, 40, 50, 16, 32, 16, 1000),        # tile narrower than a CTA, bk 16
)


def op_abs(a, b, ta, tb):
    """|op(a)|, |op(b)| in f32: the tolerance's scale, fed to a plain
    version to get |A|·|B| over exactly that version's K ranges."""
    return ((a.T if ta else a).float().abs(), (b.T if tb else b).float().abs())


def check_equal(out, ref, what: str) -> float:
    if out.shape != ref.shape or out.dtype != ref.dtype or not torch.equal(out, ref):
        err = (out.float() - ref.float()).abs().max().item() if \
            out.shape == ref.shape else float("nan")
        raise AssertionError(f"{what}: not equal to the plain version (max |err| {err})")
    return 0.0


def split_stream_cases(gen) -> int:
    """The split-K and Stream-K kernels against their own plain versions:
    partials (Stream-K: the written slots only), then the reduce and the
    fixup on the kernels' own partials, then `gemm` end to end."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (M, N, K, bm, bk, split_k), (ta, tb) in zip(SPLIT_CASES, cycle(LAYOUTS)):
            what = f"split-K {M}x{N}x{K} bm{bm} bk{bk} s{split_k} ta{ta:d} tb{tb:d} {dtype}"
            a = randn((K, M) if ta else (M, K), gen, dtype)
            b = randn((N, K) if tb else (K, N), gen, dtype)
            split, slice_k = gemm_kernel.split_k_slices(K, bk, split_k)
            p = gemm_kernel.splitk_partials(a, b, ta=ta, tb=tb, bm=bm, split=split,
                                            slice_k=slice_k)
            kw = dict(split=split, slice_k=slice_k, bk=bk)
            aa, ab = op_abs(a, b, ta, tb)
            check_close(p, splitk_partials_ref(a, b, ta=ta, tb=tb, **kw),
                        splitk_partials_ref(aa, ab, **kw), what + " partials")
            check_equal(gemm_kernel.splitk_reduce(p, dtype),
                        splitk_reduce_ref(p, dtype), what + " reduce")
            check_close(gemm(a, b, ta=ta, tb=tb,
                             tile=TileConfig(bm, 128, bk, split_k=split_k)),
                        gemm_ref(a, b, ta=ta, tb=tb), aa @ ab, what + " gemm")
            n += 1
        for (M, N, K, bm, bn, bk, G), (ta, tb) in zip(STREAM_CASES, cycle(LAYOUTS)):
            what = f"Stream-K {M}x{N}x{K} {bm}x{bn}x{bk}g{G} ta{ta:d} tb{tb:d} {dtype}"
            a = randn((K, M) if ta else (M, K), gen, dtype)
            b = randn((N, K) if tb else (K, N), gen, dtype)
            tm, tn, tk = gemm_kernel.stream_k_tiles(M, N, K, bm, bn, bk)
            _, _, _, counts, slots = gemm_kernel.stream_k_geometry(tm, tn, tk, G)
            counts = torch.from_numpy(counts).to(a.device)
            kw = dict(bm=bm, bn=bn, bk=bk, grid_g=G)
            p = gemm_kernel.stream_k_partials(a, b, ta=ta, tb=tb, **kw)
            written = torch.arange(slots, device=a.device)[:, None, None] < \
                element_counts(counts, M, N, bm, bn)[None]
            aa, ab = op_abs(a, b, ta, tb)
            check_close(torch.where(written, p, 0.0),
                        stream_k_partials_ref(a, b, ta=ta, tb=tb, **kw),
                        stream_k_partials_ref(aa, ab, **kw), what + " partials")
            check_equal(gemm_kernel.stream_k_fixup(counts, p, bm=bm, bn=bn, dtype=dtype),
                        stream_k_fixup_ref(counts, p, bm=bm, bn=bn, dtype=dtype),
                        what + " fixup")
            check_close(gemm(a, b, ta=ta, tb=tb, tile=TileConfig(bm, bn, bk, stream_k=G)),
                        gemm_ref(a, b, ta=ta, tb=tb), aa @ ab, what + " gemm")
            n += 1
    return n


def split_stream_kernels(gen) -> dict:
    """The mixed path's split-K shapes (Qwen3-14B ffn-down, 5120×17408
    bf16: 178 MB of weights, beyond the 50 MB L2) and the Stream-K shape
    the planner gives a 32×512×17408 member at CD 6-8 (17.8 MB of
    weights: four operand sets rotate, 71 MB together).  Each kernel,
    its plain version and the PyTorch call beside it are timed on the
    same inputs.  The reduce and the fixup read partials of well under
    1 MB, which sit in L2 on the path too (written just before)."""
    rows = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for (M, N, K, split_k) in ((8, 5120, 17408, 4), (1, 5120, 17408, 8)):
        a, b = randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5)
        tile = TileConfig(8, 128, 128, split_k=split_k)
        split, slice_k = gemm_kernel.split_k_slices(K, tile.bk, split_k)
        kw = dict(split=split, slice_k=slice_k)
        p = gemm_kernel.splitk_partials(a, b, bm=8, **kw)
        p_ref = splitk_partials_ref(a, b, bk=tile.bk, **kw)
        err = check_close(p, p_ref, splitk_partials_ref(a.float().abs(), b.float().abs(),
                                                        bk=tile.bk, **kw),
                          f"splitk_partials {M}x{N}x{K}s{split}")
        shape = f"{M}x{N}x{K} at {tile.key()}"
        row = dict(
            shape=shape, instantiation=gemm_kernel.instantiation(bf16, 8),
            max_abs_err=err,
            ms=time_ms(lambda: gemm_kernel.splitk_partials(a, b, bm=8, out=p, **kw)),
            plain_ms=time_ms(lambda: splitk_partials_ref(a, b, bk=tile.bk, **kw),
                             reps=3, warmup=1),
            library_ms=time_ms(lambda: torch.matmul(a, b)),
            bound=bound((M * K + K * N) * 2 + split * M * N * 4, 2 * M * N * K, bf16))
        rows.setdefault("splitk_partials", []).append(row)
        out = gemm_kernel.splitk_reduce(p, bf16)
        err = check_equal(out, splitk_reduce_ref(p, bf16), f"splitk_reduce {shape}")
        c = torch.empty_like(out)
        row = dict(
            shape=f"{split}x{M}x{N} f32 partials -> bf16 ({shape})",
            instantiation="256 threads, grid-stride", max_abs_err=err,
            ms=time_ms(lambda: gemm_kernel.splitk_reduce(p, bf16, out=c)),
            plain_ms=time_ms(lambda: splitk_reduce_ref(p, bf16), reps=5),
            library_ms=time_ms(lambda: p.sum(0).to(bf16)),
            bound=bound(split * M * N * 4 + M * N * 2, split * M * N, f32))
        rows.setdefault("splitk_reduce", []).append(row)
        del a, b, p, p_ref

    M, N, K, G = 32, 512, 17408, 8
    tile = TileConfig(32, 128, 128, stream_k=G)
    kw = dict(bm=tile.bm, bn=tile.bn, bk=tile.bk, grid_g=G)
    sets = [(randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5)) for _ in range(4)]
    a, b = sets[0]
    tm, tn, tk = gemm_kernel.stream_k_tiles(M, N, K, tile.bm, tile.bn, tile.bk)
    _, _, _, counts_np, slots = gemm_kernel.stream_k_geometry(tm, tn, tk, G)
    counts = torch.from_numpy(counts_np).to(a.device)
    written = element_counts(counts, M, N, tile.bm, tile.bn)
    mask = torch.arange(slots, device=a.device)[:, None, None] < written[None]
    p = gemm_kernel.stream_k_partials(a, b, **kw)
    err = check_close(torch.where(mask, p, 0.0), stream_k_partials_ref(a, b, **kw),
                      stream_k_partials_ref(a.float().abs(), b.float().abs(), **kw),
                      "stream_k_partials main")
    part_bytes = int(written.sum()) * 4          # the slots this walk writes
    shape = f"{M}x{N}x{K} at {tile.key()}"
    rows["stream_k_partials"] = [dict(
        shape=shape, instantiation=gemm_kernel.instantiation(bf16, tile.bm),
        max_abs_err=err,
        ms=time_ms(rotating(lambda x, y: gemm_kernel.stream_k_partials(x, y, out=p, **kw),
                            sets)),
        plain_ms=time_ms(lambda: stream_k_partials_ref(a, b, **kw), reps=3, warmup=1,
                         queued=False),   # 544 launches a call: more than the queue holds
        library_ms=time_ms(rotating(torch.matmul, sets)),
        bound=bound((M * K + K * N) * 2 + part_bytes, 2 * M * N * K, bf16))]
    out = gemm_kernel.stream_k_fixup(counts, p, bm=tile.bm, bn=tile.bn, dtype=bf16)
    err = check_equal(out, stream_k_fixup_ref(counts, p, bm=tile.bm, bn=tile.bn,
                                              dtype=bf16), "stream_k_fixup main")
    c = torch.empty_like(out)
    rows["stream_k_fixup"] = [dict(
        shape=f"{slots}x{M}x{N} f32 partials -> bf16 ({shape})",
        instantiation="256 threads, grid-stride", max_abs_err=err,
        ms=time_ms(lambda: gemm_kernel.stream_k_fixup(counts, p, bm=tile.bm, bn=tile.bn,
                                                      dtype=bf16, out=c)),
        plain_ms=time_ms(lambda: stream_k_fixup_ref(counts, p, bm=tile.bm, bn=tile.bn,
                                                    dtype=bf16), reps=5),
        library_ms=time_ms(lambda: p.sum(0).to(bf16)),
        bound=bound(part_bytes + counts.numel() * 4 + M * N * 2, part_bytes // 4, f32))]
    for name, rs in rows.items():
        for r in rs:
            print(f"# {name:<17} {r['shape']:<52} kernel {r['ms']:.4f} ms | plain "
                  f"{r['plain_ms']:.4f} | torch {r['library_ms']:.4f} | bound "
                  f"{r['bound'][0]:.6f} ({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


# ---------------------------------------------------------------- serving
def make_weights(cfg, layers: int, gen, device) -> list:
    """Per layer, the four decode GEMMs' weights keyed by (K, N): fused
    QKV, attention-out, fused FFN gate+up and FFN down, stored (K, N)."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = [(D, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
              (cfg.n_heads * hd, D), (D, 2 * cfg.d_ff), (cfg.d_ff, D)]
    out = []
    for _ in range(layers):
        out.append({
            (k, n): torch.randn((k, n), generator=gen, device=device,
                                dtype=torch.bfloat16).mul_(k ** -0.5)
            for k, n in shapes})
    return out


def drive_window(rt: Runtime, cfg, weights: list, batches, gen):
    """Every tenant submits one decode step of every layer with its own
    activations, and the runtime drains.  Returns the tickets, the wall
    time up to the last result being ready, the window's launch records
    and its launches."""
    t0 = time.perf_counter()
    n0 = len(rt.telemetry.groups)
    tickets = []
    for wl in weights:
        for ti, batch in enumerate(batches):
            for r in decode_step_requests(rt.ctrl, cfg, batch):
                d = r.desc
                a = torch.randn((d.M, d.K), generator=gen, device=rt.device,
                                dtype=torch.bfloat16)
                tickets.append(rt.submit(
                    GemmRequest(desc=d, a=a, b=wl[(d.K, d.N)], tag=r.tag),
                    tenant=f"tenant{ti}"))
    launches = rt.drain()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    return tickets, time.perf_counter() - t0, rt.telemetry.groups[n0:], launches


def serve_window(rt: Runtime, cfg, weights: list, batches, gen) -> dict:
    """`drive_window`, then every result held against the plain version."""
    tickets, wall, recs, launches = drive_window(rt, cfg, weights, batches, gen)
    for tk in tickets:
        r = tk.request
        check_close(tk.result, gemm_ref(r.a, r.b), abs_product(r.a, r.b),
                    f"ticket {tk.seq} {r.desc.key()} ({tk.plan.mode})")
    req_bytes = sum(tk.request.b.numel() * 2 for tk in tickets)
    modes = Counter(g.mode for g in recs)
    tiles = Counter(f"{KERNEL_OF_MODE[ln.plan.mode]} "
                    f"{gemm_kernel.instantiation(torch.bfloat16, ln.plan.tile.bm)}"
                    for ln in launches)
    return dict(requests=len(tickets), launches=dict(modes), tiles=tiles,
                wall_s=wall,
                device_s=sum(g.achieved_time_s or 0.0 for g in recs),
                request_weight_gb=req_bytes / 1e9)


KERNEL_OF_MODE = {"single": "matmul", "grouped": "grouped_matmul",
                  "ragged": "ragged_matmul"}
KERNEL_KINDS = (("matmul_kernel", "matmul"), ("grouped_kernel", "grouped_matmul"),
                ("splitk_kernel", "splitk_partials"),
                ("repro::reduce_kernel", "splitk_reduce"),
                ("stream_k_kernel", "stream_k_partials"),
                ("fixup_kernel", "stream_k_fixup"),
                ("ragged_kernel", "ragged_matmul"), ("Cat", "stack/cat copy"),
                ("reduce", "isfinite checks"))


def profile_window(label: str, drive) -> None:
    """One more warm window under `torch.profiler` (``drive`` runs it and
    returns its wall time): device time by kernel kind, and the device's
    busy and idle shares of the window's wall time.  Busy time is the
    union of the kernels' intervals, so kernels that overlap on streams
    count once; the profiler's own overhead lengthens the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = drive()
    by_kind, total = {}, 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        total += us
        kind = next((k for pat, k in KERNEL_KINDS if pat in evt.key), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    if total == 0.0:
        print(f"# profiled {label}: the profiler recorded no device time "
              "(per-launch CUDA-event times are above)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / total:.1%})"
                      for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]))
    print(f"# profiled {label}: wall {wall:.6f} s, kernel time {total / 1e6:.6f} s, "
          f"device busy {busy / 1e6:.6f} s (idle {1 - busy / 1e6 / wall:.1%}); {parts}")


def serving_phase(device="cuda", cfg=None, layers=None) -> dict:
    cfg = cfg or get_arch("qwen3-14b")
    layers = layers or cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(SEED)
    weights = make_weights(cfg, layers, gen, device)
    model_gb = sum(w.numel() * 2 for wl in weights for w in wl.values()) / 1e9
    print(f"# serving {cfg.name}: {layers} layers, weights {model_gb:.2f} GB "
          f"on {device}")
    rt = Runtime(ConcurrencyController(),
                 RuntimeConfig(window_s=0.0, execute=True), device=device)
    reset_counts()
    windows = []
    for batches in ([8, 8, 8, 8], [4, 8, 8, 8, 16]):
        for run in ("cold", "warm"):
            w = serve_window(rt, cfg, weights, batches, gen)
            windows.append(w)
            print(f"# window batches {batches} ({run} plans): {w['requests']} "
                  f"requests, launches {w['launches']}, wall {w['wall_s']:.6f} s, "
                  f"device {w['device_s']:.6f} s, "
                  f"{w['request_weight_gb'] / w['wall_s']:.1f} request-weight GB/s, "
                  f"{model_gb / w['wall_s']:.1f} model-weight GB/s")
    counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
    modes = rt.telemetry.mode_counts()
    print(f"# serving modes {modes}; kernel launches {counts}")
    missing = [k for k in PER_CLASS_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the per-class serving path never launched {missing}")
    tiles = sum((w["tiles"] for w in windows), Counter())
    print(f"# serving CTA tiles (kernel, instantiation): {dict(tiles)}")
    if not {"grouped", "ragged"} <= set(modes) or not (
            modes.get("single", 0) + modes.get("fused", 0)):
        raise AssertionError(f"serving did not run every launch mode: {modes}")
    if device == "cuda":
        for batches in ([8, 8, 8, 8], [4, 8, 8, 8, 16]):
            profile_window(f"window batches {batches}", lambda: drive_window(
                rt, cfg, weights, batches, gen)[1])
    return dict(counts=counts, windows=windows, model_gb=model_gb)


# --------------------------------------------------------- bundle serving
MIXED_WINDOWS = (([1], 16), ([4, 8, 8, 16], 4), ([4, 8, 8, 16], 2))
# Members of mixed launches queued at once behind one sleep of the card:
# a whole batch-1 window (280 members: 320 kernels and ~900 stream
# events) fits in the launch queue; a 1,120-member window does not.
QUEUED_MEMBERS = 200


def unfused_descs(cfg, batch: int) -> list:
    """One layer's seven unfused decode GEMMs (q, k, v, o, gate, up,
    down): `decode_step_descs` flattened."""
    return [d for _, bundle in decode_step_descs(cfg, batch) for d in bundle]


def make_unfused_weights(cfg, layers: int, gen, device) -> list:
    """Per layer, the weights of `unfused_descs` in order, stored (K, N)."""
    shapes = [(d.K, d.N) for d in unfused_descs(cfg, 1)]
    return [[torch.randn((k, n), generator=gen, device=device,
                         dtype=torch.bfloat16).mul_(k ** -0.5) for k, n in shapes]
            for _ in range(layers)]


def decomposition(desc, tile) -> str:
    """Which kernels a member at ``tile`` runs."""
    if tile.stream_k:
        return f"Stream-K g{tile.stream_k}"
    split, _ = gemm_kernel.split_k_slices(desc.K, tile.bk, tile.split_k)
    return f"split-K s{split}" if split > 1 else "matmul"


def check_tickets(tickets) -> None:
    for tk in tickets:
        r = tk.request
        check_close(tk.result, gemm_ref(r.a, r.b), abs_product(r.a, r.b),
                    f"ticket {tk.seq} {r.desc.key()} ({tk.plan.mode})")


def drive_bundles(rt: Runtime, cfg, weights: list, batches, gen):
    """Per layer, every tenant submits its seven decode GEMMs as one bundle
    with its own activations, and the runtime drains: one flush per
    layer.  Returns the bundle tickets, the wall time up to the last
    result being ready, the window's launch records and its launches."""
    t0 = time.perf_counter()
    n0 = len(rt.telemetry.groups)
    handles, launches = [], []
    for wl in weights:
        for ti, batch in enumerate(batches):
            reqs = [GemmRequest(desc=d, b=w, a=torch.randn(
                (d.M, d.K), generator=gen, device=rt.device, dtype=torch.bfloat16))
                for d, w in zip(unfused_descs(cfg, batch), wl)]
            handles.append(rt.submit(reqs, tenant=f"tenant{ti}"))
        launches += rt.drain()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, rt.telemetry.groups[n0:], launches


def mixed_window(rt: Runtime, cfg, weights: list, batches, gen) -> dict:
    """`drive_bundles`, then every result held against the plain version."""
    handles, wall, recs, launches = drive_bundles(rt, cfg, weights, batches, gen)
    if not all(h.done for h in handles):
        raise AssertionError("a bundle was left unfinished")
    tickets = [m for h in handles for m in h.members]
    check_tickets(tickets)
    members = Counter(decomposition(tk.desc, t) for ln in launches
                      for tk, t in zip(ln.tickets, ln.plan.tiles or [ln.plan.tile]))
    return dict(requests=len(tickets), launches=dict(Counter(g.mode for g in recs)),
                members=dict(members), wall_s=wall,
                device_s=sum(g.achieved_time_s or 0.0 for g in recs),
                request_weight_gb=sum(tk.request.b.numel() * 2 for tk in tickets) / 1e9,
                launch_list=launches)


def stream_k_schedule(rt: Runtime, gen) -> None:
    """One mixed schedule the planner makes for a bundle of four
    32×512×17408 GEMMs and three 1×5120×17408 ones: a CD-7 group whose
    members run Stream-K (32x128x128g8) and split-K tiles at once."""
    descs = [GemmDesc(32, 512, 17408)] * 4 + [GemmDesc(1, 5120, 17408)] * 3
    sched = rt.ctrl.plan_mixed(descs, available=16)
    tiles = [t for g in sched.groups for t in (g.tiles or [g.tile])]
    if not any(t.stream_k for t in tiles) or sched.groups[0].mode != "mixed":
        raise AssertionError(f"the planner gave no mixed Stream-K member: {tiles}")
    reqs = [GemmRequest(desc=d, a=randn((d.M, d.K), gen),
                        b=randn((d.K, d.N), gen, scale=d.K ** -0.5)) for d in descs]
    for r, out in zip(reqs, execute_schedule(reqs, sched)):
        check_close(out, gemm_ref(r.a, r.b), abs_product(r.a, r.b),
                    f"mixed member {r.desc.key()}")
    print(f"# mixed Stream-K schedule: {[(g.mode, g.cd) for g in sched.groups]}, "
          f"member tiles {[t.key() for t in tiles]}")


def concurrency_ratio(launches, lib):
    """The window's launches again, (a) as planned — each mixed group's
    members at once on their streams, at their GO tiles — (b) the same
    members at the same tiles back to back on one stream, and (c) back to
    back at each member's isolated tile (the paper's sequential
    baseline), in turns a, b, c, c, b, a.  Each is timed in chunks of
    launches of at most `QUEUED_MEMBERS` members, every chunk queued
    behind a sleep of the card (`device_s`), and the chunks' times add.
    None when the host could not queue a chunk ahead of the card."""
    chunks, size = [[]], 0
    for ln in launches:
        reqs = [t.request for t in ln.tickets]
        if size + len(reqs) > QUEUED_MEMBERS and chunks[-1]:
            chunks.append([])
            size = 0
        size += len(reqs)
        chunks[-1].append((reqs, Schedule(groups=[replace(
            ln.plan, indices=list(range(len(reqs))))]),
            ln.plan.tiles or [ln.plan.tile] * len(reqs),
            [lib.get(r.desc).isolated for r in reqs]))

    def concurrent(units):
        for reqs, sched, _, _ in units:
            execute_schedule(reqs, sched)

    def back_to_back(units, isolated: bool):
        for reqs, _, go, iso in units:
            for r, t in zip(reqs, iso if isolated else go):
                gemm(r.a, r.b, ta=r.desc.ta, tb=r.desc.tb, tile=t)

    fns = dict(concurrent=concurrent,
               back_to_back=lambda units: back_to_back(units, False),
               isolated=lambda units: back_to_back(units, True))
    for fn in fns.values():     # warm: buffers and streams exist before timing
        fn(chunks[0])
    runs = {k: [] for k in fns}
    for k in ("concurrent", "back_to_back", "isolated", "isolated", "back_to_back",
              "concurrent"):
        total = 0.0
        for units in chunks:
            t = device_s(lambda: fns[k](units))
            if t is None:
                return None
            total += t
        runs[k].append(total)
    mean = {k: sum(v) / len(v) for k, v in runs.items()}
    return dict(concurrent_s=mean["concurrent"], back_to_back_s=mean["back_to_back"],
                isolated_s=mean["isolated"],
                ratio=mean["back_to_back"] / mean["concurrent"],
                isolated_ratio=mean["isolated"] / mean["concurrent"], runs=runs,
                chunks=len(chunks))


def mixed_phase(device="cuda", cfg=None, layers=None) -> dict:
    cfg = cfg or get_arch("qwen3-14b")
    layers = layers or cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    weights = make_unfused_weights(cfg, layers, gen, device)
    model_gb = sum(w.numel() * 2 for wl in weights for w in wl) / 1e9
    print(f"# bundle serving {cfg.name}: {layers} layers × 7 unfused GEMMs, weights "
          f"{model_gb:.2f} GB on {device}")
    rt = Runtime(ConcurrencyController(),
                 RuntimeConfig(window_s=0.0, execute=True), device=device)
    reset_counts()
    windows = []
    for batches, available in MIXED_WINDOWS:
        rt.set_available(available)
        for run in ("cold", "warm"):
            w = mixed_window(rt, cfg, weights, batches, gen)
            w.update(batches=batches, available=available, plans=run)
            windows.append(w)
            print(f"# bundle window batches {batches} available {available} ({run} "
                  f"plans): {w['requests']} requests, launches {w['launches']}, "
                  f"members {w['members']}, wall {w['wall_s']:.6f} s, device "
                  f"{w['device_s']:.6f} s, {w['request_weight_gb'] / w['wall_s']:.1f} "
                  f"request-weight GB/s, {model_gb / w['wall_s']:.1f} model-weight GB/s")
    stream_k_schedule(rt, torch.Generator(device=device).manual_seed(SEED + 2))
    counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
    print(f"# bundle serving modes {rt.telemetry.mode_counts()}; kernel launches {counts}")
    missing = [k for k in MIXED_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the bundle path never launched {missing}")
    if device == "cuda":
        for w in windows[1::2]:     # the warm windows
            r = w["ratio"] = concurrency_ratio(w["launch_list"], rt.ctrl.lib)
            what = (f"# warm window batches {w['batches']} available {w['available']}, "
                    f"{len(w['launch_list'])} launches")
            if r is None:
                print(f"{what}: concurrent vs back to back not measured (the host "
                      "could not queue a chunk ahead of the card)")
                continue
            print(f"{what}: concurrent on streams {r['concurrent_s']:.6f} s, back to "
                  f"back on one stream {r['back_to_back_s']:.6f} s (ratio "
                  f"{r['ratio']:.4f}), back to back at isolated tiles "
                  f"{r['isolated_s']:.6f} s (ratio {r['isolated_ratio']:.4f}), in "
                  f"{r['chunks']} queued chunks; runs {r['runs']}; the runtime's own "
                  f"fork-to-join times {w['device_s']:.6f} s")
        for batches, available in MIXED_WINDOWS:
            rt.set_available(available)
            profile_window(f"bundle window batches {batches} available {available}",
                           lambda: drive_bundles(rt, cfg, weights, batches, gen)[1])
    for w in windows:
        del w["launch_list"]
    return dict(counts=counts, windows=windows, model_gb=model_gb)


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    build_phase()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print(f"# kernels: {small_cases(gen)} small cases agree with their plain versions")
    print(f"# split-K and Stream-K kernels: {split_stream_cases(gen)} small cases "
          "agree with their plain versions")
    rows = {k: [r] for k, r in main_path_kernels(gen).items()}
    rows.update(split_stream_kernels(gen))
    torch.cuda.empty_cache()
    serving = serving_phase()
    gc.collect()
    torch.cuda.empty_cache()
    mixed = mixed_phase()
    kernels = []
    for name in LAUNCHERS:
        r, *more = rows[name]
        path = serving if name in PER_CLASS_KERNELS else mixed
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "shape": r["shape"],
            "instantiation": r["instantiation"], "launches": path["counts"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({"more_shapes": [{
                "shape": m["shape"], "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
                "bound_by": m["bound"][1], "library_ms": m["library_ms"]}
                for m in more]} if more else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
