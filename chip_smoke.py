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
   the same function are timed with CUDA events.  The Stream-K walk is
   held to its plain version at the card's geometry (`card_geometry`:
   CTA tiles from M, W workgroups from the planner's G, the SM count and
   the kernel's occupancy), and its grid and shared memory are printed;
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
6. attention and scan kernels: the flash-attention and chunked-scan
   kernels against their plain versions on small cases (GQA and MHA,
   causal with ``q_offset``, a window, S not a multiple of ``bkv``,
   prefill, dv ≠ dqk, strided q/k/v, bf16 and f32; T not a multiple of
   the chunk, chunks 8-512, a nonzero initial state, a head-broadcast
   B/C view), then timed at the path's shapes beside their plain
   versions and, for attention, PyTorch's
   ``scaled_dot_product_attention``: Qwen3-14B's tenant-16 member and
   its batch-1 member, each with its grid (CTAs, kv splits) and shared
   memory printed.  Two planted faults must fail the attention check:
   the kernel without one 64-key sub-tile (tenant 16), and the kernel's
   split partials merged without one split (batch 1, 16 splits; the same
   merge with every split must match the kernel's own output);
7. op-bundle serving: for Qwen3-14B (40 layers, context 4,096) and
   Zamba2-1.2B (38 layers, context 2,048), at full width, every layer's
   whole decode-step bundle (`decode_step_op_descs`: the GEMMs, the
   attention read over the KV cache, and for Zamba2 the SSD state update)
   submitted per tenant as one bundle and flushed per layer, with random
   bf16 weights, queries and KV caches from a seed; one tenant at batch 1
   with 16 slots, then tenants [4, 8, 8, 16] with 4, each cold then warm.
   Every result is held against its plain version, and the counters,
   zeroed before the phase, must show exactly one attention launch per
   attention member and one scan launch per scan member.  Each warm
   window is then timed concurrently and back to back (as in phase 5)
   and profiled once;
8. one JSON line ``{"kernels": [...]}`` and, last, the device line.

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

Attention and scan kernels are held to their plain versions computed
and kept in f32 on the same (exactly converted) inputs, within
|kernel − plain| ≤ tol + (tol + h)·|plain|: tol is the reference tests'
f32 tolerance (`tests/test_kernel_attention.py`: 2e-4;
`tests/test_kernel_mamba.py`: 3e-4), which covers the f32 summation
order, and h is, for a bf16 output, half a bf16 unit in the last place
(2⁻⁸) for the kernel's one rounding of its f32 result, else 0
(`flash_attention.ref.attention_tol`).  The reference tests' bf16
attention tolerance, 3e-2 + 3e-2·|plain|, is as large as a decode
output itself (~0.026 at 4,096 keys) and would pass a kernel that
skipped a 64-key sub-tile; the kernel phase shows that this one fails
such a kernel.
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
    AttentionDesc,
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    ScanDesc,
    Schedule,
    bind_operands,
    execute_schedule,
)
from repro_torch.core.library import default_library  # noqa: E402
from repro_torch.core.scheduler import _run_op  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_buffers,
    attention_tol,
    flash_attention_fwd,
    flash_combine_ref,
    flash_ref,
)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    kernel_resources,
    split_geometry,
    tma_loads,
    width_for,
)
from repro_torch.kernels.flash_attention.ops import attention_tiles  # noqa: E402
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
from repro_torch.kernels.mamba_scan import mamba_scan_fwd, ssd_chunk_ref  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import scan_chunk  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    Runtime,
    RuntimeConfig,
    decode_step_descs,
    decode_step_op_descs,
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
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:23 _flash_kernel",
    "mamba_scan": "src/repro/kernels/mamba_scan/kernel.py:24 _mamba_kernel",
}
SOURCES = {
    "matmul": "src/repro_torch/csrc/gemm.cu",
    "splitk_partials": "src/repro_torch/csrc/gemm_split_k.cu",
    "splitk_reduce": "src/repro_torch/csrc/gemm_split_k.cu",
    "stream_k_partials": "src/repro_torch/csrc/gemm_stream_k.cu",
    "stream_k_fixup": "src/repro_torch/csrc/gemm_stream_k.cu",
    "grouped_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
    "ragged_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "mamba_scan": "src/repro_torch/csrc/mamba_scan.cu",
}
LAUNCHERS = {
    "matmul": gemm_kernel.matmul,
    "splitk_partials": gemm_kernel.splitk_partials,
    "splitk_reduce": gemm_kernel.splitk_reduce,
    "stream_k_partials": gemm_kernel.stream_k_partials,
    "stream_k_fixup": gemm_kernel.stream_k_fixup,
    "grouped_matmul": grouped_kernel.grouped_matmul,
    "ragged_matmul": grouped_kernel.ragged_matmul,
    "flash_attention": flash_attention_fwd,
    "mamba_scan": mamba_scan_fwd,
}
# Kernels each serving path must launch at least once.
PER_CLASS_KERNELS = ("matmul", "grouped_matmul", "ragged_matmul")
MIXED_KERNELS = ("matmul", "splitk_partials", "splitk_reduce",
                 "stream_k_partials", "stream_k_fixup")
OP_BUNDLE_KERNELS = ("flash_attention", "mamba_scan")
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
                  f"static smem ≤ {max(smem, default=0)} B, spill stores {spills} B")


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


def walk_kw(geo) -> dict:
    """The plain Stream-K walk's arguments for the card's geometry: CTA
    tiles, the CTA's k step and W workgroups."""
    return dict(bm=geo.rows, bn=geo.cols, bk=geo.bk, grid_g=geo.workgroups)


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
            geo = gemm_kernel.card_geometry(M, N, K, dtype, ta, tb, G, a.device)
            counts = torch.from_numpy(geo.counts).to(a.device)
            kw = walk_kw(geo)    # the plain walk at the card's geometry
            p = gemm_kernel.stream_k_partials(a, b, ta=ta, tb=tb, grid_g=G)
            written = torch.arange(geo.slots, device=a.device)[:, None, None] < \
                element_counts(counts, M, N, geo.rows, geo.cols)[None]
            aa, ab = op_abs(a, b, ta, tb)
            check_close(torch.where(written, p, 0.0),
                        stream_k_partials_ref(a, b, ta=ta, tb=tb, **kw),
                        stream_k_partials_ref(aa, ab, **kw), what + " partials")
            fix = dict(bm=geo.rows, bn=geo.cols, dtype=dtype)
            check_equal(gemm_kernel.stream_k_fixup(counts, p, **fix),
                        stream_k_fixup_ref(counts, p, **fix), what + " fixup")
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
    sets = [(randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5)) for _ in range(4)]
    a, b = sets[0]
    geo = gemm_kernel.card_geometry(M, N, K, bf16, False, False, G, a.device)
    kw = walk_kw(geo)
    per_sm, smem = gemm_kernel.walk_resources(a.device, bf16, False, False, geo.rows)
    print(f"# stream_k_partials grid at {M}x{N}x{K} g{G}: W = {geo.workgroups} "
          f"workgroups ({per_sm} CTAs of {smem} B shared memory per SM), "
          f"{geo.live} live CTAs of {geo.rows}x{geo.cols}, k step {geo.bk}, "
          f"{geo.ipw} iterations each, {geo.slots} slots")
    counts = torch.from_numpy(geo.counts).to(a.device)
    written = element_counts(counts, M, N, geo.rows, geo.cols)
    mask = torch.arange(geo.slots, device=a.device)[:, None, None] < written[None]
    p = gemm_kernel.stream_k_partials(a, b, grid_g=G)
    err = check_close(torch.where(mask, p, 0.0), stream_k_partials_ref(a, b, **kw),
                      stream_k_partials_ref(a.float().abs(), b.float().abs(), **kw),
                      "stream_k_partials main")
    part_bytes = int(written.sum()) * 4          # the slots this walk writes
    shape = f"{M}x{N}x{K} at {tile.key()}"
    rows["stream_k_partials"] = [dict(
        shape=shape, instantiation=(f"bf16 {geo.rows}x{geo.cols}x{geo.bk}, W {geo.workgroups} "
                                    f"({geo.live} live), {smem} B shared"),
        grid=dict(workgroups=geo.workgroups, live=geo.live, ctas_per_sm=per_sm,
                  smem_bytes=smem),
        max_abs_err=err,
        ms=time_ms(rotating(lambda x, y: gemm_kernel.stream_k_partials(x, y, grid_g=G,
                                                                       out=p), sets)),
        plain_ms=time_ms(lambda: stream_k_partials_ref(a, b, **kw), reps=3, warmup=1,
                         queued=False),   # thousands of launches a call
        library_ms=time_ms(rotating(torch.matmul, sets)),
        bound=bound((M * K + K * N) * 2 + part_bytes, 2 * M * N * K, bf16))]
    fix = dict(bm=geo.rows, bn=geo.cols, dtype=bf16)
    out = gemm_kernel.stream_k_fixup(counts, p, **fix)
    err = check_equal(out, stream_k_fixup_ref(counts, p, **fix), "stream_k_fixup main")
    c = torch.empty_like(out)
    rows["stream_k_fixup"] = [dict(
        shape=f"{geo.slots}x{M}x{N} f32 partials -> bf16 ({shape})",
        instantiation="256 threads, grid-stride", max_abs_err=err,
        ms=time_ms(lambda: gemm_kernel.stream_k_fixup(counts, p, out=c, **fix)),
        plain_ms=time_ms(lambda: stream_k_fixup_ref(counts, p, **fix), reps=5),
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
                ("ragged_kernel", "ragged_matmul"), ("flash_bf16_kernel", "flash_attention"),
                ("mamba_kernel", "mamba_scan"), ("Cat", "stack/cat copy"),
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
                _run_op(r, t)

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


# -------------------------------------------- attention and scan kernels
SCAN_TOL = 3e-4
# The reference tests' bf16 attention tolerance (atol = rtol): only for
# SDPA, a library call with roundings of its own, timed beside the kernel.
SDPA_TOL = 3e-2
# (B, Hq, Hkv, T, S, D, Dv, causal, window, bq, bkv)
ATTN_CASES = (
    (2, 40, 8, 1, 4096, 128, 128, True, 0, 8, 128),   # GQA decode (Qwen3-14B)
    (2, 32, 32, 1, 2048, 64, 64, True, 0, 8, 128),    # MHA decode (Zamba2)
    (1, 4, 2, 37, 250, 32, 32, True, 0, 8, 128),      # q_offset 213, S % bkv != 0
    (2, 4, 4, 64, 300, 64, 64, True, 16, 64, 128),    # window
    (1, 8, 2, 130, 130, 128, 128, True, 0, 128, 512),  # prefill, q block > rows
    (1, 2, 2, 20, 100, 32, 16, False, 0, 8, 256),     # dv != dqk, not causal
    (1, 4, 4, 9, 140, 192, 128, True, 0, 8, 128),     # dv != dqk, 256-wide
)
# (B, T, H, P, N, chunk, initial state, head-broadcast B/C)
SCAN_CASES = (
    (2, 70, 3, 16, 8, 32, False, False),
    (16, 1, 64, 64, 64, 32, False, True),     # the decode member (Zamba2)
    (1, 600, 2, 64, 64, 512, True, False),
    (1, 300, 2, 32, 16, 8, True, True),
    (1, 200, 4, 64, 128, 64, False, False),
    (2, 97, 2, 128, 32, 128, True, True),
)


def tol_excess(out, ref, atol: float, rtol: float, what: str) -> tuple[float, int]:
    """The max |out − ref| and the number of elements beyond atol +
    rtol·|ref|; ``out`` must be finite and of ``ref``'s shape."""
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (o - r).abs()
    return float(err.max()), int((err > atol + rtol * r.abs()).sum())


def check_tol(out, ref, atol: float, rtol: float, what: str) -> float:
    """|out − ref| ≤ atol + rtol·|ref| elementwise, both finite and of one
    shape; returns the max absolute error."""
    err, n_bad = tol_excess(out, ref, atol, rtol, what)
    if n_bad:
        raise AssertionError(f"{what}: {n_bad} elements beyond {atol} + {rtol}·|ref|, "
                             f"max |err| {err:.4g}")
    return err


def attention_f32_ref(q, k, v, q_offset: int, **kw):
    """`flash_ref` on f32 copies of the inputs, kept in f32."""
    return flash_ref(q.float(), k.float(), v.float(), q_offset=q_offset, **kw)


def check_attention(out, q, k, v, q_offset: int, what: str, **kw) -> float:
    return check_tol(out, attention_f32_ref(q, k, v, q_offset, **kw),
                     *attention_tol(out.dtype), what)


def planted_fault(q, k, v, kw: dict, lo: int = 2048) -> None:
    """The bf16 tolerance's power at the path's shape: the kernel run
    without keys [lo, lo + 64) gives what a kernel that skipped that 64-key
    sub-tile would; it must fail `check_attention`.  Prints how far off it
    is, and how many of its outputs the reference tests' bf16 tolerance
    (3e-2 + 3e-2·|ref|) would have let through."""
    keep = torch.ones(k.shape[2], dtype=torch.bool, device=k.device)
    keep[lo:lo + 64] = False
    fault = flash_attention_fwd(q, k[:, :, keep], v[:, :, keep],
                                **{**kw, "q_offset": kw["q_offset"] - 64})
    ref = attention_f32_ref(q, k, v, kw["q_offset"])
    err, n_bad = tol_excess(fault, ref, *attention_tol(fault.dtype), "planted fault")
    _, n_loose = tol_excess(fault, ref, SDPA_TOL, SDPA_TOL, "planted fault")
    atol, rtol = attention_tol(fault.dtype)
    print(f"# planted fault (keys [{lo}, {lo + 64}) skipped) at the main shape: max |err| "
          f"{err:.4g}; {n_bad} of {fault.numel()} outputs beyond {atol} + {rtol:.6g}·|ref| "
          f"(3e-2 + 3e-2·|ref|: {n_loose})")
    if not n_bad:
        raise AssertionError("the attention tolerance lets a skipped kv sub-tile through")


def check_scan(y, state, xd, da, bm, cm, s0, what: str) -> float:
    """The plain version in f32 on the same inputs (bf16 converts exactly)."""
    y_ref, s_ref = ssd_chunk_ref(xd.float(), da.float(), bm.float(), cm.float(),
                                 chunk=64, initial_state=s0)
    rtol = SCAN_TOL + (2.0 ** -8 if y.dtype == torch.bfloat16 else 0.0)
    err = check_tol(y, y_ref, SCAN_TOL, rtol, what + " y")
    check_tol(state, s_ref, SCAN_TOL, SCAN_TOL, what + " state")
    return err


def scan_inputs(B, T, H, P, N, gen, dtype, broadcast: bool):
    """xd, da (≤ 0), and B/C (B,T,H,N) — as head-broadcast views of
    (B,T,N) (head stride 0, Mamba2's group-shared layout) when asked."""
    xd = randn((B, T, H, P), gen, dtype)
    da = (torch.rand((B, T, H), generator=gen, device="cuda") * -0.5).to(dtype)
    if broadcast:
        bm, cm = (randn((B, T, N), gen, dtype, 0.5)[:, :, None].expand(B, T, H, N)
                  for _ in range(2))
    else:
        bm, cm = randn((B, T, H, N), gen, dtype, 0.5), randn((B, T, H, N), gen, dtype, 0.5)
    return xd, da, bm, cm


def attention_scan_cases(gen) -> int:
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for i, (B, Hq, Hkv, T, S, D, Dv, causal, window, bq, bkv) in enumerate(ATTN_CASES):
            what = (f"flash B{B} Hq{Hq} Hkv{Hkv} T{T} S{S} D{D}/{Dv} causal{causal:d} "
                    f"window{window} bq{bq} bkv{bkv} {dtype}")
            if i % 2:   # strided: (B, T, H, D) storage read as (B, H, T, D)
                q = randn((B, T, Hq, D), gen, dtype).transpose(1, 2)
                k = randn((B, S, Hkv, D), gen, dtype).transpose(1, 2)
                v = randn((B, S, Hkv, Dv), gen, dtype).transpose(1, 2)
            else:
                q, k, v = (randn((B, Hq, T, D), gen, dtype), randn((B, Hkv, S, D), gen, dtype),
                           randn((B, Hkv, S, Dv), gen, dtype))
            off = S - T if causal else 0
            out = flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=off,
                                      bq=bq, bkv=bkv)
            check_attention(out, q, k, v, off, what, causal=causal, window=window)
            n += 1
        for (B, T, H, P, N, L, with_s0, bcast) in SCAN_CASES:
            what = f"scan B{B} T{T} H{H} P{P} N{N} L{L} s0{with_s0:d} bcast{bcast:d} {dtype}"
            xd, da, bm, cm = scan_inputs(B, T, H, P, N, gen, dtype, bcast)
            s0 = randn((B, H, N, P), gen, torch.float32) if with_s0 else None
            y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=L, initial_state=s0)
            check_scan(y, state, xd, da, bm, cm, s0, what)
            n += 1
    return n


def scan_flops(B, T, H, P, N, L) -> int:
    """The chunked scan's multiply-adds ×2 for these shapes: per (batch,
    head) and chunk of Lr rows, C·Bᵀ and the weighted xd over the lower
    triangle, C·S_prev, and the state update."""
    per = 0
    for c0 in range(0, T, L):
        lr = min(L, T - c0)
        per += lr * (lr + 1) * (N + P) + 4 * lr * N * P + N * P
    return B * H * per


def dropped_split_fault(q, k, v, bufs, q_offset: int) -> None:
    """The combine's check at a split shape of the path: the kernel's own split
    partials merged in split order, as the kernel merges them, agree with
    its output within a bf16 unit; merged without one split they must fail
    `check_attention`.  Prints how far off that is."""
    splits = bufs.part_acc.shape[0] if bufs.part_acc is not None else 1
    if splits < 2:
        raise AssertionError("this attention shape runs one kv split: no combine")
    merged = flash_combine_ref(bufs.part_acc, bufs.part_ml, q.dtype)
    check_tol(bufs.out, merged, 1e-6, 2.0 ** -7, "kernel merge vs plain combine")
    drop = splits // 2
    keep = [i for i in range(splits) if i != drop]
    fault = flash_combine_ref(bufs.part_acc[keep], bufs.part_ml[keep], q.dtype)
    ref = attention_f32_ref(q, k, v, q_offset)
    err, n_bad = tol_excess(fault, ref, *attention_tol(fault.dtype), "dropped split")
    print(f"# planted fault (the combine without split {drop} of {splits}) at "
          f"{tuple(q.shape)}: max |err| {err:.4g}; {n_bad} of {fault.numel()} outputs "
          "beyond the attention tolerance")
    if not n_bad:
        raise AssertionError("the attention tolerance lets a dropped kv split through")


def attention_member(B: int, gen, lib) -> dict:
    """Qwen3-14B's decode attention member at batch B (Hq 40, Hkv 8, Skv
    4,096, D 128, bf16): compared, then timed beside its plain version and
    SDPA, on operand sets rotating beyond the 50 MB L2 (K+V is 16.8 MB per
    sequence).  A planted fault runs at each shape: skipped keys at batch
    16, a dropped kv split at batch 1 (16 splits)."""
    bf16 = torch.bfloat16
    desc = AttentionDesc(B, 40, 8, 1, 4096, 128)
    tile = lib.get(desc).isolated
    kw = dict(q_offset=desc.Skv - desc.Sq, **attention_tiles(tile))
    sets = [(randn((desc.B, desc.Hq, desc.Sq, desc.D), gen),
             randn((desc.B, desc.Hkv, desc.Skv, desc.D), gen),
             randn((desc.B, desc.Hkv, desc.Skv, desc.D), gen))
            for _ in range(-(-8 // B))]
    q, k, v = sets[0]
    bufs = attention_buffers(q, k, v)
    out = flash_attention_fwd(q, k, v, out=bufs, **kw)
    err = check_attention(out, q, k, v, kw["q_offset"], f"flash B{B}")
    splits, split_len = split_geometry(q, k, v)
    per_sm, smem = kernel_resources(q.device, bf16, width_for(desc.D, desc.D))
    ctas = desc.B * desc.Hkv * -(-(desc.Hq // desc.Hkv * desc.Sq) // 16) * splits
    print(f"# flash_attention grid at B{B}: {ctas} CTAs = {desc.B * desc.Hkv} (batch, kv "
          f"head) x {splits} kv splits of {split_len} keys; {smem} B shared memory per "
          f"CTA, {per_sm} CTAs per SM; K/V by {'TMA' if tma_loads(k, v) else 'registers'}")
    if B == 16:
        planted_fault(q, k, v, kw)
    else:
        dropped_split_fault(q, k, v, bufs, kw["q_offset"])
    # Every key is visible to the decode row (q_offset = Skv − 1), so the
    # non-causal SDPA call computes the same function.
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    check_tol(sdpa, attention_f32_ref(q, k, v, kw["q_offset"]), SDPA_TOL, SDPA_TOL,
              f"SDPA B{B}")
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2
    return dict(
        shape=f"B{desc.B} Hq{desc.Hq} Hkv{desc.Hkv} Sq{desc.Sq} Skv{desc.Skv} D{desc.D} "
              f"at {tile.key()} (bq {kw['bq']}, bkv {kw['bkv']})",
        instantiation=(f"bf16 head dim ≤ 128, {ctas} CTAs ({splits} splits of {split_len} "
                       f"keys), {smem} B shared"),
        grid=dict(ctas=ctas, splits=splits, split_len=split_len, ctas_per_sm=per_sm,
                  smem_bytes=smem),
        max_abs_err=err,
        ms=time_ms(rotating(lambda x, y, z: flash_attention_fwd(x, y, z, out=bufs, **kw),
                            sets)),
        plain_ms=time_ms(lambda: flash_ref(q, k, v, q_offset=kw["q_offset"]), reps=3,
                         warmup=1),
        library_ms=time_ms(rotating(
            lambda x, y, z: torch.nn.functional.scaled_dot_product_attention(
                x, y, z, enable_gqa=True), sets)),
        bound=bound(nbytes, desc.flops, bf16))


def attention_scan_kernels(gen, lib) -> dict:
    """The op-bundle path's attention and scan members: Qwen3-14B's
    tenant-16 attention (K+V 268 MB, beyond the 50 MB L2) and its batch-1
    member (eight operand sets, 134 MB), Zamba2's tenant-16 scan, plus one
    long-prefill scan.  Each is compared, then timed beside its plain
    version and, for attention, the PyTorch call computing the same
    function."""
    bf16 = torch.bfloat16
    rows = {"flash_attention": [attention_member(16, gen, lib),
                                attention_member(1, gen, lib)]}
    torch.cuda.empty_cache()

    rows["mamba_scan"] = []
    sdesc = ScanDesc(16, 1, 64, 64, 64)
    for (B, T, H, P, N), L in (((sdesc.B, sdesc.T, sdesc.H, sdesc.P, sdesc.N),
                                scan_chunk(lib.get(sdesc).isolated)),
                               ((1, 4096, 64, 64, 64), 128)):
        xd, da, bm, cm = scan_inputs(B, T, H, P, N, gen, bf16, broadcast=True)
        y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=L)
        err = check_scan(y, state, xd, da, bm, cm, None, f"scan main T{T}")
        # inputs read once (B/C: their (B,T,N) storage), y and the state written
        nbytes = (xd.numel() + da.numel() + 2 * B * T * N + y.numel()) * 2 + state.numel() * 4
        rows["mamba_scan"].append(dict(
            shape=f"B{B} T{T} H{H} P{P} N{N} L{L}, B/C head-broadcast",
            instantiation="bf16, 32-row sub-blocks", max_abs_err=err,
            ms=time_ms(lambda: mamba_scan_fwd(xd, da, bm, cm, chunk=L, out=(y, state))),
            plain_ms=time_ms(lambda: ssd_chunk_ref(xd, da, bm, cm, chunk=L), reps=3,
                             warmup=1),
            library_ms=None,
            bound=bound(nbytes, scan_flops(B, T, H, P, N, L), bf16)))
    for name, rs in rows.items():
        for r in rs:
            lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"# {name:<15} {r['shape']:<60} kernel {r['ms']:.4f} ms | plain "
                  f"{r['plain_ms']:.4f} | torch {lib_ms} | bound {r['bound'][0]:.6f} "
                  f"({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


# --------------------------------------------------- op-bundle serving
OP_CONFIGS = (("qwen3-14b", 4096), ("zamba2-1.2b", 2048))
OP_WINDOWS = (([1], 16), ([4, 8, 8, 16], 4))


def make_kv_caches(cfg, layers: int, batches, context: int, gen, device) -> list:
    """Per layer and tenant, a random bf16 K and V cache (B, Hkv, S, D)."""
    shape = (cfg.n_kv_heads, context, cfg.resolved_head_dim)
    return [[tuple(torch.randn((b,) + shape, generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(2))
             for b in batches] for _ in range(layers)]


def op_request(d, weight, kv, gen, device):
    """One bundle member with its operands: a GEMM's activations and
    weight, the attention's query and KV cache, or the scan's inputs
    (head-broadcast B/C, as Mamba2's group-shared layout)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)

    if d.family == "gemm":
        return GemmRequest(desc=d, a=rnd(d.M, d.K), b=weight)
    if d.family == "flash_attention":
        k, v = kv
        return bind_operands(d, (rnd(d.B, d.Hq, d.Sq, d.D), k[:d.B], v[:d.B]))
    da = (torch.rand((d.B, d.T, d.H), generator=gen, device=device) * -0.5).to(torch.bfloat16)
    bm, cm = (rnd(d.B, d.T, d.N)[:, :, None].expand(d.B, d.T, d.H, d.N) for _ in range(2))
    return bind_operands(d, (rnd(d.B, d.T, d.H, d.P), da, bm, cm))


def drive_op_bundles(rt: Runtime, cfg, weights, kv, batches, context: int, gen):
    """Per layer, every tenant submits its whole decode-step bundle, and
    the runtime drains.  Returns the bundle tickets, the wall time up to
    the last result being ready, the window's records and launches."""
    t0 = time.perf_counter()
    n0 = len(rt.telemetry.groups)
    handles, launches = [], []
    for li, wl in enumerate(weights):
        for ti, batch in enumerate(batches):
            descs = decode_step_op_descs(cfg, batch, context)
            ws = iter(wl)
            reqs = [op_request(d, next(ws) if d.family == "gemm" else None, kv[li][ti],
                               gen, rt.device) for d in descs]
            handles.append(rt.submit(reqs, tenant=f"tenant{ti}"))
        launches += rt.drain()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, rt.telemetry.groups[n0:], launches


def check_op_tickets(tickets) -> None:
    for tk in tickets:
        r, fam = tk.request, tk.desc.family
        what = f"ticket {tk.seq} {tk.desc.key()} ({tk.plan.mode})"
        if fam == "gemm":
            check_close(tk.result, gemm_ref(r.a, r.b), abs_product(r.a, r.b), what)
        elif fam == "flash_attention":
            check_attention(tk.result, *r.inputs, tk.desc.Skv - tk.desc.Sq, what)
        else:
            check_tol(tk.result, ssd_chunk_ref(*(x.float() for x in r.inputs))[0],
                      SCAN_TOL, SCAN_TOL + 2.0 ** -8, what)


def op_bundle_window(rt, cfg, weights, kv, batches, context, gen) -> dict:
    handles, wall, recs, launches = drive_op_bundles(rt, cfg, weights, kv, batches,
                                                     context, gen)
    if not all(h.done for h in handles):
        raise AssertionError("a bundle was left unfinished")
    tickets = [m for h in handles for m in h.members]
    check_op_tickets(tickets)
    fams = Counter(tk.desc.family for tk in tickets)
    weight_b = sum(tk.request.b.numel() * 2 for tk in tickets if tk.desc.family == "gemm")
    kv_b = sum((tk.request.inputs[1].numel() + tk.request.inputs[2].numel()) * 2
               for tk in tickets if tk.desc.family == "flash_attention")
    return dict(requests=len(tickets), families=dict(fams),
                launches=dict(Counter(g.mode for g in recs)), wall_s=wall,
                device_s=sum(g.achieved_time_s or 0.0 for g in recs),
                weight_gb=weight_b / 1e9, kv_gb=kv_b / 1e9, launch_list=launches)


def op_bundle_phase(name: str, context: int, device="cuda", layers=None,
                    reduced: bool = False) -> dict:
    cfg = get_arch(name)
    cfg = cfg.reduced() if reduced else cfg
    layers = layers or cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    weights = make_unfused_weights(cfg, layers, gen, device)
    tenants = max((b for b, _ in OP_WINDOWS), key=len)
    kv = make_kv_caches(cfg, layers, tenants, context, gen, device)
    model_gb = sum(w.numel() * 2 for wl in weights for w in wl) / 1e9
    kv_gb = sum(t.numel() * 2 for lkv in kv for pair in lkv for t in pair) / 1e9
    print(f"# op-bundle serving {cfg.name}: {layers} layers, context {context}, bundle "
          f"{[d.key() for d in decode_step_op_descs(cfg, 1, context)]}; weights "
          f"{model_gb:.2f} GB, KV caches {kv_gb:.2f} GB ({sum(tenants)} sequences) on {device}")
    rt = Runtime(ConcurrencyController(),
                 RuntimeConfig(window_s=0.0, execute=True), device=device)
    reset_counts()
    windows = []
    for batches, available in OP_WINDOWS:
        rt.set_available(available)
        for run in ("cold", "warm"):
            w = op_bundle_window(rt, cfg, weights, kv, batches, context, gen)
            w.update(batches=batches, available=available, plans=run)
            windows.append(w)
            print(f"# {cfg.name} op-bundle window batches {batches} available {available} "
                  f"({run} plans): {w['requests']} requests {w['families']}, launches "
                  f"{w['launches']}, wall {w['wall_s']:.6f} s, device {w['device_s']:.6f} s; "
                  f"weights {w['weight_gb']:.3f} GB + KV {w['kv_gb']:.3f} GB read, "
                  f"{(w['weight_gb'] + w['kv_gb']) / w['wall_s']:.1f} GB/s of wall")
    counts = {k: LAUNCHERS[k].launches for k in LAUNCHERS}
    members = sum((Counter(w["families"]) for w in windows), Counter())
    print(f"# {cfg.name} op-bundle modes {rt.telemetry.mode_counts()}; kernel launches "
          f"{counts}; members {dict(members)}")
    if device == "cuda" and (counts["flash_attention"] != members["flash_attention"]
                             or counts["mamba_scan"] != members["mamba_scan"]):
        raise AssertionError(f"{cfg.name}: attention/scan launches {counts} differ from "
                             f"the members submitted {dict(members)}")
    if device == "cuda":
        for w in windows[1::2]:     # the warm windows
            r = concurrency_ratio(w["launch_list"], rt.ctrl.lib)
            what = (f"# {cfg.name} warm op-bundle window batches {w['batches']} available "
                    f"{w['available']}, {len(w['launch_list'])} launches")
            if r is None:
                print(f"{what}: concurrent vs back to back not measured (the host "
                      "could not queue a chunk ahead of the card)")
                continue
            gb = w["weight_gb"] + w["kv_gb"]
            print(f"{what}: concurrent on streams {r['concurrent_s']:.6f} s, back to "
                  f"back on one stream {r['back_to_back_s']:.6f} s (ratio "
                  f"{r['ratio']:.4f}), back to back at isolated tiles "
                  f"{r['isolated_s']:.6f} s (ratio {r['isolated_ratio']:.4f}), in "
                  f"{r['chunks']} queued chunks; runs {r['runs']}; concurrent reads "
                  f"{gb / r['concurrent_s']:.1f} GB/s of weights + KV")
        for batches, available in OP_WINDOWS:
            rt.set_available(available)
            profile_window(f"{cfg.name} op-bundle window batches {batches} available "
                           f"{available}", lambda: drive_op_bundles(
                               rt, cfg, weights, kv, batches, context, gen)[1])
    for w in windows:
        del w["launch_list"]
    return dict(counts=counts, windows=windows, model_gb=model_gb, kv_gb=kv_gb)


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
    print(f"# attention and scan kernels: {attention_scan_cases(gen)} small cases agree "
          "with their plain versions")
    rows = {k: [r] for k, r in main_path_kernels(gen).items()}
    rows.update(split_stream_kernels(gen))
    rows.update(attention_scan_kernels(gen, default_library()))
    torch.cuda.empty_cache()
    serving = serving_phase()
    gc.collect()
    torch.cuda.empty_cache()
    mixed = mixed_phase()
    ops = {}
    for name, context in OP_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        ops[name] = op_bundle_phase(name, context)
    op_counts = {k: sum(o["counts"][k] for o in ops.values()) for k in OP_BUNDLE_KERNELS}
    missing = [k for k in OP_BUNDLE_KERNELS if op_counts[k] <= 0]
    if missing:
        raise AssertionError(f"the op-bundle path never launched {missing}")
    kernels = []
    for name in LAUNCHERS:
        r, *more = rows[name]
        path = (serving if name in PER_CLASS_KERNELS else
                {"counts": op_counts} if name in OP_BUNDLE_KERNELS else mixed)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "shape": r["shape"],
            "instantiation": r["instantiation"], "launches": path["counts"][name],
            **({"grid": r["grid"]} if "grid" in r else {}),
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
