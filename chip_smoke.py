#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # one NVIDIA H100; builds the kernels

Phases, each fatal on failure (nothing here catches an error):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port compiled with ``nvcc``, one
   process per source, all started together; then the card-only tests
   (`tests/test_torch_card.py`, marker ``cuda``) in a pytest process of
   their own, every one of which must pass;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs — a few dozen small cases with ragged M/N/K (and, for the
   single GEMM and the split-K and Stream-K kernels, every ``ta``/``tb``
   layout; split 2-8 with wholly empty slices, held to the plain partials
   and reduce and run twice for the same bits; Stream-K, one launch, with
   G from 1 to more workgroups than MAC iterations, held to
   `stream_k_matmul_ref` at the card's geometry and run twice for the
   same bits; the grouped and ragged kernels
   with their weights in each pointer form — one stacked tensor,
   per-member tensors with one weight shared, per-member transposed
   views — and with more members than the pointer table holds; every
   GEMM kernel also with float32 output from bf16 operands; `matmul` on
   both of its feeds, TMA boxes and the `cp.async` ring, each of which
   must run), then the serving path's shapes, where the kernel, its plain
   version and the one PyTorch call computing the same function are
   timed with CUDA events.  `matmul` is timed at the four Qwen3-14B
   decode shapes 8 x {34816, 17408, 5120, 1024} x 5120 on the feed the
   rule gives them (TMA) and, on the same values through an odd-offset
   view of A, on the ring feed, both held to the plain version, with the
   TMA instantiation's residency.
   `stream_k_matmul` is held to its plain version at the card's geometry
   (`card_geometry`: CTA tiles from M, W workgroups from the planner's G,
   the SM count and the kernel's occupancy) and timed on four rotating
   operand sets beside `torch.matmul`; its grid, run layout and
   workspace are printed, and a planted fault (one run's sum dropped
   from one cut tile) must fail its check; so are the ragged walk's (CTAs per SM and shared
   memory from the occupancy query, tiles, iterations per CTA) and, for
   the ring-fed grouped and split-K kernels at their timed shapes, the
   residency: CTAs, resident slots (CTAs per SM × SMs; for split-K also
   the resident clusters), waves, dynamic shared memory and bytes in
   flight per SM;
4. per-class serving: a full-width, full-depth Qwen3-14B weight set (40
   layers × the four fused bf16 decode GEMMs, ~26.4 GB, random from a
   seed) served through the port's `Runtime` to tenants at batches
   [8, 8, 8, 8] (grouped launches) and [4, 8, 8, 8, 16] (ragged
   launches), each window run twice (cold plan cache, then warm); every
   result is held against the plain version, and the launch counters,
   zeroed just before the first window, must show the single, grouped
   and ragged kernels, and no `matmul` launch on the ring feed (every
   serving shape is aligned bf16, which takes the TMA feed; the same
   holds in phases 5 and 7).  Then, with those weights still on the card,
   the dynamic logic, whose launches are counted apart (the counters are
   zeroed after it): (a) the logistic CD predictor trained on the card on
   the paper's dataset (1,072 pool GEMMs profiled against the GO library,
   a seeded 90/10 split), held to the same training on the CPU from the
   same initial weights (W within 1e-4·max(1, |W|), equal CDs), with its
   training seconds and held-out accuracy at 2/4/8/16 available GEMMs;
   (b) both windows, cold then warm, served through a runtime whose
   controller plans with that predictor, every result held against the
   plain version, each class's launches (CD, mode) printed beside the
   oracle controller's plan of the same queue; (c) the four fused decode
   GEMMs at batch 8 measured by the harness (`core/measure.py`: CUDA
   events around each launch, median of 5 after a warmup) at CD 1, 2, 4,
   8 and 16, beside the library's modeled CD and the predictor's, and
   the attention-out GEMM re-ranked by measurement (`tune_gemm(...,
   measure=)`), its entry saved to a library file and loaded back with
   its measured times and backend tag.  Every measured time must be
   finite; the times themselves are printed, not gated;
5. bundle (mixed) serving: the fused weights freed, the seven unfused
   decode GEMMs of every layer (q, k, v, o, gate, up, down; the same
   26.4 GB) submitted per tenant and layer as one bundle
   (`Runtime.submit(sequence)`), flushed per layer, in three windows —
   one tenant at batch 1 with 16 slots available, tenants [4, 8, 8, 16]
   with 4, and the same with 2 — each cold then warm, plus one planned
   mixed schedule that carries Stream-K members; every result is held
   against the plain version, and the counters, zeroed before the first
   of these windows, must show the single, split-K (one launch per
   split-K GEMM planned, no partials, no reduce launch), and Stream-K
   (one launch per Stream-K GEMM planned, no fixup launch) kernels.
   Then each warm window's launches run again, concurrently on streams, back to back on one
   stream at the same tiles, and back to back at the isolated tiles,
   each timed on the card: the concurrent-versus-sequential ratios are
   printed, not gated; and each window runs once more under the
   profiler, which counts its split-K and Stream-K launches beside the
   GEMMs planned and finds no reduce and no fixup kernel;
6. attention and scan kernels: the flash-attention kernel and both scan
   kernels (the decode kernel at T = 1, the chunk loop otherwise, each
   case checked to have launched on the route `scan_route` names)
   against their plain versions on small cases (GQA and MHA,
   causal with ``q_offset``, a window, S not a multiple of ``bkv``,
   prefill, dv ≠ dqk, strided q/k/v, bf16 and f32; T not a multiple of
   the chunk, chunks 8-512, a nonzero initial state, a head-broadcast
   B/C view, decode steps with and without a state, per-head B/C, rows
   not 16-byte groups), then timed at the path's shapes beside their
   plain versions and, for attention, PyTorch's
   ``scaled_dot_product_attention``: Qwen3-14B's tenant-16 member and
   its batch-1 member, each with its grid (CTAs, kv splits) and shared
   memory printed.  Two planted faults must fail the attention check:
   the kernel without one 64-key sub-tile (tenant 16), and the kernel's
   split partials merged without one split (batch 1, 16 splits; the same
   merge with every split must match the kernel's own output).  The
   scan's decode rows — Zamba2's tenant-16 member without and with an
   initial state, and its batch-1 member — are timed on output (and
   state) sets rotating beyond the 50 MB L2, with the decode grid (CTAs,
   pairs per CTA, column slices, CTAs per SM, shared memory); a planted
   fault (one pair's B xdᵀ term dropped from the state) must fail the
   scan check, and a ``copy_`` of the state into the rotating buffers is
   printed as the card's write ceiling at that size.  The long prefill
   (B1 T4096 L128) runs on the chunk loop;
7. op-bundle serving: for Qwen3-14B (40 layers, context 4,096) and
   Zamba2-1.2B (38 layers, context 2,048), at full width, every layer's
   whole decode-step bundle (`decode_step_op_descs`: the GEMMs, the
   attention read over the KV cache, and for Zamba2 the SSD state update)
   submitted per tenant as one bundle and flushed per layer, with random
   bf16 weights, queries and KV caches from a seed; one tenant at batch 1
   with 16 slots, then tenants [4, 8, 8, 16] with 4, each cold then warm.
   Every result is held against its plain version, and the counters,
   zeroed before the phase, must show exactly one attention launch per
   attention member and one scan launch per scan member, every scan
   launch on the decode kernel.  Each warm
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
moves the result by far more.  The split-K kernel is held to its plain
partials and reduce, which sum the slices' f32 tiles in slice order as
its cluster epilogue does, with |A|·|B| over all of K.  `stream_k_matmul`
is held to `stream_k_matmul_ref`, the plain walk's partials summed in the
kernel's order (runs of `fixup_runs`), with |A|·|B| over all of K, and
must give the same bits on a second run: its order is fixed by the
geometry, whichever CTA arrives last.

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
import math
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from dataclasses import replace
from itertools import cycle
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CDS,
    CLASSES,
    AttentionDesc,
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    Measurer,
    ScanDesc,
    Schedule,
    accuracy_by_available,
    bind_operands,
    execute_schedule,
    generate_gemm_pool,
    op_features,
    profile_dataset,
    train_predictor,
    tune_gemm,
)
from repro_torch.core.library import default_library  # noqa: E402
from repro_torch.core.measure import schedule_for, synth_request  # noqa: E402
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
    fixup_runs,
    splitk_partials_ref,
    splitk_reduce_ref,
    stream_k_matmul_ref,
    stream_k_partials_ref,
    stream_k_workspace,
)
from repro_torch.kernels.gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.grouped_gemm import (  # noqa: E402
    grouped_gemm_ref,
    ragged_gemm_ref,
)
from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    decode_grid,
    mamba_scan_fwd,
    scan_route,
    ssd_chunk_ref,
)
from repro_torch.kernels.mamba_scan.kernel import decode_residency  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import scan_buffers, scan_chunk  # noqa: E402
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
# The nine Pallas bodies and the launcher of the kernel that replaces each
# on the card.  Split-K's partials and reduce (rows 2 and 3) are one
# kernel, `splitk_matmul`: the reduce is its cluster epilogue.  Stream-K's
# walk and fixup (rows 4 and 5) are one kernel, `stream_k_matmul`: the
# fixup is its arrival epilogue.
REPLACES = (
    ("matmul", "src/repro/kernels/gemm/kernel.py:45 _matmul_kernel"),
    ("splitk_matmul", "src/repro/kernels/gemm/kernel.py:65 _matmul_splitk_kernel"),
    ("splitk_matmul", "src/repro/kernels/gemm/kernel.py:86 _reduce_kernel"),
    ("stream_k_matmul", "src/repro/kernels/gemm/kernel.py:215 _stream_k_kernel"),
    ("stream_k_matmul", "src/repro/kernels/gemm/kernel.py:247 _stream_k_fixup_kernel"),
    ("grouped_matmul", "src/repro/kernels/grouped_gemm/kernel.py:41 _grouped_kernel"),
    ("ragged_matmul", "src/repro/kernels/grouped_gemm/kernel.py:93 _ragged_kernel"),
    ("flash_attention", "src/repro/kernels/flash_attention/kernel.py:23 _flash_kernel"),
    ("mamba_scan", "src/repro/kernels/mamba_scan/kernel.py:24 _mamba_kernel"),
)
SOURCES = {
    "matmul": "src/repro_torch/csrc/gemm.cu",
    "splitk_matmul": "src/repro_torch/csrc/gemm_split_k.cu",
    "stream_k_matmul": "src/repro_torch/csrc/gemm_stream_k.cu",
    "grouped_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
    "ragged_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "mamba_scan": "src/repro_torch/csrc/mamba_scan.cu",
}
LAUNCHERS = {
    "matmul": gemm_kernel.matmul,
    "splitk_matmul": gemm_kernel.splitk_matmul,
    "stream_k_matmul": gemm_kernel.stream_k_matmul,
    "grouped_matmul": grouped_kernel.grouped_matmul,
    "ragged_matmul": grouped_kernel.ragged_matmul,
    "flash_attention": flash_attention_fwd,
    "mamba_scan": mamba_scan_fwd,
}
# Kernels each serving path must launch at least once.
PER_CLASS_KERNELS = ("matmul", "grouped_matmul", "ragged_matmul")
MIXED_KERNELS = ("matmul", "splitk_matmul", "stream_k_matmul")
OP_BUNDLE_KERNELS = ("flash_attention", "mamba_scan")
LAYOUTS = ((False, False), (False, True), (True, False), (True, True))
SLEEP_CYCLES = 500_000_000   # ~0.25 s of the card's clock: time to queue work


# ---------------------------------------------------------------- helpers
def check_close(out, ref, a_abs_b_abs, what: str) -> float:
    """Hold ``out`` to ``ref`` (same shape, finite) within the module's
    stated tolerance; returns the max absolute error."""
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, tol = gemm_excess(out, ref, a_abs_b_abs)
    if bool((err > tol).any()):
        i = int((err - tol).argmax())
        raise AssertionError(
            f"{what}: max |err| {err.max().item():.4g}, worst element "
            f"{i} err {err.flatten()[i].item():.4g} > tol {tol.flatten()[i].item():.4g}")
    return float(err.max())


def gemm_excess(out, ref, a_abs_b_abs):
    """|out − ref| and the tolerance, element by element, of `check_close`."""
    rel = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 0.0
    r = ref.float()
    return (out.float() - r).abs(), rel * r.abs() + 2.0 ** -16 * a_abs_b_abs


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
    gemm_kernel.matmul.feeds.update(dict.fromkeys(gemm_kernel.matmul.feeds, 0))
    mamba_scan_fwd.routes.update(dict.fromkeys(mamba_scan_fwd.routes, 0))


def check_feeds(label: str, device) -> dict:
    """Print `matmul`'s launches per feed since `reset_counts`; on the card,
    fail if any took the ring feed: every serving shape is aligned bf16,
    which `matmul_feed` gives the TMA feed."""
    feeds = dict(gemm_kernel.matmul.feeds)
    print(f"# {label}: matmul launches per feed {feeds}")
    if device == "cuda" and feeds["ring"]:
        raise AssertionError(f"{label}: {feeds['ring']} matmul launches took the ring "
                             "feed; every serving shape is aligned bf16 (TMA feed)")
    return feeds


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


def card_tests_phase() -> str:
    """The card-only tests in a pytest process of their own (no JAX there:
    ``--noconftest``), on the libraries just built; fails unless every
    test passes and none skips.  Returns pytest's summary line."""
    args = ["--noconftest", "-p", "no:cacheprovider", "-m", "cuda", "-q",
            str(ROOT / "tests" / "test_torch_card.py")]
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); import pytest; "
            f"sys.exit(pytest.main({args!r}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True)
    summary = (r.stdout.strip().splitlines() or ["(no output)"])[-1]
    if r.returncode != 0 or "skipped" in summary or "passed" not in summary:
        print(r.stdout[-6000:], r.stderr[-2000:], sep="\n")
        raise AssertionError(f"card-only tests: {summary}")
    return summary


# ---------------------------------------------------------------- kernels
def weight_forms(G: int, K: int, N: int, gen, dtype) -> dict:
    """The members' weights in both pointer forms: one stacked (G, K, N)
    tensor; per-member (K, N) tensors, the second member sharing the
    first's weight; and per-member transposed views of (N, K) storage
    (the kernels' TB layout), again with one weight shared."""
    rows = [randn((K, N), gen, dtype) for _ in range(G)]
    cols = [randn((N, K), gen, dtype).T for _ in range(G)]
    if G > 1:
        rows[1], cols[1] = rows[0], cols[0]
    return {"stacked": randn((G, K, N), gen, dtype), "per-member": rows,
            "transposed": cols}


def small_cases(gen) -> int:
    """Ragged shapes in every layout and type, against the plain versions;
    the grouped and ragged kernels with their weights in each pointer
    form, and every GEMM kernel also with float32 output from bf16
    operands (`out_dtype`)."""
    n = 0
    feeds = dict(gemm_kernel.matmul.feeds)
    for dtype in (torch.bfloat16, torch.float32):
        for (M, N, K) in ((1, 1, 1), (5, 70, 33), (16, 64, 128), (17, 129, 300),
                          (70, 200, 257), (130, 65, 64), (8, 136, 200),
                          (72, 328, 1000), (8, 17408, 320)):
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
                                 (4, 9, 130, 200, 8), (2, 70, 100, 96, 64),
                                 (20, 5, 64, 96, 8)):   # G above the table's 16
            a = randn((G, M, K), gen, dtype)
            for form, b in weight_forms(G, K, N, gen, dtype).items():
                out = grouped_kernel.grouped_matmul(a, b, bm=bm)
                check_close(out, grouped_gemm_ref(a, b), grouped_abs(a, b),
                            f"grouped G{G} {M}x{N}x{K} bm{bm} {form} {dtype}")
                n += 1
        for (sizes, N, K, bm) in (([8, 8], 64, 64, 8), ([16, 0, 32], 100, 130, 16),
                                  ([8, 24, 8, 8], 65, 257, 8),
                                  ([32, 64], 70, 96, 32), ([128, 256], 64, 80, 128),
                                  ([16, 8, 8, 8, 8], 5120, 300, 8),   # 480 tiles > CTAs
                                  ([16] * 18 + [0, 32], 96, 200, 16)):  # 20 members
            G, Mtotal = len(sizes), sum(sizes)
            a = randn((Mtotal, K), gen, dtype)
            for form, b in weight_forms(G, K, N, gen, dtype).items():
                out = grouped_kernel.ragged_matmul(a, b, sizes, bm=bm)
                check_close(out, ragged_gemm_ref(a, b, sizes), ragged_abs(a, b, sizes),
                            f"ragged {sizes} N{N} K{K} bm{bm} {form} {dtype}")
                n += 1
    used = {k: v - feeds[k] for k, v in gemm_kernel.matmul.feeds.items()}
    print(f"# small matmul cases per feed: {used}")
    if not all(used.values()):
        raise AssertionError(f"the small cases did not run both matmul feeds: {used}")
    return n + f32_output_cases(gen)


def f32_output_cases(gen) -> int:
    """bf16 operands, float32 output (`out_dtype`): each GEMM kernel
    against its plain version at the same output dtype (the tolerance's
    bf16 rounding term is then 0).  Split-K and Stream-K run through
    `gemm`, whose epilogues (split-K's cluster reduce, Stream-K's
    arrival sums) store the f32 sums."""
    bf16, f32 = torch.bfloat16, torch.float32
    n = 0
    for (M, N, K), (ta, tb) in zip(((5, 70, 600), (16, 129, 300), (33, 64, 1000)),
                                   LAYOUTS):
        a = randn((K, M) if ta else (M, K), gen)
        b = randn((N, K) if tb else (K, N), gen)
        a_, b_ = (a.T if ta else a), (b.T if tb else b)
        want = gemm_ref(a, b, ta=ta, tb=tb, out_dtype=f32)
        for tile in (TileConfig(8, 128, 128), TileConfig(8, 128, 128, split_k=3),
                     TileConfig(16, 128, 128, stream_k=5)):
            out = gemm(a, b, ta=ta, tb=tb, tile=tile, out_dtype=f32)
            if out.dtype != f32:
                raise AssertionError(f"gemm at {tile.key()} stored {out.dtype}")
            check_close(out, want, abs_product(a_, b_),
                        f"gemm {M}x{N}x{K} at {tile.key()} ta{ta:d} tb{tb:d} -> f32")
            n += 1
    a = randn((3, 9, 200), gen)
    for form, b in weight_forms(3, 200, 70, gen, bf16).items():
        check_close(grouped_kernel.grouped_matmul(a, b, bm=8, out_dtype=f32),
                    grouped_gemm_ref(a, b, out_dtype=f32), grouped_abs(a, b),
                    f"grouped G3 9x70x200 {form} -> f32")
        n += 1
    sizes = [16, 8, 0, 24]
    a = randn((sum(sizes), 300), gen)
    for form, b in weight_forms(4, 300, 130, gen, bf16).items():
        check_close(grouped_kernel.ragged_matmul(a, b, sizes, bm=8, out_dtype=f32),
                    ragged_gemm_ref(a, b, sizes, out_dtype=f32), ragged_abs(a, b, sizes),
                    f"ragged {sizes} N130 K300 {form} -> f32")
        n += 1
    return n


def grouped_abs(a, b):
    """|A[g]|·|B[g]| in f32 (the grouped tolerance's scale)."""
    return grouped_gemm_ref(a.float().abs(), [w.float().abs() for w in
                                              grouped_kernel.member_weights(b)])


def ragged_abs(a, b, group_sizes):
    """|A|·|B[g]| row by row, in f32 (the ragged tolerance's scale)."""
    return ragged_gemm_ref(a.float().abs(), [w.float().abs() for w in
                                             grouped_kernel.member_weights(b)],
                           group_sizes)


def residency(name: str, shape: str, ctas: int, res, split: int = 0) -> dict:
    """Print and return how a ring-fed kernel's grid of ``ctas`` CTAs sits
    on the card (``res``: `RingResidency`): resident slots (CTAs per SM ×
    SMs; for split-K the resident clusters × their CTAs too, whichever is
    fewer), waves = CTAs / slots, dynamic shared memory, and the operand
    bytes in flight per SM, (stages − 1) slabs × the CTAs an SM holds of
    this grid (its occupancy, or ⌈CTAs / SMs⌉ when the grid is smaller)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = res.ctas_per_sm * sms
    if split:
        slots = min(slots, res.clusters * split)
    per_sm = min(res.ctas_per_sm, -(-ctas // sms))
    out = dict(ctas=ctas, ctas_per_sm=res.ctas_per_sm, sms=sms, slots=slots,
               clusters=res.clusters, waves=ctas / slots, smem_bytes=res.smem_bytes,
               stages=res.stages, slab_bytes=res.slab_bytes,
               in_flight_per_sm=per_sm * (res.stages - 1) * res.slab_bytes)
    clusters = (f", {res.clusters} resident clusters of {split} "
                f"({res.clusters * split} CTAs)" if split else "")
    print(f"# {name} residency at {shape}: {ctas} CTAs; {res.ctas_per_sm} CTAs per "
          f"SM x {sms} SMs{clusters}: {slots} resident slots, {out['waves']:.3f} "
          f"waves; {res.smem_bytes} B dynamic shared memory per CTA, a "
          f"{res.stages}-stage ring of {res.slab_bytes} B slabs; "
          f"{out['in_flight_per_sm']} B in flight per SM")
    return out


def main_path_kernels(gen) -> dict:
    """The serving path's shapes: compare, then time kernel, plain version
    and the PyTorch call computing the same function.  Every operand set
    holds ≥ 178 MB of weights, beyond the 50 MB L2, so each timed call
    streams its weights from HBM."""
    rows = {"matmul": [matmul_shape(N, gen) for N in MATMUL_NS]}
    rows["matmul"][0]["host_us"] = launcher_host_us(gen)
    bf16 = torch.bfloat16

    # grouped: four tenants' ffn-down at batch 8, each weight by pointer
    G, M, N, K = 4, 8, 5120, 17408
    a, b = randn((G, M, K), gen), randn((G, K, N), gen, scale=K ** -0.5)
    ws = list(b.unbind(0))
    out = grouped_kernel.grouped_matmul(a, ws, bm=8)
    err = check_close(out, grouped_gemm_ref(a, ws), grouped_abs(a, ws),
                      "grouped main")
    res = grouped_kernel.grouped_residency(a.device, bf16, bf16, False, 16)
    rows["grouped_matmul"] = [dict(
        shape=f"G{G} {M}x{N}x{K}",
        instantiation=(f"{gemm_kernel.instantiation(bf16, 8)}, {res.stages}-stage "
                       f"cp.async ring, {res.smem_bytes} B shared"),
        grid=residency("grouped_matmul", f"G{G} {M}x{N}x{K}",
                       G * -(-M // 16) * -(-N // 64), res),
        max_abs_err=err,
        ms=time_ms(lambda: grouped_kernel.grouped_matmul(a, ws, bm=8)),
        plain_ms=time_ms(lambda: grouped_gemm_ref(a, ws), reps=5),
        library_ms=time_ms(lambda: torch.bmm(a, b)),
        bound=bound(G * (M * K + K * N + M * N) * 2, 2 * G * M * N * K, bf16))]
    # The copy the scheduler made before weights went by pointer: a
    # torch.stack of the members' B for such a launch.
    stack_ms = time_ms(lambda: torch.stack(ws), reps=5)
    print(f"# torch.stack of B for a grouped ffn-down launch (G={G}, "
          f"{G * K * N * 2 / 1e9:.3f} GB), no longer made: {stack_ms:.4f} ms")

    # ragged: five tenants' ffn-down at batches [16, 8, 8, 8, 4], bm = 16,
    # five distinct weights by pointer
    sizes, bm, N, K = [16, 8, 8, 8, 4], 16, 5120, 17408
    padded = [-(-s // bm) * bm for s in sizes]
    G, Mtotal = len(sizes), sum(padded)
    a = torch.zeros((Mtotal, K), dtype=bf16, device="cuda")
    off = 0
    for s, p in zip(sizes, padded):
        a[off:off + s] = randn((s, K), gen)
        off += p
    b = randn((G, K, N), gen, scale=K ** -0.5)
    ws = list(b.unbind(0))
    out = grouped_kernel.ragged_matmul(a, ws, padded, bm=bm)
    err = check_close(out, ragged_gemm_ref(a, ws, padded), ragged_abs(a, ws, padded),
                      "ragged main")
    per_sm, smem = grouped_kernel.ragged_resources(a.device, bf16, bf16, False, 16)
    geo = grouped_kernel.ragged_walk(
        Mtotal, N, K, bf16, bm,
        grouped_kernel.ragged_workgroups(a.device, bf16, bf16, False, 16))
    tiles = geo.tm * geo.tn
    print(f"# ragged_matmul grid at sizes {sizes} N{N} K{K}: {geo.live} CTAs "
          f"({per_sm} CTAs of {smem} B shared memory per SM) walk {tiles} tiles of "
          f"{geo.rows}x64, k step {geo.bk}, {geo.tk} steps each: {geo.total} "
          f"iterations, {geo.ipw} per CTA")
    # The padded members are all bm rows, so one bmm computes the same
    # function on these inputs.
    rows["ragged_matmul"] = [dict(
        shape=f"sizes {sizes} (padded to {bm}) N{N} K{K}",
        instantiation=(f"bf16 {geo.rows}x64x{geo.bk} walk, {geo.live} CTAs, "
                       f"{smem} B shared"),
        grid=dict(ctas=geo.live, ctas_per_sm=per_sm, smem_bytes=smem, tiles=tiles,
                  iterations=geo.total, ipw=geo.ipw),
        max_abs_err=err,
        ms=time_ms(lambda: grouped_kernel.ragged_matmul(a, ws, padded, bm=bm)),
        plain_ms=time_ms(lambda: ragged_gemm_ref(a, ws, padded), reps=5, queued=False),
        library_ms=time_ms(lambda: torch.bmm(a.view(G, bm, K), b)),
        bound=bound((Mtotal * K + G * K * N + Mtotal * N) * 2,
                    2 * Mtotal * N * K, bf16))]
    for name, rs in rows.items():
        for r in rs:
            print(f"# {name:<15} {r['shape']:<40} [{r['instantiation']}] kernel "
                  f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} | torch "
                  f"{r['library_ms']:.4f} | bound {r['bound'][0]:.4f} "
                  f"({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


# The serving path's `matmul` shapes, 8 x N x 5120 bf16 (Qwen3-14B at batch
# 8): fused gate+up, gate or up, q or o, k or v.
MATMUL_NS = (34816, 17408, 5120, 1024)


def odd_copy(x):
    """``x``'s values in a view one element past an aligned base: the
    same operand, which `matmul_feed` gives the ring feed."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def launcher_host_us(gen, calls: int = 2000) -> float:
    """Host time of one `matmul` call (checks, feed rule, tensor-map
    encoding, launch), µs: ``calls`` launches at 8 x 1024 x 5120 queued
    without a synchronize, the best of three runs."""
    a, b = randn((8, 5120), gen), randn((5120, 1024), gen)
    c = torch.empty((8, 1024), device="cuda", dtype=torch.bfloat16)
    for _ in range(50):
        gemm_kernel.matmul(a, b, bm=8, out=c)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            gemm_kernel.matmul(a, b, bm=8, out=c)
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    print(f"# matmul launcher host time: {min(runs):.2f} µs per call ({calls} calls "
          f"queued, runs {[round(r, 2) for r in runs]})")
    return min(runs)


def matmul_shape(N: int, gen, M: int = 8, K: int = 5120) -> dict:
    """`matmul` at 8 x N x 5120: both feeds held to `gemm_ref` (the ring
    feed on the same values through an odd-offset view of A), then the
    rule's feed, the ring feed, the plain version and `torch.matmul`
    timed with operand sets rotating beyond the 50 MB L2, and the
    residency of the TMA instantiation the rule picked."""
    bf16 = torch.bfloat16
    nsets = max(2, -(-200_000_000 // (N * K * 2)))
    sets = [(randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5),
             torch.empty((M, N), device="cuda", dtype=bf16)) for _ in range(nsets)]
    odd = [(odd_copy(x), y, z) for x, y, z in sets]
    a, b, _ = sets[0]
    shape = f"{M}x{N}x{K}"
    feed = gemm_kernel.matmul_feed(a, b, False, False)
    if feed != "tma" or gemm_kernel.matmul_feed(odd[0][0], b, False, False) != "ring":
        raise AssertionError(f"matmul {shape}: the feeds are not TMA and ring")
    want, scale = gemm_ref(a, b), abs_product(a, b)
    err = check_close(gemm_kernel.matmul(a, b, bm=8), want, scale, f"matmul {shape} tma")
    check_close(gemm_kernel.matmul(odd[0][0], b, bm=8), want, scale,
                f"matmul {shape} ring feed")
    ctas = -(-N // gemm_kernel.CTA_COLS) * -(-M // 16)
    ring = gemm_kernel.matmul_ring(ctas, gemm_kernel.sm_count(a.device))
    res = gemm_kernel.matmul_residency(a.device, bf16, bf16, False, False, 16, feed,
                                       ring)

    def run(x, y, z):
        return gemm_kernel.matmul(x, y, bm=8, out=z)

    row = dict(
        shape=shape, feed=feed,
        instantiation=(f"bf16 16x64 CTA tile, TMA feed: {res.stages}-stage ring of "
                       f"64-deep k-slabs, {ring[1]} consumer group(s), "
                       f"{res.smem_bytes} B shared"),
        grid=residency("matmul", shape, ctas, res), max_abs_err=err,
        ms=time_ms(rotating(run, sets)),
        ring_ms=time_ms(rotating(run, odd)),
        plain_ms=time_ms(lambda: gemm_ref(a, b), reps=5),
        library_ms=time_ms(rotating(lambda x, y, z: torch.matmul(x, y, out=z), sets)),
        bound=bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf16))
    print(f"# matmul {shape}: {feed} feed {row['ms']:.4f} ms, ring feed "
          f"{row['ring_ms']:.4f} ms on the same values, torch.matmul "
          f"{row['library_ms']:.4f} ms")
    return row


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
    """The split-K and Stream-K kernels against their own plain versions,
    each twice for the same bits: `splitk_matmul` against the plain
    partials and reduce, `stream_k_matmul` against `stream_k_matmul_ref`
    at the card's geometry; then `gemm` end to end."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (M, N, K, bm, bk, split_k), (ta, tb) in zip(SPLIT_CASES, cycle(LAYOUTS)):
            what = f"split-K {M}x{N}x{K} bm{bm} bk{bk} s{split_k} ta{ta:d} tb{tb:d} {dtype}"
            a = randn((K, M) if ta else (M, K), gen, dtype)
            b = randn((N, K) if tb else (K, N), gen, dtype)
            split, slice_k = gemm_kernel.split_k_slices(K, bk, split_k)
            kw = dict(ta=ta, tb=tb, split=split, slice_k=slice_k)
            aa, ab = op_abs(a, b, ta, tb)
            out = gemm_kernel.splitk_matmul(a, b, bm=bm, **kw)
            check_close(out, splitk_reduce_ref(splitk_partials_ref(a, b, bk=bk, **kw),
                                               dtype), aa @ ab, what)
            check_equal(gemm_kernel.splitk_matmul(a, b, bm=bm, **kw), out,
                        what + " second run")
            check_close(gemm(a, b, ta=ta, tb=tb,
                             tile=TileConfig(bm, 128, bk, split_k=split_k)),
                        gemm_ref(a, b, ta=ta, tb=tb), aa @ ab, what + " gemm")
            n += 1
        for (M, N, K, bm, bn, bk, G), (ta, tb) in zip(STREAM_CASES, cycle(LAYOUTS)):
            what = f"Stream-K {M}x{N}x{K} {bm}x{bn}x{bk}g{G} ta{ta:d} tb{tb:d} {dtype}"
            a = randn((K, M) if ta else (M, K), gen, dtype)
            b = randn((N, K) if tb else (K, N), gen, dtype)
            geo = gemm_kernel.card_geometry(M, N, K, dtype, ta, tb, G, a.device)
            kw = walk_kw(geo)    # the plain walk at the card's geometry
            aa, ab = op_abs(a, b, ta, tb)
            out = gemm_kernel.stream_k_matmul(a, b, ta=ta, tb=tb, grid_g=G)
            check_close(out, stream_k_matmul_ref(a, b, ta=ta, tb=tb, **kw), aa @ ab,
                        what + " stream_k_matmul")
            check_equal(gemm_kernel.stream_k_matmul(a, b, ta=ta, tb=tb, grid_g=G), out,
                        what + " second run")
            check_close(gemm(a, b, ta=ta, tb=tb, tile=TileConfig(bm, bn, bk, stream_k=G)),
                        gemm_ref(a, b, ta=ta, tb=tb), aa @ ab, what + " gemm")
            n += 1
    return n


def planted_stream_k_fault(a, b, out, ref, geo) -> None:
    """The Stream-K check's power at the timed shape: the kernel's output
    with one run's sum (run 1 of the tile of most contributors) taken out,
    which a kernel whose last run skipped that run would give, must fail
    `check_close`.  Prints how far off it is."""
    counts = geo.counts.reshape(-1)
    q = int(counts.argmax())
    n = int(counts[q])
    R = fixup_runs(n)
    if n <= R:
        raise AssertionError(f"no tile of two levels at {tuple(out.shape)}: {n} "
                             "contributors")
    i, j = divmod(q, geo.tn)
    rows = slice(i * geo.rows, (i + 1) * geo.rows)
    cols = slice(j * geo.cols, (j + 1) * geo.cols)
    p = stream_k_partials_ref(a, b, **walk_kw(geo))   # slot = contributor index
    fault = out.float()
    fault[rows, cols] -= p[R:2 * R, rows, cols].sum(0)
    err, tol = gemm_excess(fault.to(out.dtype), ref, abs_product(a, b))
    n_bad = int((err > tol).sum())
    print(f"# planted Stream-K fault (tile {q}: run 1 of {-(-n // R)}, contributors "
          f"{R}-{2 * R - 1} of {n}, dropped): max |err| {err.max().item():.4g}; "
          f"{n_bad} of {out.numel()} outputs beyond the tolerance, so check_close "
          "fails it")
    if not n_bad:
        raise AssertionError("check_close lets a dropped Stream-K run through")


def split_stream_kernels(gen) -> dict:
    """The mixed path's split-K shapes (Qwen3-14B ffn-down, 5120×17408
    bf16: 178 MB of weights, beyond the 50 MB L2) and the Stream-K shape
    the planner gives a 32×512×17408 member at CD 6-8 (17.8 MB of
    weights: four operand sets rotate, 71 MB together).  Each kernel,
    its plain version and the PyTorch call beside it are timed on the
    same inputs: for split-K and Stream-K the whole GEMM, one launch
    each, against `torch.matmul`.  Stream-K's timed launches include the
    zeroing of its counters; its bound is the function's, the bytes
    `torch.matmul` moves too: the f32 shares (3 MB at 46 contributors a
    tile) are written and read back within the launch, in L2."""
    rows = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for (M, N, K, split_k) in ((8, 5120, 17408, 4), (1, 5120, 17408, 8)):
        a, b = randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5)
        tile = TileConfig(8, 128, 128, split_k=split_k)
        split, slice_k = gemm_kernel.split_k_slices(K, tile.bk, split_k)
        kw = dict(split=split, slice_k=slice_k)
        out = gemm_kernel.splitk_matmul(a, b, bm=8, **kw)

        def plain():
            return splitk_reduce_ref(splitk_partials_ref(a, b, bk=tile.bk, **kw), bf16)

        shape = f"{M}x{N}x{K} at {tile.key()}"
        err = check_close(out, plain(), abs_product(a, b), f"splitk_matmul {shape}")
        res = gemm_kernel.splitk_residency(a.device, bf16, bf16, False, False, 16, split)
        rows.setdefault("splitk_matmul", []).append(dict(
            shape=shape,
            instantiation=(f"{gemm_kernel.instantiation(bf16, 8)}, {res.stages}-stage "
                           f"cp.async ring, clusters of {split}, {res.smem_bytes} B "
                           "shared"),
            grid=residency("splitk_matmul", shape, -(-N // 64) * -(-M // 16) * split,
                           res, split),
            max_abs_err=err,
            ms=time_ms(lambda: gemm_kernel.splitk_matmul(a, b, bm=8, out=out, **kw)),
            plain_ms=time_ms(plain, reps=3, warmup=1),
            library_ms=time_ms(lambda: torch.matmul(a, b)),
            bound=bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf16)))
        del a, b, out

    M, N, K, G = 32, 512, 17408, 8
    tile = TileConfig(32, 128, 128, stream_k=G)
    sets = [(randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5)) for _ in range(4)]
    a, b = sets[0]
    geo = gemm_kernel.card_geometry(M, N, K, bf16, False, False, G, a.device)
    kw = walk_kw(geo)
    per_sm, smem = gemm_kernel.walk_resources(a.device, bf16, False, False, geo.rows)
    counts = geo.counts.reshape(-1)
    cut = counts[counts > 1]
    runs_of = fixup_runs(int(counts.max()))
    floats, n_counters = stream_k_workspace(geo.live, geo.rows, geo.cols)
    grid = dict(workgroups=geo.workgroups, live=geo.live, ctas_per_sm=per_sm,
                smem_bytes=smem, ipw=geo.ipw, cut_tiles=int(cut.size),
                contributors=sorted({int(n) for n in cut}), runs_of=runs_of,
                runs=-(-int(counts.max()) // runs_of),
                workspace_bytes=(floats + n_counters) * 4,
                shares_bytes=int(cut.sum()) * geo.rows * geo.cols * 4)
    print(f"# stream_k_matmul grid at {M}x{N}x{K} g{G}: W = {geo.workgroups} "
          f"workgroups ({per_sm} CTAs of {smem} B shared memory per SM), "
          f"{geo.live} live CTAs of {geo.rows}x{geo.cols}, k step {geo.bk}, "
          f"{geo.ipw} iterations each; {grid['cut_tiles']} cut tiles of "
          f"{grid['contributors']} contributors, summed in runs of {runs_of} "
          f"({grid['runs']} runs); workspace {grid['workspace_bytes']} B, "
          f"{grid['shares_bytes']} B of shares written")
    ref = stream_k_matmul_ref(a, b, **kw)
    out = gemm_kernel.stream_k_matmul(a, b, grid_g=G)
    err = check_close(out, ref, abs_product(a, b), "stream_k_matmul main")
    check_equal(gemm_kernel.stream_k_matmul(a, b, grid_g=G), out,
                "stream_k_matmul main second run")
    planted_stream_k_fault(a, b, out, ref, geo)
    c = torch.empty_like(out)
    ws = torch.empty(floats, device=a.device)
    shape = f"{M}x{N}x{K} at {tile.key()}"
    rows["stream_k_matmul"] = [dict(
        shape=shape, instantiation=(f"bf16 {geo.rows}x{geo.cols}x{geo.bk}, W "
                                    f"{geo.workgroups} ({geo.live} live), {smem} B "
                                    f"shared, runs of {runs_of}"),
        grid=grid, max_abs_err=err,
        ms=time_ms(rotating(lambda x, y: gemm_kernel.stream_k_matmul(
            x, y, grid_g=G, out=c, workspace=ws), sets)),
        plain_ms=time_ms(lambda: stream_k_matmul_ref(a, b, **kw), reps=3, warmup=1,
                         queued=False),   # thousands of launches a call
        library_ms=time_ms(rotating(torch.matmul, sets)),
        bound=bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf16))]
    if gemm_kernel.stream_counters(a.device, n_counters).any():
        raise AssertionError("stream_k_matmul left its stream's counters nonzero: "
                             "the next launch would miscount")
    for name, rs in rows.items():
        for r in rs:
            print(f"# {name:<17} {r['shape']:<52} kernel {r['ms']:.4f} ms | plain "
                  f"{r['plain_ms']:.4f} | torch {r['library_ms']:.4f} | bound "
                  f"{r['bound'][0]:.6f} ({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


# ---------------------------------------------------------------- serving
SERVING_WINDOWS = ([8, 8, 8, 8], [4, 8, 8, 8, 16])


def fused_shapes(cfg) -> list:
    """(K, N) of the four fused decode GEMMs: fused QKV, attention-out,
    fused FFN gate+up and FFN down."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    return [(D, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
            (cfg.n_heads * hd, D), (D, 2 * cfg.d_ff), (cfg.d_ff, D)]


def make_weights(cfg, layers: int, gen, device) -> list:
    """Per layer, the four decode GEMMs' weights keyed by (K, N) of
    `fused_shapes`, stored (K, N)."""
    out = []
    for _ in range(layers):
        out.append({
            (k, n): torch.randn((k, n), generator=gen, device=device,
                                dtype=torch.bfloat16).mul_(k ** -0.5)
            for k, n in fused_shapes(cfg)})
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
                request_weight_gb=req_bytes / 1e9, tickets=tickets,
                launch_list=launches)


KERNEL_OF_MODE = {"single": "matmul", "grouped": "grouped_matmul",
                  "ragged": "ragged_matmul"}
KERNEL_KINDS = (("stream_k_matmul_kernel", "stream_k_matmul"),
                ("matmul_kernel", "matmul"), ("grouped_kernel", "grouped_matmul"),
                ("splitk_kernel", "splitk_matmul"),
                ("fixup_kernel", "stream-K fixup"),
                ("ragged_kernel", "ragged_matmul"), ("flash_bf16_kernel", "flash_attention"),
                ("mamba_decode_kernel", "mamba_scan"), ("mamba_kernel", "mamba_scan"),
                ("Cat", "stack/cat copy"),
                ("reduce", "isfinite checks"))


def planned(launches, kind: str) -> int:
    """The GEMMs of a decomposition among a window's launches: the members
    of mixed launches, and single launches, whose `decomposition` starts
    with ``kind`` ("split-K", "Stream-K"); a grouped or ragged launch of
    several members runs its own kernel."""
    n = 0
    for ln in launches:
        if ln.plan.mode == "mixed":
            pairs = zip(ln.tickets, ln.plan.tiles or [ln.plan.tile] * len(ln.tickets))
        elif ln.plan.mode == "single" or len(ln.tickets) == 1:
            pairs = [(ln.tickets[0], ln.plan.tile)]
        else:
            continue
        n += sum(tk.desc.family == "gemm" and
                 decomposition(tk.desc, t).startswith(kind) for tk, t in pairs)
    return n


def profile_window(label: str, drive) -> None:
    """One more warm window under `torch.profiler` (``drive`` runs it and
    returns its wall time and launches): device time by kernel kind, and
    the device's busy and idle shares of the window's wall time.  Busy
    time is the union of the kernels' intervals, so kernels that overlap
    on streams count once; the profiler's own overhead lengthens the wall
    time.  It also prints the split-K and Stream-K kernels' launches beside
    the split-K and Stream-K GEMMs the window planned, and the port's
    reduce and fixup kernels seen (none: split-K sums its slices in its
    cluster epilogue, Stream-K its cut tiles in its arrival epilogue)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, launches = drive()
    by_kind, launched, total, reduces = {}, Counter(), 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        total += us
        kind = next((k for pat, k in KERNEL_KINDS if pat in evt.key), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        launched[kind] += evt.count
        reduces += evt.count if "repro::reduce" in evt.key else 0
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
          f"device busy {busy / 1e6:.6f} s (idle {1 - busy / 1e6 / wall:.1%}); {parts}; "
          f"split-K kernel launches {launched['splitk_matmul']} for "
          f"{planned(launches, 'split-K')} split-K GEMMs planned; split-K reduce "
          f"kernels {reduces}; Stream-K kernel launches {launched['stream_k_matmul']} "
          f"for {planned(launches, 'Stream-K')} Stream-K GEMMs planned; fixup kernels "
          f"{launched['stream-K fixup']}")


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
    for batches in SERVING_WINDOWS:
        for run in ("cold", "warm"):
            w = serve_window(rt, cfg, weights, batches, gen)
            del w["tickets"], w["launch_list"]
            windows.append(w)
            print(f"# window batches {batches} ({run} plans): {w['requests']} "
                  f"requests, launches {w['launches']}, wall {w['wall_s']:.6f} s, "
                  f"device {w['device_s']:.6f} s, "
                  f"{w['request_weight_gb'] / w['wall_s']:.1f} request-weight GB/s, "
                  f"{model_gb / w['wall_s']:.1f} model-weight GB/s")
    counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
    modes = rt.telemetry.mode_counts()
    print(f"# serving modes {modes}; kernel launches {counts}")
    check_feeds("per-class serving", device)
    missing = [k for k in PER_CLASS_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the per-class serving path never launched {missing}")
    tiles = sum((w["tiles"] for w in windows), Counter())
    print(f"# serving CTA tiles (kernel, instantiation): {dict(tiles)}")
    if not {"grouped", "ragged"} <= set(modes) or not (
            modes.get("single", 0) + modes.get("fused", 0)):
        raise AssertionError(f"serving did not run every launch mode: {modes}")
    if device == "cuda":
        for batches in SERVING_WINDOWS:
            profile_window(f"window batches {batches}", lambda: drive_window(
                rt, cfg, weights, batches, gen)[1::2])
    dynamic_logic_phase(cfg, weights, gen, device)
    return dict(counts=counts, windows=windows, model_gb=model_gb)


# ---------------------------------------------------------- dynamic logic
# The paper's training set: 1,072 GEMMs (§5.2), 90/10 split.
TRAIN_POOL, TRAIN_SEED = 1072, 17
# Card-trained W against CPU-trained W from the same w0, elementwise:
# |ΔW| ≤ W_TOL·max(1, |W|).  Both run the same float32 Adam steps and sum
# float32 products in their own orders (a CPU run of the port against
# the JAX reference reads ~3e-6 at |W| ≤ 11.5).
W_TOL = 1e-4
MEASURED_CDS = (2, 4, 8, 16)


def train_phase(lib, device):
    """(a) The predictor trained on the paper's dataset on ``device``,
    held to one trained on the CPU from the same initial weights."""
    pool = generate_gemm_pool(TRAIN_POOL, seed=TRAIN_SEED)
    t0 = time.perf_counter()
    lib.prewarm(pool)
    X, y = profile_dataset(pool, lib)
    profile_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    idx = rng.permutation(len(X))
    tr, te = idx[:int(0.9 * len(X))], idx[int(0.9 * len(X)):]
    w0 = (0.01 * rng.standard_normal((X.shape[1] + 1, len(CLASSES)))).astype(np.float32)
    t0 = time.perf_counter()
    pred = train_predictor(X[tr], y[tr], w0=w0, device=device)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = train_predictor(X[tr], y[tr], w0=w0, device="cpu")
    cpu_s = time.perf_counter() - t0
    dw = np.abs(pred.W - cpu.W)
    if (dw > W_TOL * np.maximum(1.0, np.abs(cpu.W))).any():
        raise AssertionError(f"card-trained W off the CPU-trained W by {dw.max():.3g}")
    for avail in (1, 2, 4, 8, 16):
        if not np.array_equal(pred.predict_cd(X, avail), cpu.predict_cd(X, avail)):
            raise AssertionError(f"card- and CPU-trained CDs differ at available {avail}")
    acc = accuracy_by_available(pred, X[te], y[te])
    labels = np.asarray(CLASSES)[y[te]]
    majority = {a: float(np.bincount(np.minimum(labels, a)).max() / len(te))
                for a in acc}
    seeded = train_predictor(X[tr], y[tr], seed=SEED, device=device)
    print(f"# predictor: {len(pool)} GEMMs profiled in {profile_s:.3f} s (host), "
          f"{len(tr)} trained / {len(te)} held out; 600 epochs on {device} in "
          f"{train_s:.3f} s (CPU {cpu_s:.3f} s), max |ΔW| vs CPU {dw.max():.3g} at "
          f"|W| ≤ {np.abs(cpu.W).max():.3g}, CDs equal at available 1-16")
    print(f"# predictor held-out accuracy by available {acc} (majority class "
          f"{majority}); from the seeded draw on {device} "
          f"{accuracy_by_available(seeded, X[te], y[te])}")
    return pred


def run_lengths(rows) -> str:
    """[(cd, mode), ...] as "3×(16 grouped), (8 ragged)"."""
    out = []
    for r in rows:
        if out and out[-1][1] == r:
            out[-1][0] += 1
        else:
            out.append([1, r])
    return ", ".join(f"{n}×({r[0]} {r[1]})" if n > 1 else f"({r[0]} {r[1]})"
                     for n, r in out)


def class_rows(launches) -> dict:
    rows = {}
    for ln in launches:
        rows.setdefault(ln.class_key, []).append((ln.plan.cd, ln.plan.mode))
    return rows


def predicted_serving(cfg, weights, pred, gen, device) -> int:
    """(b) Phase 4's windows planned by the predictor, every result held
    to the plain version; per class, the launches' CD and mode beside the
    oracle controller's plan of the same queue.  Returns the launches
    that differ."""
    rt = Runtime(ConcurrencyController(default_library(), predictor=pred),
                 RuntimeConfig(window_s=0.0, execute=True), device=device)
    oracle = Runtime(ConcurrencyController(default_library()),
                     RuntimeConfig(window_s=0.0), device=device)
    differ = 0
    for batches in SERVING_WINDOWS:
        for run in ("cold", "warm"):
            w = serve_window(rt, cfg, weights, batches, gen)
            for tk in w["tickets"]:
                oracle.submit(tk.request, tenant=tk.tenant)
            mine, theirs = class_rows(w["launch_list"]), class_rows(oracle.drain())
            n = sum(sum(a != b for a, b in zip(mine.get(k, []), theirs.get(k, [])))
                    + abs(len(mine.get(k, [])) - len(theirs.get(k, [])))
                    for k in set(mine) | set(theirs))
            differ += n
            print(f"# predictor window batches {batches} ({run} plans): "
                  f"{w['requests']} requests, launches {w['launches']}, wall "
                  f"{w['wall_s']:.6f} s, device {w['device_s']:.6f} s; {n} of "
                  f"{len(w['launch_list'])} launches differ from the oracle's plan")
            for k in sorted(set(mine) | set(theirs)):
                print(f"#   class {k}: predictor {run_lengths(mine.get(k, []))} | "
                      f"oracle {run_lengths(theirs.get(k, []))}")
    return differ


def queued_per_gemm(desc, entry) -> dict:
    """Device ms per GEMM of the launch `Measurer` times at each CD, the
    launches queued behind a sleep of the card (`time_ms`), so the host's
    enqueue, which the Measurer's event pair includes, is left out."""
    out = {}
    for cd in (1, *MEASURED_CDS):
        reqs = [synth_request(desc, seed=i) for i in range(cd)]
        sched = schedule_for(desc, entry.tile_for_cd(cd), cd)
        out[cd] = time_ms(lambda: execute_schedule(reqs, sched)) / cd
    return out


def measure_phase(cfg, pred, lib, device) -> None:
    """(c) The four fused decode GEMMs at batch 8 measured on ``device`` at
    CD 1 and `MEASURED_CDS`, beside the library's modeled CD and the
    predictor's; then one re-ranked by measurement (`tune_gemm(...,
    measure=)`), its entry saved to a library file and loaded back.
    The only gate on timings: every one is finite."""
    mzr = Measurer(device=device)
    descs = [GemmDesc(8, n, k) for k, n in fused_shapes(cfg)]
    for d in descs:
        entry = lib.get(d)
        ms = mzr.measure_entry(d, entry, cds=MEASURED_CDS)
        bad = [cd for cd, m in ms.items() if not m.finite]
        if bad:
            raise AssertionError(f"{d.key()}: non-finite measurement at CDs {bad}")
        per_gemm = {cd: m.time_s / cd for cd, m in ms.items()}
        fastest = min(per_gemm, key=per_gemm.get)
        cd_pred = int(pred.predict_cd(op_features(d, lib), available=16)[0])
        print(f"# measured {d.key()} on {mzr.backend}: seconds per launch "
              f"{ {cd: m.time_s for cd, m in ms.items()} }, per GEMM "
              f"{per_gemm}; measured-fastest CD {fastest}, modeled "
              f"{entry.preferred_cd()}, predictor {cd_pred}; tiles "
              f"{ {cd: entry.tile_for_cd(cd).key() for cd in ms} }")
        if device == "cuda":
            print(f"#   device only (the same launches queued behind a sleep of "
                  f"the card, no host time): ms per GEMM {queued_per_gemm(d, entry)}")
    d = GemmDesc(8, cfg.n_heads * cfg.resolved_head_dim, cfg.d_model)
    entry = tune_gemm(d, measure=Measurer(device=device))
    bad = {cd: t for cd, t in entry.measured.items() if not math.isfinite(t)}
    if bad or set(entry.measured) != {1, *CDS}:
        raise AssertionError(f"{d.key()}: re-rank measured {entry.measured}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = Path(tmp) / "golib.json"
        saved = GOLibrary()
        saved._entries[d.key()] = entry
        saved.save(path)
        back = GOLibrary(path).entries()[d.key()]
    if (back.measured, back.measure_backend, back.measure_run_id) != (
            entry.measured, mzr.backend, entry.measure_run_id):
        raise AssertionError(f"{d.key()}: measured entry did not survive save/load")
    modeled = lib.get(d)
    moved = {cd: f"{modeled.go[cd].key()} -> {t.key()}" for cd, t in entry.go.items()
             if t != modeled.go[cd]}
    print(f"# re-ranked {d.key()} on {entry.measure_backend} (run {entry.measure_run_id}): "
          f"measured seconds {entry.measured}, sources {entry.rc_source}, GO tiles "
          f"moved {moved or 'none'}; saved and loaded back with its measured map")


def dynamic_logic_phase(cfg, weights, gen, device) -> None:
    """Training, serving through the predictor and measuring, with phase
    4's weights on the card.  Its launches are counted apart and the
    counters zeroed after it, so the `kernels` line counts only the
    serving paths."""
    lib = default_library()
    reset_counts()
    pred = train_phase(lib, device)
    differ = predicted_serving(cfg, weights, pred, gen, device)
    measure_phase(cfg, pred, lib, device)
    counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
    print(f"# dynamic logic: {differ} launches differ from the oracle's plans; "
          f"kernel launches of this phase (not in the kernels line) {counts}")
    reset_counts()


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
                members=dict(members), split_k=planned(launches, "split-K"),
                stream_k=planned(launches, "Stream-K"), wall_s=wall,
                device_s=sum(g.achieved_time_s or 0.0 for g in recs),
                request_weight_gb=sum(tk.request.b.numel() * 2 for tk in tickets) / 1e9,
                launch_list=launches)


def stream_k_schedule(rt: Runtime, gen) -> Counter:
    """One mixed schedule the planner makes for a bundle of four
    32×512×17408 GEMMs and three 1×5120×17408 ones: a CD-7 group whose
    members run Stream-K (32x128x128g8) and split-K tiles at once.
    Returns the GEMMs it ran by decomposition ("split-K s8", ...)."""
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
    return Counter(decomposition(descs[i], t) for g in sched.groups
                   for i, t in zip(g.indices, g.tiles or [g.tile] * len(g.indices)))


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
    sched = stream_k_schedule(rt, torch.Generator(device=device).manual_seed(SEED + 2))
    plan = {kind: sum(w[key] for w in windows) +
            sum(n for d, n in sched.items() if d.startswith(kind))
            for kind, key in (("split-K", "split_k"), ("Stream-K", "stream_k"))}
    counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
    print(f"# bundle serving modes {rt.telemetry.mode_counts()}; kernel launches {counts}; "
          f"GEMMs planned by decomposition {plan}")
    check_feeds("bundle serving", device)
    missing = [k for k in MIXED_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the bundle path never launched {missing}")
    for kind, name in (("split-K", "splitk_matmul"), ("Stream-K", "stream_k_matmul")):
        if device == "cuda" and counts[name] != plan[kind]:
            raise AssertionError(f"{counts[name]} {kind} launches for {plan[kind]} "
                                 f"{kind} GEMMs planned: a {kind} GEMM is one launch")
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
                           lambda: drive_bundles(rt, cfg, weights, batches, gen)[1::2])
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
    (16, 1, 64, 64, 64, 32, True, False),     # decode: a state, per-head B/C
    (1, 1, 64, 64, 64, 32, True, True),       # decode at batch 1: column slices
    (3, 1, 5, 30, 10, 16, True, False),       # decode: rows of 30 floats
    (2, 2, 64, 64, 64, 32, True, True),       # T = 2: the chunk loop
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


def scan_excess(y, state, xd, da, bm, cm, s0, what: str) -> dict:
    """y and the state against the plain version in f32 on the same inputs
    (bf16 converts exactly): for each, the max |err| and the elements
    beyond SCAN_TOL + rtol·|plain| (rtol: SCAN_TOL, plus half a bf16 unit
    for a bf16 y)."""
    y_ref, s_ref = ssd_chunk_ref(xd.float(), da.float(), bm.float(), cm.float(),
                                 chunk=64, initial_state=s0)
    rtol = SCAN_TOL + (2.0 ** -8 if y.dtype == torch.bfloat16 else 0.0)
    return {"y": tol_excess(y, y_ref, SCAN_TOL, rtol, what + " y"),
            "state": tol_excess(state, s_ref, SCAN_TOL, SCAN_TOL, what + " state")}


def check_scan(y, state, xd, da, bm, cm, s0, what: str) -> float:
    """`scan_excess` must find no element beyond the tolerance; returns y's
    max |err|."""
    ex = scan_excess(y, state, xd, da, bm, cm, s0, what)
    bad = {k: v for k, v in ex.items() if v[1]}
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(
            f"{k}: {n} elements beyond {SCAN_TOL} + rtol·|ref|, max |err| {e:.4g}"
            for k, (e, n) in bad.items()))
    return ex["y"][0]


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
            route, before = scan_route(T, P, N, L), dict(mamba_scan_fwd.routes)
            y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=L, initial_state=s0)
            if mamba_scan_fwd.routes[route] != before[route] + 1:
                raise AssertionError(f"{what}: not launched on the {route} route")
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
    member (eight operand sets, 134 MB), then `scan_rows`.  Each is
    compared, then timed beside its plain version and, for attention, the
    PyTorch call computing the same function."""
    rows = {"flash_attention": [attention_member(16, gen, lib),
                                attention_member(1, gen, lib)]}
    torch.cuda.empty_cache()
    rows["mamba_scan"] = scan_rows(gen, lib)
    torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"# {name:<15} {r['shape']:<60} kernel {r['ms']:.4f} ms | plain "
                  f"{r['plain_ms']:.4f} | torch {lib_ms} | bound {r['bound'][0]:.6f} "
                  f"({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


L2_BYTES = 50 * 2 ** 20


def decode_flops(B, H, P, N, with_s0: bool) -> int:
    """The decode kernel's multiply-adds ×2: per (batch, head) C·B, y's
    products and B xdᵀ, and with a state exp(da)·S0 and C·S0 as well."""
    return 2 * B * H * (N + P * (2 if with_s0 else 1) + N * P * (3 if with_s0 else 1))


def planted_scan_fault(y, state, xd, da, bm, cm, b: int = 8, h: int = 32) -> None:
    """The scan check's power at the decode shape: the kernel's state
    without the B xdᵀ term of (batch b, head h), which a kernel that
    skipped that pair's update would give, must fail `check_scan`.
    Prints how far off it is."""
    fault = state.clone()
    fault[b, h] -= bm[b, 0, h].float()[:, None] * xd[b, 0, h].float()[None, :]
    ex = scan_excess(y, fault, xd, da, bm, cm, None, "planted scan fault")
    err, n_bad = ex["state"]
    print(f"# planted scan fault (the B·xd term of (batch {b}, head {h}) dropped) at "
          f"{tuple(xd.shape)}: max |err| {err:.4g}; {n_bad} of {fault.numel()} state "
          f"elements beyond {SCAN_TOL} + {SCAN_TOL}·|ref|, so check_scan fails it")
    if not n_bad:
        raise AssertionError("check_scan lets a dropped B·xd term through")


def decode_row(B: int, with_s0: bool, gen, L: int) -> dict:
    """Zamba2's decode member at batch B (64 heads, P = N = 64, bf16, B/C
    head-broadcast), on the decode kernel: compared on the first set, then
    timed on output (and initial-state) sets that rotate beyond the 50 MB
    L2 — at least 4 — so each call writes (and reads) its state in HBM."""
    H, P, N = 64, 64, 64
    xd, da, bm, cm = scan_inputs(B, 1, H, P, N, gen, torch.bfloat16, broadcast=True)
    state_b = B * H * N * P * 4
    set_b = state_b * (2 if with_s0 else 1) + B * H * P * 2
    n_sets = max(4, -(-L2_BYTES * 5 // 4 // set_b))
    sets = [(randn((B, H, N, P), gen, torch.float32) if with_s0 else None,
             *scan_buffers(xd, da, bm, cm)) for _ in range(n_sets)]
    s0, y, state = sets[0]
    before = dict(mamba_scan_fwd.routes)
    mamba_scan_fwd(xd, da, bm, cm, chunk=L, initial_state=s0, out=(y, state))
    if mamba_scan_fwd.routes["decode"] != before["decode"] + 1:
        raise AssertionError(f"the decode member at B{B} missed the decode route")
    what = f"scan decode B{B} s0{with_s0:d}"
    err = check_scan(y, state, xd, da, bm, cm, s0, what)
    g = decode_grid(B * H, P, N, torch.cuda.get_device_properties(0).multi_processor_count)
    per_sm, smem = decode_residency(xd.device, torch.bfloat16, s0=with_s0)
    print(f"# mamba_scan decode grid at B{B} H{H} P{P} N{N}: {g.ctas} CTAs of 256 threads, "
          f"{g.pairs_per_cta} pair(s) per CTA, {g.slices} column slice(s) of "
          f"{4 * g.groups} columns per pair, {g.row_lanes} row lanes; {per_sm} CTAs per "
          f"SM, {smem} B static shared memory; {n_sets} rotating sets of "
          f"{set_b / 1e6:.2f} MB ({n_sets * set_b / 1e6:.1f} MB)")
    if B == 16 and not with_s0:
        planted_scan_fault(y, state, xd, da, bm, cm)
        src = state.clone()
        states = [(st,) for _, _, st in sets]
        copy_ms = time_ms(rotating(lambda st: st.copy_(src), states), reps=50)
        zero_ms = time_ms(rotating(lambda st: st.zero_(), states), reps=50)
        print(f"# write ceiling at B{B}: copy_ of the {state_b / 1e6:.1f} MB state into "
              f"the {n_sets} rotating state buffers {copy_ms:.4f} ms ({state_b / copy_ms / 1e9:.3f} "
              f"TB/s written, as much read); zero_ of them {zero_ms:.4f} ms "
              f"({state_b / zero_ms / 1e9:.3f} TB/s written)")
    nbytes = ((xd.numel() + da.numel() + 2 * B * N) * 2 + y.numel() * 2
              + state_b * (2 if with_s0 else 1))
    return dict(
        shape=(f"B{B} T1 H{H} P{P} N{N}, B/C head-broadcast"
               f"{', initial state' if with_s0 else ''} (decode)"),
        instantiation=f"bf16 decode, {g.ctas} CTAs, {smem} B shared",
        route="decode",
        grid=dict(ctas=g.ctas, slices=g.slices, pairs_per_cta=g.pairs_per_cta,
                  ctas_per_sm=per_sm, smem_bytes=smem, rotating_sets=n_sets),
        max_abs_err=err,
        ms=time_ms(rotating(lambda s, yy, st: mamba_scan_fwd(
            xd, da, bm, cm, chunk=L, initial_state=s, out=(yy, st)), sets), reps=50),
        plain_ms=time_ms(lambda: ssd_chunk_ref(xd, da, bm, cm, chunk=L,
                                               initial_state=s0), reps=3, warmup=1),
        library_ms=None,
        bound=bound(nbytes, decode_flops(B, H, P, N, with_s0), torch.bfloat16))


def scan_rows(gen, lib) -> list:
    """The scan's rows: Zamba2's tenant-16 decode member (the serving
    path's shape) without and with an initial state and its batch-1
    member, on the decode kernel and rotating outputs; then one long
    prefill (B1 T4096 L128) on the chunk loop, one set (1.1 MB of
    outputs)."""
    sdesc = ScanDesc(16, 1, 64, 64, 64)
    L = scan_chunk(lib.get(sdesc).isolated)
    rows = [decode_row(16, False, gen, L), decode_row(16, True, gen, L),
            decode_row(1, False, gen, L)]
    B, T, H, P, N, L = 1, 4096, 64, 64, 64, 128
    xd, da, bm, cm = scan_inputs(B, T, H, P, N, gen, torch.bfloat16, broadcast=True)
    before = dict(mamba_scan_fwd.routes)
    y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=L)
    if mamba_scan_fwd.routes["chunks"] != before["chunks"] + 1:
        raise AssertionError("the prefill row missed the chunk loop")
    err = check_scan(y, state, xd, da, bm, cm, None, f"scan main T{T}")
    # inputs read once (B/C: their (B,T,N) storage), y and the state written
    nbytes = (xd.numel() + da.numel() + 2 * B * T * N + y.numel()) * 2 + state.numel() * 4
    rows.append(dict(
        shape=f"B{B} T{T} H{H} P{P} N{N} L{L}, B/C head-broadcast (chunks)",
        instantiation="bf16, 32-row sub-blocks", route="chunks", max_abs_err=err,
        ms=time_ms(lambda: mamba_scan_fwd(xd, da, bm, cm, chunk=L, out=(y, state))),
        plain_ms=time_ms(lambda: ssd_chunk_ref(xd, da, bm, cm, chunk=L), reps=3,
                         warmup=1),
        library_ms=None,
        bound=bound(nbytes, scan_flops(B, T, H, P, N, L), torch.bfloat16)))
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
    check_feeds(f"{cfg.name} op-bundle serving", device)
    if device == "cuda" and (counts["flash_attention"] != members["flash_attention"]
                             or counts["mamba_scan"] != members["mamba_scan"]):
        raise AssertionError(f"{cfg.name}: attention/scan launches {counts} differ from "
                             f"the members submitted {dict(members)}")
    routes = dict(mamba_scan_fwd.routes)
    if members["mamba_scan"]:
        print(f"# {cfg.name} op-bundle scan launches by route {routes}: "
              f"{routes['decode']} of {members['mamba_scan']} scan members on the decode "
              "kernel, each ticket's y within the scan tolerance of ssd_chunk_ref")
        if device == "cuda" and (routes["decode"] != members["mamba_scan"]
                                 or routes["chunks"]):
            raise AssertionError(f"{cfg.name}: scan launches by route {routes}; every "
                                 f"one of the {members['mamba_scan']} decode members "
                                 "must take the decode kernel")
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
                               rt, cfg, weights, kv, batches, context, gen)[1::2])
    for w in windows:
        del w["launch_list"]
    return dict(counts=counts, scan_routes=routes, windows=windows, model_gb=model_gb,
                kv_gb=kv_gb)


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
    print(f"# card-only tests: {card_tests_phase()}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print(f"# kernels: {small_cases(gen)} small cases agree with their plain versions")
    print(f"# split-K and Stream-K kernels: {split_stream_cases(gen)} small cases "
          "agree with their plain versions")
    print(f"# attention and scan kernels: {attention_scan_cases(gen)} small cases agree "
          "with their plain versions")
    rows = main_path_kernels(gen)
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
    scan_routes = {k: sum(o["scan_routes"][k] for o in ops.values())
                   for k in mamba_scan_fwd.routes}
    missing = [k for k in OP_BUNDLE_KERNELS if op_counts[k] <= 0]
    if missing:
        raise AssertionError(f"the op-bundle path never launched {missing}")
    kernels = []
    for name, replaces in REPLACES:
        r, *more = rows[name]
        path = (serving if name in PER_CLASS_KERNELS else
                {"counts": op_counts} if name in OP_BUNDLE_KERNELS else mixed)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "shape": r["shape"],
            **({"folded": "the reduce is splitk_matmul's cluster epilogue; the row "
                          "times the whole one-launch GEMM"}
               if replaces.endswith("_reduce_kernel") else {}),
            **({"folded": "the fixup is stream_k_matmul's arrival epilogue; the row "
                          "times the whole one-launch GEMM"}
               if replaces.endswith("_stream_k_fixup_kernel") else {}),
            "instantiation": r["instantiation"], "launches": path["counts"][name],
            **({"launches_by_route": scan_routes} if name == "mamba_scan" else {}),
            **({"route": r["route"]} if "route" in r else {}),
            **({"grid": r["grid"]} if "grid" in r else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({"feed": r["feed"], "ring_ms": r["ring_ms"]} if "feed" in r else {}),
            **({"host_us": r["host_us"]} if "host_us" in r else {}),
            **({"more_shapes": [{
                "shape": m["shape"], **({"route": m["route"]} if "route" in m else {}),
                **({"grid": m["grid"]} if "grid" in m else {}),
                **({"feed": m["feed"], "ring_ms": m["ring_ms"]} if "feed" in m else {}),
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
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
