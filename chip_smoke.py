#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # one NVIDIA H100; builds the kernels

Phases, each fatal on failure (nothing here catches an error):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port compiled with ``nvcc``, one
   process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs — a few dozen small cases with ragged M/N/K (and, for the
   single GEMM, every ``ta``/``tb`` layout), then the serving path's
   shapes, where the kernel, its plain version and the one PyTorch call
   computing the same function are timed with CUDA events;
4. serving: a full-width, full-depth Qwen3-14B weight set (40 layers × the
   four bf16 decode GEMMs, ~26.4 GB, random from a seed) served through
   the port's `Runtime` to tenants at batches [8, 8, 8, 8] (grouped
   launches) and [4, 8, 8, 8, 16] (ragged launches), each window run
   twice (cold plan cache, then warm); every result is held against the
   plain version, and the launch counters, zeroed just before the first
   window, must show all three kernels;
5. one JSON line ``{"kernels": [...]}`` and, last, the device line.

Tolerance of every comparison (float32, kernel vs plain version on the
same inputs): |kernel − plain| ≤ 2⁻⁷·|plain| + 2⁻¹⁶·(|A|·|B|).  The first
term is the bf16 output rounding: both sides round an f32 sum to 8
significant bits once, and two sums a hair apart may land one bf16 ulp
(≤ 2⁻⁸ relative, 2⁻⁷ just below a power of two) apart; it is 0 for f32
outputs.  The second is the f32 summation-order difference, which grows
with K: the kernel sums 16-wide tensor-core products in K order, the
plain version in cuBLAS's order, each add rounding at 2⁻²⁴ of its
partial sum; at random signs these errors add like a random walk,
~√K·2⁻²⁴·Σ|a·b| ≤ 2⁻¹⁶·Σ|a·b| for K ≤ 2¹⁶.  A dropped or doubled k tile
or a wrong group moves the result by far more.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import ConcurrencyController, GemmRequest  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gemm import gemm_ref  # noqa: E402
from repro_torch.kernels.gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.grouped_gemm import (  # noqa: E402
    grouped_gemm_ref,
    ragged_gemm_ref,
)
from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel  # noqa: E402
from repro_torch.kernels.grouped_gemm.ops import block_groups  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    Runtime,
    RuntimeConfig,
    decode_step_requests,
)

SEED = 0
# H100 SXM data-sheet peaks (dense): HBM bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPLACES = {
    "matmul": "src/repro/kernels/gemm/kernel.py:45 _matmul_kernel",
    "grouped_matmul": "src/repro/kernels/grouped_gemm/kernel.py:41 _grouped_kernel",
    "ragged_matmul": "src/repro/kernels/grouped_gemm/kernel.py:93 _ragged_kernel",
}
SOURCES = {
    "matmul": "src/repro_torch/csrc/gemm.cu",
    "grouped_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
    "ragged_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
}
LAUNCHERS = {
    "matmul": gemm_kernel.matmul,
    "grouped_matmul": grouped_kernel.grouped_matmul,
    "ragged_matmul": grouped_kernel.ragged_matmul,
}


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


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
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
        plain_ms=time_ms(lambda: ragged_gemm_ref(a, b, gs), reps=5),
        library_ms=time_ms(lambda: torch.bmm(a.view(G, bm, K), b)),
        bound=bound((Mtotal * K + G * K * N + Mtotal * N) * 2,
                    2 * Mtotal * N * K, bf16))
    for name, r in rows.items():
        print(f"# {name:<15} {r['shape']:<40} [{r['instantiation']}] kernel "
              f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} | torch "
              f"{r['library_ms']:.4f} | bound {r['bound'][0]:.4f} "
              f"({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
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
                ("ragged_kernel", "ragged_matmul"), ("Cat", "stack/cat copy"),
                ("reduce", "isfinite checks"))


def profile_window(rt: Runtime, cfg, weights: list, batches, gen) -> None:
    """One more warm window under `torch.profiler`: device time by kernel
    kind, and the device's busy and idle shares of the window's wall time
    (the profiler's own overhead lengthens that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall, _, _ = drive_window(rt, cfg, weights, batches, gen)
    by_kind, busy = {}, 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        busy += us
        kind = next((k for pat, k in KERNEL_KINDS if pat in evt.key), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    if busy == 0.0:
        print(f"# profiled window batches {batches}: the profiler recorded "
              "no device time (per-launch CUDA-event times are above)")
        return
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy:.1%})"
                      for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]))
    print(f"# profiled window batches {batches}: wall {wall:.6f} s, device busy "
          f"{busy / 1e6:.6f} s (idle {1 - busy / 1e6 / wall:.1%}); {parts}")


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
    tiles = sum((w["tiles"] for w in windows), Counter())
    print(f"# serving CTA tiles (kernel, instantiation): {dict(tiles)}")
    if not {"grouped", "ragged"} <= set(modes) or not (
            modes.get("single", 0) + modes.get("fused", 0)):
        raise AssertionError(f"serving did not run every launch mode: {modes}")
    if device == "cuda":
        for batches in ([8, 8, 8, 8], [4, 8, 8, 8, 16]):
            profile_window(rt, cfg, weights, batches, gen)
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
    rows = main_path_kernels(gen)
    torch.cuda.empty_cache()
    serving = serving_phase()
    kernels = []
    for name, r in rows.items():
        launches = serving["counts"][name]
        if launches <= 0:
            raise AssertionError(f"{name} never launched on the serving path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "shape": r["shape"],
            "instantiation": r["instantiation"], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
