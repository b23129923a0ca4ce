#!/usr/bin/env python3
"""Times the SSD scan's chunks route (every T > 1) of one tree of this
repository on the card, as `chip_smoke.py:scan_rows` and its prompt-scan
phase time it.

    python3 probes/scan_chunks/ab.py TREE LABEL [--f32] [--profile] [--heads {1,2}]

TREE is the root of a checkout: this one, or a parent commit unpacked by
``git archive``.  Its ``src/`` is imported and its kernels are built, and
its `mamba_scan_fwd` runs Zamba2-1.2B's prompt scan (B1 T4096, 64 heads,
P = N = 64, L 128, bf16, B/C head-broadcast views): one call checked
against the tree's `ssd_chunk_ref`, then the mean device time of 20 calls
(CUDA events, the calls queued behind a sleep of the card) on input and
output sets that rotate beyond the 50 MB L2 (two sets of ~70 MB); then
the mean over 38 calls on 38 distinct input sets (one per Zamba2 layer,
the prompt phase's launches).  ``--f32`` times the f32 instantiation at
the same shape (two sets).  ``--profile`` runs four calls under
`torch.profiler` and prints the device time of each kernel name.
``--heads`` makes every CTA of the tree's chunked form take that many
heads (its `kernel.chunk_heads_per_cta`, by default 2 in bf16 and 1 in
f32 at this shape).  Prints the card's name and power limit, then one
JSON line per timing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from itertools import cycle
from pathlib import Path

import torch

SLEEP_CYCLES = 500_000_000
L2_BYTES = 50 * 2 ** 20
SCAN_TOL = 3e-4
B, T, H, P, N, L = 1, 4096, 64, 64, 64, 128
LAYERS = 38


def device_ms(fn, reps: int, warmup: int = 2) -> float:
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


def inputs(gen, dtype):
    xd = torch.randn((B, T, H, P), generator=gen, device="cuda").to(dtype)
    da = (torch.rand((B, T, H), generator=gen, device="cuda") * -0.5).to(dtype)
    bm, cm = (torch.randn((B, T, 1, N), generator=gen, device="cuda").mul_(0.5)
              .to(dtype).expand(B, T, H, N) for _ in range(2))
    return xd, da, bm, cm


def check(y, state, xd, da, bm, cm, ref, what: str) -> float:
    y_ref, s_ref = ref(xd.float(), da.float(), bm.float(), cm.float(), chunk=64)
    rtol_y = SCAN_TOL + (2.0 ** -8 if y.dtype == torch.bfloat16 else 0.0)
    errs = []
    for out, want, rtol in ((y, y_ref, rtol_y), (state, s_ref, SCAN_TOL)):
        err = (out.float() - want).abs()
        if not bool((err <= SCAN_TOL + rtol * want.abs()).all()):
            raise AssertionError(f"{what}: max |err| {err.max().item():.4g}")
        errs.append(float(err.max()))
    return max(errs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--heads", type=int, choices=(1, 2))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels.mamba_scan import kernel as K
    from repro_torch.kernels.mamba_scan.ref import ssd_chunk_ref
    if args.heads:
        K.chunk_heads_per_cta = lambda *_: args.heads

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def call(xd, da, bm, cm, y, st):
        K.mamba_scan_fwd(xd, da, bm, cm, chunk=L, out=(y, st))

    for dtype in (torch.bfloat16, torch.float32) if args.f32 else (torch.bfloat16,):
        sets = []
        for _ in range(2):
            ins = inputs(gen, dtype)
            sets.append((*ins, torch.empty((B, T, H, P), device="cuda", dtype=dtype),
                         torch.empty((B, H, N, P), device="cuda")))
        call(*sets[0])
        torch.cuda.synchronize()
        err = check(sets[0][4], sets[0][5], *sets[0][:4], ssd_chunk_ref,
                    f"{args.label} {dtype}")
        it = cycle(sets)
        ms = device_ms(lambda: call(*next(it)), reps=20)
        print(json.dumps({"label": args.label, "what": "prefill row", "dtype": str(dtype),
                          "heads": args.heads, "sets": len(sets), "ms": ms,
                          "max_abs_err": err}))
        if args.profile:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for s in sets * 2:
                    call(*s)
                torch.cuda.synchronize()
            kernels = {e.key: (e.count, e.self_device_time_total / e.count / 1e3)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.count}
            print(json.dumps({"label": args.label, "what": "profile", "dtype": str(dtype),
                              "kernels_ms_per_launch": kernels}))
        del sets
        torch.cuda.empty_cache()

    layers = [inputs(gen, torch.bfloat16) for _ in range(LAYERS)]
    y = torch.empty((B, T, H, P), device="cuda", dtype=torch.bfloat16)
    st = torch.empty((B, H, N, P), device="cuda")
    it = cycle(layers)
    ms = device_ms(lambda: call(*next(it), y, st), reps=LAYERS)
    print(json.dumps({"label": args.label, "what": "prompt scans", "layers": LAYERS,
                      "ms_per_launch": ms, "ms_all": ms * LAYERS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
