#!/usr/bin/env python3
"""Times the SSD scan's decode step of one tree of this repository on the
card, on outputs (and initial states) that rotate beyond the 50 MB L2, as
`chip_smoke.py:decode_row` times it.

    python3 probes/scan_decode/ab.py TREE LABEL [--bulk]

TREE is the root of a checkout: this one, or a parent commit unpacked by
``git archive``.  Its ``src/`` is imported and its kernels are built, and
its `mamba_scan_fwd` runs Zamba2's decode member (64 heads, P = N = 64,
bf16, B/C head-broadcast) at batch 16 and 1, without and with an initial
state: one call checked against the tree's `ssd_chunk_ref`, then the
mean device time of 50 calls (CUDA events, the calls queued behind a
sleep of the card), with 4 sets at batch 16 and 63 at batch 1.  With
``--bulk`` it also builds `bulk_store.cu` beside this file (write path
(b): the state built in shared memory and written by a bulk asynchronous
copy) and times it on the same sets and grid, in turns with the tree's
kernel (a, b, b, a), where the grid takes whole pairs.  With
``--ceiling`` it also times, without an initial state, ``copy_`` of one
state into the rotating state buffers and ``zero_`` of them: what the
card writes at this size through PyTorch's own kernels.  With
``--variants`` it builds `variants.cu` beside this file in its three
modes (the decode kernel's store stream stripped: stores only; loads and
evict-first stores; loads and plain stores) and times each, without an
initial state, on the same sets and grid.  Prints the card's name and
power limit, then one JSON line per timing.
"""
from __future__ import annotations

import argparse
import ctypes
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


def build(kernel_module, source: str, *defines: str) -> ctypes.CDLL:
    """``source`` (beside this file) built with the tree's nvcc flags and
    its csrc/ on the include path, loaded with the launcher's signatures."""
    b = kernel_module._build
    here = Path(__file__).resolve().parent
    out = b.BUILD_DIR / f"probe_{Path(source).stem}{''.join(defines)}.so"
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I",
                    str(b.CSRC), "-o", str(out), str(here / source)], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in kernel_module._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
    return lib


def check(y, state, xd, da, bm, cm, s0, ref, what: str) -> float:
    y_ref, s_ref = ref(xd.float(), da.float(), bm.float(), cm.float(), chunk=64,
                       initial_state=s0)
    errs = []
    for out, want, rtol in ((y, y_ref, SCAN_TOL + 2.0 ** -8), (state, s_ref, SCAN_TOL)):
        err = (out.float() - want).abs()
        if not bool((err <= SCAN_TOL + rtol * want.abs()).all()):
            raise AssertionError(f"{what}: max |err| {err.max().item():.4g}")
        errs.append(float(err.max()))
    return max(errs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--bulk", action="store_true")
    ap.add_argument("--ceiling", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels.mamba_scan import kernel as K
    from repro_torch.kernels.mamba_scan.ref import ssd_chunk_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    bulk = build(K, "bulk_store.cu") if args.bulk else None
    modes = ({f"mode{m}": build(K, "variants.cu", f"MODE={m}") for m in range(3)}
             if args.variants else {})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H = P = N = 64
    for B, with_s0 in ((16, False), (16, True), (1, False), (1, True)):
        gen = torch.Generator(device="cuda").manual_seed(B + with_s0)
        xd = torch.randn((B, 1, H, P), generator=gen, device="cuda").to(torch.bfloat16)
        da = (torch.rand((B, 1, H), generator=gen, device="cuda") * -0.5).to(torch.bfloat16)
        bm, cm = (torch.randn((B, 1, 1, N), generator=gen, device="cuda").mul_(0.5)
                  .to(torch.bfloat16).expand(B, 1, H, N) for _ in range(2))
        set_b = B * H * N * P * 4 * (2 if with_s0 else 1) + B * H * P * 2
        n_sets = max(4, -(-L2_BYTES * 5 // 4 // set_b))
        sets = [(torch.randn((B, H, N, P), generator=gen, device="cuda") if with_s0
                 else None,
                 torch.empty((B, 1, H, P), device="cuda", dtype=torch.bfloat16),
                 torch.empty((B, H, N, P), device="cuda")) for _ in range(n_sets)]

        def tree_call(s0, y, st):
            K.mamba_scan_fwd(xd, da, bm, cm, chunk=32, initial_state=s0, out=(y, st))

        variants = {"tree": tree_call}
        grid = K.decode_grid(B * H, P, N, sms) if hasattr(K, "decode_grid") else None
        if bulk is not None and grid is not None and grid.slices == 1:
            def bulk_call(s0, y, st, grid=grid):
                code = K._decode_launch(bulk, xd, da, bm, cm, s0, y, st, grid)
                if code:
                    raise RuntimeError(f"bulk launch failed: {code}")
            variants["bulk"] = bulk_call
        order = ["tree", "bulk", "bulk", "tree"] if "bulk" in variants else ["tree", "tree"]
        errs = {}
        for name, lib in modes.items():
            if with_s0 or grid is None:
                continue

            def mode_call(s0, y, st, lib=lib, grid=grid):
                code = K._decode_launch(lib, xd, da, bm, cm, s0, y, st, grid)
                if code:
                    raise RuntimeError(f"variant launch failed: {code}")
            variants[name] = mode_call
            order.append(name)
            errs[name] = 0.0
        if args.ceiling and not with_s0:
            src = torch.randn((B, H, N, P), generator=gen, device="cuda")
            variants["copy_"] = lambda s0, y, st: st.copy_(src)
            variants["zero_"] = lambda s0, y, st: st.zero_()
            order += ["copy_", "zero_"]
            errs["copy_"] = errs["zero_"] = 0.0
        for name in ("tree", "bulk"):
            if name not in variants:
                continue
            variants[name](*sets[0])
            torch.cuda.synchronize()
            errs[name] = check(sets[0][1], sets[0][2], xd, da, bm, cm, sets[0][0],
                               ssd_chunk_ref, f"{args.label} {name} B{B} s0{with_s0:d}")
        for name in order:
            ms = device_ms(rotating(variants[name], sets))
            print(json.dumps({"label": args.label, "variant": name, "B": B,
                              "s0": with_s0, "sets": n_sets,
                              "set_mb": set_b / 1e6, "ms": ms,
                              "max_abs_err": errs[name]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
