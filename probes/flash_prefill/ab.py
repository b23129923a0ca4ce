#!/usr/bin/env python3
"""Times the flash-attention kernel of one tree of this repository at the
ten prefill shapes of `chip_smoke.py` (the models', the zoo's and a rank's
of four), beside ``scaled_dot_product_attention``.

    python3 probes/flash_prefill/ab.py TREE LABEL [--threshold] [--only N,...]

TREE is the root of a checkout: this one, or a parent commit unpacked by
``git archive`` into an ignored directory.  Its ``src/`` is imported and
its kernels are built.  Each shape is built as `chip_smoke.py:
model_attention_row` builds it (bf16; q a transposed (B, T, Hq, D) view,
k and v transposed views of a (B, S, Hkv, D) cache whose first T rows
are random; causal, q_offset 0, Gemma3's window), one call is held to
the tree's `flash_ref` on f32 copies within its `attention_tol`, then
the mean device time of 20 calls is taken (CUDA events, the calls queued
behind a sleep of the card) for the tree's `flash_attention_fwd` and for
SDPA on the same inputs.  ``--threshold`` also times both routes of a
tree that has two (its `attention_route`) at T = 16, 32, 64 and 128 for
Qwen3-14B's, Zamba2-1.2B's and DeepSeek-V2-Lite's widths, from a prompt
(S = T) and after 1,024 cached keys (S = 1,024 + T, q_offset 1,024), by
moving the tree's `PREFILL_MIN_T` for the run.  Prints the card's name
and power limit, then one JSON line per timing.  Put parent and change
in one call and run them in turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

SLEEP_CYCLES = 500_000_000
# (name, (B, Hq, Hkv, T, S, D, Dv, window)): chip_smoke.py's MODEL_ATTENTION,
# ZOO_ATTENTION and TP_ATTENTION
SHAPES = (
    ("qwen3-14b", (4, 40, 8, 1000, 1033, 128, 128, 0)),
    ("zamba2-1.2b", (4, 32, 32, 1000, 1033, 64, 64, 0)),
    ("deepseek-v2-lite-16b", (4, 16, 16, 1000, 1000, 192, 128, 0)),
    ("gemma3-27b local", (4, 32, 16, 2048, 2057, 128, 128, 1024)),
    ("stablelm-3b", (4, 32, 32, 1000, 1009, 80, 80, 0)),
    ("qwen2-72b", (4, 64, 8, 1000, 1009, 128, 128, 0)),
    ("pixtral-12b", (4, 32, 8, 1000, 1009, 128, 128, 0)),
    ("deepseek-v2-236b", (4, 128, 128, 1000, 1000, 192, 128, 0)),
    ("qwen3-14b M4 rank", (4, 10, 2, 1000, 1009, 128, 128, 0)),
    ("deepseek-v2-lite-16b M4 rank", (4, 4, 4, 1000, 1000, 192, 128, 0)),
)
THRESHOLD_WIDTHS = (("qwen3-14b", 4, 40, 8, 128, 128), ("zamba2-1.2b", 4, 32, 32, 64, 64),
                    ("deepseek-v2-lite-16b", 4, 16, 16, 192, 128))
THRESHOLD_T = (16, 32, 64, 128)


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def operands(gen, B, Hq, Hkv, T, S, D, Dv):
    bf16 = torch.bfloat16
    q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(bf16).transpose(1, 2)
    k = torch.zeros((B, S, Hkv, D), dtype=bf16, device="cuda")
    v = torch.zeros((B, S, Hkv, Dv), dtype=bf16, device="cuda")
    k[:, :T] = torch.randn((B, T, Hkv, D), generator=gen, device="cuda").to(bf16)
    v[:, :T] = torch.randn((B, T, Hkv, Dv), generator=gen, device="cuda").to(bf16)
    return q, k.transpose(1, 2), v.transpose(1, 2)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--threshold", action="store_true")
    ap.add_argument("--only", default="", help="comma-separated indices of SHAPES")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_tol, flash_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    routes = getattr(K, "attention_route", None)
    only = {int(i) for i in args.only.split(",") if i}
    for i, (name, (B, Hq, Hkv, T, S, D, Dv, window)) in enumerate(SHAPES):
        if only and i not in only:
            continue
        q, k, v = operands(gen, B, Hq, Hkv, T, S, D, Dv)
        kw = dict(causal=True, window=window, q_offset=0)
        out = K.flash_attention_fwd(q, k, v, **kw)
        ref = flash_ref(q.float(), k.float(), v.float(), **kw)
        atol, rtol = attention_tol(torch.bfloat16)
        err = (out.float() - ref).abs()
        if not bool((err <= atol + rtol * ref.abs()).all()):
            raise AssertionError(f"{args.label} {name}: max |err| {err.max().item():.4g}")
        if window:
            i_ = torch.arange(T, device="cuda")[:, None]
            j_ = torch.arange(S, device="cuda")[None, :]
            mask = (j_ <= i_) & (i_ - j_ < window)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
        ms = device_ms(lambda: K.flash_attention_fwd(q, k, v, **kw))
        print(json.dumps({"label": args.label, "shape": name, "dims": [B, Hq, Hkv, T, S, D, Dv,
                                                                      window],
                          "route": routes(q, k, v) if routes else "decode",
                          "ms": ms, "sdpa_ms": device_ms(sdpa), "max_abs_err": float(err.max())}),
              flush=True)
        del q, k, v, out, ref, err
        torch.cuda.empty_cache()
    if args.threshold and routes:
        keep = K.PREFILL_MIN_T
        for name, B, Hq, Hkv, D, Dv in THRESHOLD_WIDTHS:
            for past in (0, 1024):
                for T in THRESHOLD_T:
                    q, k, v = operands(gen, B, Hq, Hkv, T, past + T, D, Dv)
                    k[:, :, :past] = torch.randn(k[:, :, :past].shape, generator=gen,
                                                 device="cuda").to(k.dtype)
                    v[:, :, :past] = torch.randn(v[:, :, :past].shape, generator=gen,
                                                 device="cuda").to(v.dtype)
                    kw = dict(causal=True, q_offset=past)
                    ref = flash_ref(q.float(), k.float(), v.float(), **kw)
                    atol, rtol = attention_tol(torch.bfloat16)
                    times = {}
                    for route, min_t in (("decode", 10 ** 9), ("prefill", 1)):
                        K.PREFILL_MIN_T = min_t
                        assert routes(q, k, v) == route
                        out = K.flash_attention_fwd(q, k, v, **kw)
                        err = (out.float() - ref).abs()
                        if not bool((err <= atol + rtol * ref.abs()).all()):
                            raise AssertionError(f"{name} T{T} {route}: max |err| "
                                                 f"{err.max().item():.4g}")
                        times[route] = device_ms(lambda: K.flash_attention_fwd(q, k, v, **kw))
                    K.PREFILL_MIN_T = keep
                    print(json.dumps({"label": args.label, "what": "threshold", "shape": name,
                                      "T": T, "S": past + T, "q_offset": past,
                                      "decode_ms": times["decode"],
                                      "prefill_ms": times["prefill"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
