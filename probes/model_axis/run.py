#!/usr/bin/env python3
"""Only `chip_smoke.py`'s model-axis phase (13) on one H100: the kernels
built, then the phase as `chip_smoke.py` runs it after its other phases.

    python3 probes/model_axis/run.py [--dtypes float32,bfloat16] [--serving-only]

``--dtypes``: run the phase's serving (`tp_serving`) in each dtype named,
reporting a failed check and going on to the next (the phase itself
serves in `TP_DTYPE` and fails at once); ``--serving-only`` leaves out
the launcher and the kernel rows.
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("model axis probe: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    chip_smoke.build_phase()
    dtypes = [chip_smoke.TP_DTYPE]
    if "--dtypes" in sys.argv:
        dtypes = [getattr(torch, d) for d in sys.argv[sys.argv.index("--dtypes") + 1].split(",")]
    failed = 0
    for dtype in dtypes:
        t1 = time.perf_counter()
        try:
            chip_smoke.tp_serving(dtype)
        except AssertionError as e:
            failed += 1
            print(f"# model axis serving in {dtype} FAILED: {e}")
        print(f"# model axis serving in {dtype}: {time.perf_counter() - t1:.1f} s")
    if "--serving-only" not in sys.argv:
        chip_smoke.tp_nccl_refused()
        chip_smoke.tp_launcher()
        chip_smoke.tp_kernel_rows(torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
    print(f"# model axis probe: {time.perf_counter() - t0:.1f} s (host clock)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
