#!/usr/bin/env python3
"""A/B of the walls around remat: one tree's served decode step and
training step, to run on one H100 in turns with another tree (parent,
change, change, parent) in one call.

    python3 probes/dist/ab.py <tree> <label>

For the tree at ``<tree>`` (its own `chip_smoke.py` and `src/`): builds
its kernels, serves Qwen3-14B and Zamba2-1.2B at full width and depth as
`chip_smoke.model_serve` does (bf16, batch 4, 1,000-token prompts, 32
greedy steps; no profile) and trains Zamba2-1.2B through
`repro_torch.launch.train` for 8 steps (bf16, batch 4 × 512, no
checkpoints), and prints one line: the prefill ms, the median decode
step ms and the median of training steps 3-8 (CUDA events).
"""
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    tree, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_phase()
    served = {name: cs.model_serve(name, profile_steps=0)
              for name in ("qwen3-14b", cs.ZAMBA)}
    cs.free()
    marks: list = []
    cs.train_launcher.make_train_step = cs.timed_steps(marks)
    with tempfile.TemporaryDirectory() as tmp:
        cs.train_launcher.main(["--arch", cs.ZAMBA, "--ckpt-dir", tmp, "--batch", "4",
                                "--seq", "512", "--steps", "8", "--ckpt-every", "0",
                                "--log-every", "0"])
    steps = [a.elapsed_time(b) for a, b in marks]
    print(f"AB {label}: " + "; ".join(
        f"{n} prefill {r['prefill_ms']:.3f} ms, decode step {r['decode_ms']:.3f} ms"
        for n, r in served.items())
        + f"; zamba2-1.2b train step median {statistics.median(steps[2:]):.3f} ms "
        f"(steps {[round(t, 3) for t in steps]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
