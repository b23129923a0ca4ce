#!/usr/bin/env python3
"""Only `chip_smoke.py`'s model phase on one H100: the kernels built, the
card-only model tests (`-k reduced_model`), then (a), (b) and (c) of the
model phase, as `chip_smoke.py` runs them after its other phases.

    python3 probes/model_serve/run.py [--skip-tests]
"""
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("model_serve probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    chip_smoke.build_phase()
    if "--skip-tests" not in sys.argv:
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); import pytest; "
                "sys.exit(pytest.main(['--noconftest', '-p', 'no:cacheprovider', '-m', "
                f"'cuda', '-q', '-k', 'reduced_model', {str(ROOT / 'tests' / 'test_torch_card.py')!r}]))")
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True)
        print(r.stdout[-4000:], r.stderr[-2000:], sep="\n")
        if r.returncode:
            return 1
    chip_smoke.model_phase()
    chip_smoke.model_kernel_rows(torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
    return 0


if __name__ == "__main__":
    sys.exit(main())
