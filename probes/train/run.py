#!/usr/bin/env python3
"""Only `chip_smoke.py`'s training phase on one H100: the kernels built,
the card-only training tests (`-k "grad or train"`), optionally the model
phase (``--models``: serving on the reference's init), then the training
phase, as `chip_smoke.py` runs them after its other phases.

    python3 probes/train/run.py [--skip-tests] [--models]
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
        print("train probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    chip_smoke.build_phase()
    if "--skip-tests" not in sys.argv:
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); import pytest; "
                "sys.exit(pytest.main(['--noconftest', '-p', 'no:cacheprovider', '-m', "
                "'cuda', '-q', '-k', 'grad or train or reduced_model', "
                f"{str(ROOT / 'tests' / 'test_torch_card.py')!r}]))")
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True)
        print(r.stdout[-6000:], r.stderr[-2000:], sep="\n")
        if r.returncode:
            return 1
    if "--models" in sys.argv:
        chip_smoke.model_phase()
        chip_smoke.free()
    chip_smoke.training_phase()
    return 0


if __name__ == "__main__":
    sys.exit(main())
