#!/usr/bin/env python3
"""Only `chip_smoke.py`'s distribution phase (12) on one H100: the kernels
built, the card-only remat tests (`-k remat`), then the phase as
`chip_smoke.py` runs it after its other phases.

    python3 probes/dist/run.py [--skip-tests] [--train]

``--train``: the training phase (11) first, as in the whole script.
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
        print("dist probe: no CUDA device", file=sys.stderr)
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
    if "--skip-tests" not in sys.argv:
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); import pytest; "
                "sys.exit(pytest.main(['--noconftest', '-p', 'no:cacheprovider', '-m', "
                f"'cuda', '-q', '-k', 'remat', {str(ROOT / 'tests' / 'test_torch_card.py')!r}]))")
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True)
        print(r.stdout[-6000:], r.stderr[-2000:], sep="\n")
        if r.returncode:
            return 1
    if "--train" in sys.argv:
        chip_smoke.training_phase()
        chip_smoke.free()
    chip_smoke.dist_phase()
    print(f"# dist probe: {time.perf_counter() - t0:.1f} s (host clock)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
