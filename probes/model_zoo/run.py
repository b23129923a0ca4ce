#!/usr/bin/env python3
"""Only `chip_smoke.py`'s model zoo (phase 10d) on one H100, in parts:

    tests  the kernels built, then the card-only tests of the wide scan,
           of split-KV attention (Gemma3's windowed and StableLM's D 80
           prefills among them) and of the reduced models
           (`-k "wide or split_kv or reduced_model"`);
    rows   the zoo's kernel rows (`zoo_kernel_rows`: the new attention
           shapes, DeepSeek-V2-236B's grouped up-projection, xLSTM's wide
           scans) and Zamba2's scan rows (`scan_rows`, row 9 of PERF.md
           section 6), as `chip_smoke.py` times them;
    zoo    (a) and (b) of phase 10d (`zoo_phase`).

    python3 probes/model_zoo/run.py [--parts tests,rows,zoo]
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

TESTS = "wide or split_kv or reduced_model"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="tests,rows,zoo")
    parts = set(ap.parse_args().parts.split(","))
    if not torch.cuda.is_available():
        print("model_zoo probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    t0 = time.perf_counter()
    chip_smoke.build_phase()
    print(f"# built in {time.perf_counter() - t0:.1f} s")
    log = (chip_smoke._build.BUILD_DIR / "mamba_scan.log").read_text().splitlines()
    for i, line in enumerate(log):   # the wide kernels' registers and spills
        if "wide" in line and "Compiling" in line:
            print("#  ", *log[i:i + 4], sep="\n#   ")
    if "tests" in parts:
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); import pytest; "
                "sys.exit(pytest.main(['--noconftest', '-p', 'no:cacheprovider', '-m', "
                f"'cuda', '-q', '-k', {TESTS!r}, "
                f"{str(ROOT / 'tests' / 'test_torch_card.py')!r}]))")
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True)
        print(r.stdout[-6000:], r.stderr[-3000:], sep="\n")
        if r.returncode:
            return 1
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    if "rows" in parts:
        chip_smoke.zoo_kernel_rows(gen)
        torch.cuda.empty_cache()
        chip_smoke.print_rows({"mamba_scan": chip_smoke.scan_rows(
            gen, chip_smoke.default_library())})
        torch.cuda.empty_cache()
    if "zoo" in parts:
        chip_smoke.zoo_phase()
    print(f"# probe: {time.perf_counter() - t0:.1f} s (host clock)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
