"""Rules the port keeps: it imports nothing of JAX or of the JAX package,
its entry points never carry on on the CPU when asked for CUDA, no `try`
falls back to a plain version (the runtime's fallback ladder catches the
launch faults alone and runs kernels on every rung), and nothing is
switched by an environment variable beyond the toolkit's location."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import GemmRequest, requests_from_numpy
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.kernels.gemm import TileConfig, gemm
from repro_torch.kernels.gemm.kernel import LAUNCHERS
from repro_torch.runtime import Runtime

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def _tries(tree: ast.AST, scope: str = ""):
    """``(qualified name of the enclosing function or class, Try node)`` of
    every `try` in ``tree``."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield from _tries(node, f"{scope}.{node.name}".lstrip("."))
        else:
            if isinstance(node, ast.Try):
                yield scope, node
            yield from _tries(node, scope)


def test_port_has_no_fallback_try_and_no_env_switch():
    """A `try` is in the GO library's parse of its JSON file, and in one
    function beside it: the runtime's fallback ladder,
    `Runtime._execute_resilient`, the one `try` of the runtime.  The only
    environment read is the CUDA toolkit's location for the build."""
    tries, env = [], []
    for path in PORT_FILES:
        src = path.read_text()
        rel = path.relative_to(ROOT).as_posix()
        tries += [(rel, scope) for scope, _ in _tries(ast.parse(src))
                  if rel != "src/repro_torch/core/library.py"]
        if "environ" in src or "getenv" in src:
            env.append(path.relative_to(ROOT).as_posix())
    assert tries == [("src/repro_torch/runtime/runtime.py",
                      "Runtime._execute_resilient")]
    assert env == ["src/repro_torch/kernels/_build.py"]


def test_fallback_ladder_catches_launch_faults_only_and_runs_no_plain_version():
    """The ladder's one `try` names exactly `LaunchFault` and
    `KernelLaunchError`: no bare ``except``, no `Exception`, so a refused
    call, an unported family or a failed build raises at once.  The
    function names no plain version (``*_ref``): its reference rung runs
    each member through its family op, which launches the kernels on
    the card."""
    fn = next(n for n in ast.walk(ast.parse(
        (PORT / "runtime" / "runtime.py").read_text()))
        if isinstance(n, ast.FunctionDef) and n.name == "_execute_resilient")
    (try_,) = [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    caught = []
    for h in try_.handlers:
        assert h.type is not None, "bare except"
        types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        caught += [ast.unparse(t) for t in types]
    assert sorted(caught) == ["KernelLaunchError", "LaunchFault"]
    names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)}
    assert not [x for x in names if x.endswith("_ref")], names


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_runtime_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runtime()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runtime(device="cuda:0")
    assert Runtime(device="cpu").device == torch.device("cpu")


def test_operands_from_numpy_raise_without_cuda(no_cuda):
    req = GemmRequest(desc=GemmDesc(2, 4, 3, dtype="f32"))
    ops = [(np.ones((2, 3), np.float32), np.ones((3, 4), np.float32))]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        requests_from_numpy([req], ops)
    (r,) = requests_from_numpy([req], ops, device="cpu")
    assert r.a.device.type == "cpu" and r.b.dtype == torch.float32


@pytest.mark.parametrize("tile,launcher", [
    (TileConfig(8, 128, 128, split_k=4), "splitk_matmul"),
    (TileConfig(8, 128, 128, stream_k=6), "stream_k_matmul"),
], ids=lambda x: x.key() if isinstance(x, TileConfig) else x)
def test_gemm_off_cpu_refuses_split_and_stream_k(tile, launcher):
    """Off the CPU, `gemm` runs the tile's own kernels or raises: a split-K
    or Stream-K tile reaches its own CUDA launcher, which refuses `meta`
    tensors, and no launch is counted."""
    a = torch.empty((8, 512), device="meta")
    b = torch.empty((512, 128), device="meta")
    before = [fn.launches for fn in LAUNCHERS]
    with pytest.raises(ValueError, match=f"{launcher}: the CUDA kernel needs "
                                         "CUDA tensors"):
        gemm(a, b, tile=tile)
    # the un-split tile goes to the single-GEMM launcher
    with pytest.raises(ValueError, match="matmul: the CUDA kernel needs CUDA"):
        gemm(a, b, tile=TileConfig(8, 128, 128))
    assert [fn.launches for fn in LAUNCHERS] == before


def _function(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def test_mixed_launch_has_no_try_and_forks_onto_streams():
    """A `mixed` group on the card launches every member on its own
    stream with no `try` around a launch: a failed member raises, and
    nothing runs the members one after another instead."""
    fn = _function(PORT / "core" / "scheduler.py", "_run_mixed")
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    src = ast.unparse(fn)
    assert "torch.cuda.stream(s)" in src and "wait_event" in src
    assert "gemm_buffers" in src    # every buffer allocated before the fork
