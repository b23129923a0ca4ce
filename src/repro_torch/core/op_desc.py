"""Op-family protocol, GEMM part (`repro/core/op_desc.py:40-45`).

The port's slice carries GEMMs only; the attention, grouped-expert and
scan descriptors, and the slicing recipes, arrive with their families.
"""
from __future__ import annotations


def family_of(d) -> str:
    """Kernel family of a descriptor; plain `GemmDesc` is ``"gemm"``."""
    return getattr(d, "family", "gemm")
