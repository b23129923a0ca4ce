from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import (
    attention_buffers,
    attention_for_desc,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import attention_tol, flash_ref, mha_ref

__all__ = ["attention_buffers", "attention_for_desc", "attention_tol",
           "flash_attention", "flash_attention_fwd", "flash_ref", "mha_ref"]
