from repro_torch.kernels.flash_attention.kernel import (
    AttentionBuffers,
    attention_route,
    flash_attention_fwd,
    kv_splits,
    prefill_tiles,
)
from repro_torch.kernels.flash_attention.ops import (
    attention_buffers,
    attention_for_desc,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_tol,
    flash_combine_ref,
    flash_prefill_ref,
    flash_ref,
    flash_split_ref,
    mha_ref,
)

__all__ = ["AttentionBuffers", "attention_buffers", "attention_for_desc",
           "attention_route", "attention_tol", "flash_attention",
           "flash_attention_fwd", "flash_combine_ref", "flash_prefill_ref",
           "flash_ref", "flash_split_ref", "kv_splits", "mha_ref",
           "prefill_tiles"]
