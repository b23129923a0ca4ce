"""zamba2-1.2b [hybrid] — Mamba2 backbone + a shared attention block (the
reference's `repro/configs/zamba2_1p2b.py`; HF Zyphra/Zamba2-1.2B widths)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        head_dim=64,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        attn_every=6,
    )
)
