"""qwen3-14b [dense] — qk_norm, GQA (the reference's `repro/configs/qwen3_14b.py`)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=17408,
        vocab_size=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
)
