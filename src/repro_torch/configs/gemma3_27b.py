"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab_size=262144,
        head_dim=128,
        qk_norm=True,
        sliding_window=1024,
        local_global_ratio=5,  # 5 sliding-window layers per global layer
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
)
