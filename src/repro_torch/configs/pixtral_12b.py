"""pixtral-12b [vlm] — mistral-nemo-style decoder backbone; pixtral-ViT
frontend is a STUB (precomputed patch embeddings).
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        head_dim=128,
        rope_theta=1_000_000.0,
        frontend="vision_patches",
    )
)
