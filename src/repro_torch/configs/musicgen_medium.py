"""musicgen-medium [audio] — decoder-only backbone over EnCodec tokens.
[arXiv:2306.05284; hf]

Modality frontend is a STUB per assignment: ``input_specs()`` provides
precomputed frame embeddings (B, T, d_model); the backbone is the standard
decoder stack with an LM head over the 2048-entry codebook vocab.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        frontend="audio_frames",
    )
)
