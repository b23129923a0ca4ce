"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 2 shared + 64 routed
experts, top-6 (the reference's `repro/configs/deepseek_v2_lite_16b.py`).

Widths and depth of the HF config ``deepseek-ai/DeepSeek-V2-Lite``: 64
routed experts, no q compression in the lite model; layer 0 is dense
(d_ff 10944), which the decode-step bundle ignores, as the reference's
does (ROADMAP C11).  Random weights; nothing is downloaded.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,           # the routed-expert hidden dim, as the reference's
        vocab_size=102400,
        attn_type="mla",
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        n_routed_experts=64,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        first_dense_layers=1,
        dense_d_ff=10944,
    )
)
