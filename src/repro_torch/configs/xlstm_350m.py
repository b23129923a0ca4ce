"""xlstm-350m [ssm] — alternating mLSTM / sLSTM blocks. [arXiv:2405.04517]

d_ff=0 per assignment: xLSTM blocks carry their own up/down projections
(mLSTM: pre-up-projection 2x; sLSTM: post-FFN 4/3 gated).  1-in-4 layers are
sLSTM (paper's 7:1-ish mixing, rounded to the 24-layer stack).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        slstm_every=4,
        ssm_state=0,
        ssm_head_dim=256,  # d_model / n_heads for mLSTM heads
    )
)
