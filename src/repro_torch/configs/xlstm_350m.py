"""xLSTM-350M — sLSTM + mLSTM blocks, attention-free, d_ff=0 [arXiv:2405.04517]."""
from repro_torch.configs.base import ArchConfig, BlockKind

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,  # xLSTM blocks carry their own up/down projections; no separate FFN
    vocab_size=50_304,
    block_pattern=(BlockKind.MLSTM, BlockKind.MLSTM, BlockKind.MLSTM, BlockKind.SLSTM),
    citation="arXiv:2405.04517 (xLSTM)",
)
