"""Yi-9B — dense llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig, BlockKind

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    block_pattern=(BlockKind.GLOBAL_ATTN,),
    rope_theta=10_000.0,
    citation="arXiv:2403.04652 (Yi)",
)
