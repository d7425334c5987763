"""GLM-4-9B — dense, RoPE, GQA kv=2 [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ArchConfig, BlockKind

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151_552,
    block_pattern=(BlockKind.GLOBAL_ATTN,),
    citation="hf:THUDM/glm-4-9b model card",
)
