"""Grok-1 314B — MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ArchConfig, BlockKind, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    block_pattern=(BlockKind.GLOBAL_ATTN,),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32768, every=1),
    citation="hf:xai-org/grok-1 model card",
)
