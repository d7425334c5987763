"""DeepSeek-67B — dense llama-arch, 95 layers [arXiv:2401.02954]."""
from repro_torch.configs.base import ArchConfig, BlockKind

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102_400,
    block_pattern=(BlockKind.GLOBAL_ATTN,),
    citation="arXiv:2401.02954 (DeepSeek LLM)",
)
