"""Chameleon-34B — early-fusion VLM over VQ image tokens [arXiv:2405.09818].

The VQ-VAE image tokenizer / vision frontend is a STUB per the brief:
``input_specs`` supplies precomputed patch-token embeddings; this config is
the early-fusion decoder backbone.
"""
from repro_torch.configs.base import ArchConfig, BlockKind

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    block_pattern=(BlockKind.GLOBAL_ATTN,),
    modality="vlm",
    citation="arXiv:2405.09818 (Chameleon)",
)
