"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec conv codec frontend is a STUB per the brief: ``input_specs``
supplies precomputed frame embeddings; this config is the transformer
backbone that consumes them.
"""
from repro_torch.configs.base import ArchConfig, BlockKind

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=(BlockKind.GLOBAL_ATTN,),
    modality="audio",
    citation="arXiv:2306.05284 (MusicGen)",
)
