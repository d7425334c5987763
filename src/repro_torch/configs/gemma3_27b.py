"""Gemma-3-27B — dense, 5 sliding : 1 global, 128K context [hf:google/gemma-3-1b-pt family].

The JAX package's configuration of the same name, with its simplifications
as they are: SwiGLU FFN, no qk-norm, one RoPE base for every layer.
"""
from repro_torch.configs.base import ArchConfig, BlockKind

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    # Gemma-3: five sliding-window layers per global layer.
    block_pattern=(
        BlockKind.LOCAL_ATTN,
        BlockKind.LOCAL_ATTN,
        BlockKind.LOCAL_ATTN,
        BlockKind.LOCAL_ATTN,
        BlockKind.LOCAL_ATTN,
        BlockKind.GLOBAL_ATTN,
    ),
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    citation="hf:google/gemma-3-1b-pt model card (scaled to 27B table entry)",
)
