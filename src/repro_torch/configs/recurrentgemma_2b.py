"""RecurrentGemma-2B — RG-LRU hybrid, 1 local-attn : 2 recurrent [arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig, BlockKind

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    # Griffin pattern: (recurrent, recurrent, local attention) repeated.
    block_pattern=(BlockKind.RECURRENT, BlockKind.RECURRENT, BlockKind.LOCAL_ATTN),
    window=2048,
    tie_embeddings=True,
    logit_softcap=30.0,
    citation="arXiv:2402.19427 (RecurrentGemma / Griffin)",
)
