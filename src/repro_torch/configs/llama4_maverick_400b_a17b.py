"""Llama-4 Maverick 400B-A17B — MoE 128 experts top-1, alternating dense/MoE
layers, shared expert, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E family].
"""
from repro_torch.configs.base import ArchConfig, BlockKind, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    block_pattern=(BlockKind.GLOBAL_ATTN,),
    # Maverick interleaves MoE every other layer; dense layers use a wider FFN.
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff=8192,
        every=2,
        dense_d_ff=16384,
        shared_d_ff=8192,
    ),
    rope_theta=500_000.0,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E model card (Maverick table entry)",
)
