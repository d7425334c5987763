"""DeepSeek-R1 — the paper's evaluation model [arXiv:2501.12948 / 2412.19437].

MLA is approximated as GQA(kv=8) with the same KV-cache byte footprint,
exactly as in the JAX package's configuration of the same name.
"""
from repro_torch.configs.base import ArchConfig, BlockKind, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-r1",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,
    vocab_size=129_280,
    block_pattern=(BlockKind.GLOBAL_ATTN,),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff=2048,
        every=1,
        shared_d_ff=2048,
        first_dense=3,
    ),
    citation="arXiv:2412.19437 (DeepSeek-V3/R1)",
)
