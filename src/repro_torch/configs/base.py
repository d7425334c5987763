"""Config dataclasses for the PyTorch port.

The port's own copy of the architecture description (the JAX package's
``repro.configs.base``): ``ArchConfig`` is a frozen, hashable description
of a decoder-only stack — enough to build parameters, the forward step
and the sharding plan. Only the fields and derived quantities the ported
path reads are kept, with the same names and the same arithmetic, so the
two packages size every tensor identically.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class BlockKind(str, enum.Enum):
    """Kind of the token-mixing sub-block of one layer."""

    GLOBAL_ATTN = "global_attn"    # full causal attention
    LOCAL_ATTN = "local_attn"      # sliding-window causal attention
    RECURRENT = "recurrent"        # RG-LRU linear recurrence (not ported yet)
    MLSTM = "mlstm"                # matrix-memory LSTM (not ported yet)
    SLSTM = "slstm"                # scalar-memory LSTM (not ported yet)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for the FFN sub-block."""

    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    every: int = 1                 # MoE on layers where (layer % every == every-1)
    dense_d_ff: int = 0            # FFN dim of the non-MoE interleaved layers
    shared_d_ff: int = 0           # always-on shared expert (DeepSeek-style)
    first_dense: int = 0           # leading layers that stay dense (DeepSeek-style)

    def is_moe_layer(self, layer: int) -> bool:
        if layer < self.first_dense:
            return False
        return (layer - self.first_dense) % self.every == self.every - 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Full description of a decoder-only architecture."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    block_pattern: tuple[BlockKind, ...] = (BlockKind.GLOBAL_ATTN,)
    window: int = 4096
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    modality: str = "text"
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    citation: str = ""
    long_context_window: int = 8192

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: heads must divide over kv heads")

    def block_kind(self, layer: int) -> BlockKind:
        return self.block_pattern[layer % len(self.block_pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        return self.moe is not None and self.moe.is_moe_layer(layer)

    def ffn_dim(self, layer: int) -> int:
        """Hidden dim of the dense FFN on this layer (0 if MoE or absent)."""
        if self.is_moe_layer(layer):
            return 0
        if self.moe is not None and self.moe.dense_d_ff:
            return self.moe.dense_d_ff
        return self.d_ff

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def has_attention(self) -> bool:
        return any(
            k in (BlockKind.GLOBAL_ATTN, BlockKind.LOCAL_ATTN)
            for k in self.block_pattern
        )

    def param_count(self) -> int:
        """Exact parameter count of the decoder stack and the embeddings."""
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # lm head
        for layer in range(self.num_layers):
            n += self._mixer_params(layer) + self._ffn_params(layer)
            n += 2 * self.d_model  # two RMSNorm gains
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters one token touches (MoE: its top_k routed experts, the
        router and the shared expert only)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for layer in range(self.num_layers):
            n += self._mixer_params(layer) + 2 * self.d_model
            if self.is_moe_layer(layer):
                n += self.moe.top_k * 3 * self.d_model * self.moe.d_ff
                n += self.d_model * self.moe.num_experts  # router
                if self.moe.shared_d_ff:
                    n += 3 * self.d_model * self.moe.shared_d_ff
            else:
                n += self._ffn_params(layer)
        n += self.d_model
        return n

    def _mixer_params(self, layer: int) -> int:
        kind = self.block_kind(layer)
        d = self.d_model
        if kind in (BlockKind.GLOBAL_ATTN, BlockKind.LOCAL_ATTN):
            return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if kind == BlockKind.RECURRENT:
            return 2 * d * d + 4 * d + 2 * d * d + 2 * d
        return 4 * d * d + 3 * d * d + d * d

    def _ffn_params(self, layer: int) -> int:
        if self.is_moe_layer(layer):
            per = 3 * self.d_model * self.moe.d_ff  # gate/up/down
            n = self.moe.num_experts * per + self.d_model * self.moe.num_experts
            if self.moe.shared_d_ff:
                n += 3 * self.d_model * self.moe.shared_d_ff
            return n
        dff = self.ffn_dim(layer)
        return 3 * self.d_model * dff if dff else 0


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    phase: str  # "prefill" | "decode" (training is not ported yet)

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


def reduced_variant(cfg: ArchConfig) -> ArchConfig:
    """2-layer, d_model<=512, <=4-expert smoke variant of the same family
    (the same cut as the JAX package's ``reduced_variant``)."""
    pattern = (cfg.block_pattern[0], cfg.block_pattern[-1])
    if pattern[0] == pattern[1]:
        pattern = pattern[:1]
    heads = 4
    kv = max(1, heads * cfg.num_kv_heads // cfg.num_heads)
    moe = None
    if cfg.moe is not None:
        e = min(4, cfg.moe.num_experts)
        moe = MoEConfig(
            num_experts=e,
            top_k=min(cfg.moe.top_k, e),
            d_ff=256,
            every=min(cfg.moe.every, 2),
            dense_d_ff=256 if cfg.moe.dense_d_ff else 0,
            shared_d_ff=128 if cfg.moe.shared_d_ff else 0,
            first_dense=min(cfg.moe.first_dense, 1),
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=256,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        block_pattern=pattern,
        window=64,
        moe=moe,
        long_context_window=64,
    )
