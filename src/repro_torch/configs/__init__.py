"""Architecture registry of the port (``get_arch``, ``reduced_variant``).

Only the configurations the port serves are registered: DeepSeek-R1, the
paper's evaluation model, and Gemma-3-27B, whose sliding-window layers
run the flash kernel's window branch. Other architectures come with
later slices.
"""
from repro_torch.configs.base import (
    ArchConfig,
    BlockKind,
    InputShape,
    MoEConfig,
    reduced_variant,
)
from repro_torch.configs import deepseek_r1, gemma3_27b

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in (deepseek_r1, gemma3_27b)}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}"
        ) from None


__all__ = [
    "ARCHS",
    "ArchConfig",
    "BlockKind",
    "InputShape",
    "MoEConfig",
    "get_arch",
    "reduced_variant",
]
