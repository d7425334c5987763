"""Architecture and input-shape registry of the port (``get_arch``,
``get_shape``, ``reduced_variant``).

Every architecture of the JAX package's ``repro.configs`` is a module here
exposing ``CONFIG``, copied field for field; ``get_arch(name)`` resolves
``--arch <id>`` CLI ids. ``SHAPES`` carries the four assigned input shapes.
"""
from repro_torch.configs.base import (
    ArchConfig,
    BlockKind,
    InputShape,
    MoEConfig,
    SHAPES,
    reduced_variant,
)
from repro_torch.configs import (
    recurrentgemma_2b,
    gemma3_27b,
    grok_1_314b,
    yi_9b,
    deepseek_67b,
    musicgen_medium,
    xlstm_350m,
    glm4_9b,
    llama4_maverick_400b_a17b,
    chameleon_34b,
    deepseek_r1,
)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        recurrentgemma_2b,
        gemma3_27b,
        grok_1_314b,
        yi_9b,
        deepseek_67b,
        musicgen_medium,
        xlstm_350m,
        glm4_9b,
        llama4_maverick_400b_a17b,
        chameleon_34b,
        deepseek_r1,
    )
}

ASSIGNED_ARCHS = [n for n in ARCHS if n != "deepseek-r1"]


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}"
        ) from None


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(
            f"unknown shape {name!r}; available: {sorted(SHAPES)}"
        ) from None


__all__ = [
    "ARCHS",
    "ASSIGNED_ARCHS",
    "ArchConfig",
    "BlockKind",
    "InputShape",
    "MoEConfig",
    "SHAPES",
    "get_arch",
    "get_shape",
    "reduced_variant",
]
