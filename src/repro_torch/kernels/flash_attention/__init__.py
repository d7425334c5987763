"""Flash attention: the CUDA prefill kernel, its dispatch and its plain
version ``flash_attention_torch`` (``models.attention.mha_prefill``)."""
from repro_torch.kernels.flash_attention.ops import (
    FLASH_ATTENTION,
    flash_attention,
    flash_attention_torch,
)

__all__ = ["FLASH_ATTENTION", "flash_attention", "flash_attention_torch"]
