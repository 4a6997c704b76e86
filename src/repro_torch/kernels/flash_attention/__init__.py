from repro_torch.kernels.flash_attention.kernel import (LAUNCHES,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

__all__ = ["flash_attention", "flash_attention_cuda",
           "flash_attention_plain", "LAUNCHES"]
