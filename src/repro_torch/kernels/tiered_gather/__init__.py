from repro_torch.kernels.tiered_gather.kernel import (LAUNCHES,
                                                      tiered_gather_cuda)
from repro_torch.kernels.tiered_gather.ops import tiered_gather
from repro_torch.kernels.tiered_gather.ref import tiered_gather_ref

__all__ = ["tiered_gather", "tiered_gather_cuda", "tiered_gather_ref",
           "LAUNCHES"]
