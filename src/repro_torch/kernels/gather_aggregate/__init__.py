from repro_torch.kernels.gather_aggregate.kernel import (
    LAUNCHES, gather_aggregate_cuda)
from repro_torch.kernels.gather_aggregate.ops import gather_aggregate
from repro_torch.kernels.gather_aggregate.ref import (fan_sum,
                                                      gather_aggregate_ref)
from repro_torch.kernels.gather_aggregate.autotune import (
    autotune_gather_aggregate)

__all__ = ["gather_aggregate", "gather_aggregate_cuda",
           "gather_aggregate_ref", "fan_sum", "LAUNCHES",
           "autotune_gather_aggregate"]
