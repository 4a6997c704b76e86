from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.generators import power_law_graph
from repro_torch.graph.sampler import (device_sample, fixed_size_unique,
                                       host_sample, host_sample_dense)
from repro_torch.graph.segment import (scatter_spmm, segment_max,
                                       segment_mean, segment_softmax,
                                       segment_sum, segment_sum_ordered)

__all__ = [
    "CSRGraph", "power_law_graph", "device_sample", "fixed_size_unique",
    "host_sample", "host_sample_dense", "segment_sum", "segment_sum_ordered",
    "segment_mean", "segment_max", "segment_softmax", "scatter_spmm",
]
