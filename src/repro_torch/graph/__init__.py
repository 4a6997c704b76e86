from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.generators import (grid_mesh_graph, molecule_batch,
                                          power_law_graph, preset_graph,
                                          radius_graph, uniform_graph)
from repro_torch.graph.sampler import (SampledHops, device_sample,
                                       fixed_size_unique, host_sample,
                                       host_sample_dense, realized_size,
                                       sample_khop)
from repro_torch.graph.segment import (scatter_spmm, segment_max,
                                       segment_mean, segment_softmax,
                                       segment_sum, segment_sum_ordered)

__all__ = [
    "CSRGraph", "power_law_graph", "uniform_graph", "grid_mesh_graph",
    "radius_graph", "molecule_batch", "preset_graph", "SampledHops",
    "device_sample", "sample_khop", "fixed_size_unique", "host_sample",
    "host_sample_dense", "realized_size", "segment_sum", "segment_sum_ordered",
    "segment_mean", "segment_max", "segment_softmax", "scatter_spmm",
]
