"""``tiered_gather`` (``csrc/tiered_gather.cu``): the fused collection's
gather of HOT/WARM rows, ``lookup_hops``' device work."""

from servebench import costs

# the wrapper the feature store calls, patched to record launches
MODULE, WRAPPER = "repro_torch.core.feature_store", "tiered_gather"
# the library ``repro_torch.kernels.build.build`` compiles
BUILD = "tiered_gather"
# a substring of the kernel's name in the device trace
TRACE_NAME = "tiered_gather_kernel"
# what in a configuration makes the serving path launch it: a
# ``(key, value)`` pair, the key ``collect`` or ``arch``, written as a
# literal (the harness reads it without importing this file)
LAUNCHED_BY = ("collect", "lookup_hops")
# least bytes of one call, from the wrapper's arguments
least_bytes = costs.tiered_gather_bytes
