"""``gather_aggregate`` (``csrc/gather_aggregate.cu``): the innermost
hop's rows gathered and summed a parent, ``lookup_aggregate``'s device
work."""

from servebench import costs

# the wrapper the feature store calls, patched to record launches
MODULE, WRAPPER = "repro_torch.core.feature_store", "gather_aggregate"
# the library ``repro_torch.kernels.build.build`` compiles
BUILD = "gather_aggregate"
# a substring of the kernel's name in the device trace
TRACE_NAME = "gather_aggregate_kernel"
# what in a configuration makes the serving path launch it: a
# ``(key, value)`` pair, the key ``collect`` or ``arch``, written as a
# literal (the harness reads it without importing this file)
LAUNCHED_BY = ("collect", "lookup_aggregate")
# least bytes of one call, from the wrapper's arguments
least_bytes = costs.gather_aggregate_bytes
