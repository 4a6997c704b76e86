from repro_torch.kernels.segment_spmm.kernel import (LAUNCHES,
                                                     segment_spmm_cuda)
from repro_torch.kernels.segment_spmm.ops import (SegmentSpmm, segment_spmm,
                                                  segment_spmm_autograd)
from repro_torch.kernels.segment_spmm.ref import (coo_to_ell, ell_pair,
                                                  ell_table,
                                                  segment_spmm_plain,
                                                  transpose_ell)

__all__ = ["segment_spmm", "segment_spmm_autograd", "SegmentSpmm",
           "segment_spmm_cuda", "segment_spmm_plain", "coo_to_ell",
           "ell_pair", "ell_table", "transpose_ell", "LAUNCHES"]
