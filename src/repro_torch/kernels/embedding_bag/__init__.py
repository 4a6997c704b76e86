from repro_torch.kernels.embedding_bag.kernel import (LAUNCHES,
                                                     embedding_bag_cuda)
from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                  embedding_bag_autograd)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_autograd", "embedding_bag_cuda",
           "embedding_bag_ref", "LAUNCHES"]
