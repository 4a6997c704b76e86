from repro_torch.models.gnn_basic import (SAGE, SAGELayer, sage_from_numpy,
                                          sage_init, sage_layered)

__all__ = ["SAGE", "SAGELayer", "sage_init", "sage_from_numpy",
           "sage_layered"]
