from repro_torch.models.din import (DIN, DINConfig, din_forward,
                                    din_from_numpy, din_init,
                                    din_score_candidates)
from repro_torch.models.gnn_basic import (SAGE, SAGELayer, sage_from_numpy,
                                          sage_init, sage_layered)

__all__ = ["SAGE", "SAGELayer", "sage_init", "sage_from_numpy",
           "sage_layered", "DIN", "DINConfig", "din_init", "din_from_numpy",
           "din_forward", "din_score_candidates"]
