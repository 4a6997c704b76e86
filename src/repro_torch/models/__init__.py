from repro_torch.models.din import (DIN, DINConfig, din_forward,
                                    din_from_numpy, din_init,
                                    din_score_candidates)
from repro_torch.models.transformer import (LM, LMBlock, LMConfig,
                                            init_decode_cache,
                                            lm_active_param_count,
                                            lm_decode_step, lm_from_numpy,
                                            lm_init, lm_param_count,
                                            lm_prefill)
from repro_torch.models.gnn_basic import (GIN, SAGE, GINLayer, SAGELayer,
                                          gin_from_numpy, gin_full_graph,
                                          gin_graph_readout, gin_init,
                                          sage_from_numpy, sage_init,
                                          sage_layered)

__all__ = ["SAGE", "SAGELayer", "sage_init", "sage_from_numpy",
           "sage_layered", "GIN", "GINLayer", "gin_init", "gin_from_numpy",
           "gin_full_graph", "gin_graph_readout", "DIN", "DINConfig",
           "din_init", "din_from_numpy", "din_forward",
           "din_score_candidates", "LM", "LMBlock", "LMConfig", "lm_init",
           "lm_from_numpy", "lm_prefill", "lm_decode_step",
           "init_decode_cache", "lm_param_count", "lm_active_param_count"]
