from repro_torch.models.din import (DIN, DINConfig, din_forward,
                                    din_from_numpy, din_init,
                                    din_score_candidates)
from repro_torch.models.transformer import (LM, LMBlock, LMConfig,
                                            init_decode_cache,
                                            lm_active_param_count,
                                            lm_decode_step, lm_from_numpy,
                                            lm_init, lm_param_count,
                                            lm_prefill)
from repro_torch.models.moe import (MoE, MoEConfig, moe_apply,
                                    moe_from_numpy, moe_init)
from repro_torch.models.schnet import (SchNet, schnet_forward,
                                      schnet_from_numpy, schnet_init)
from repro_torch.models.meshgraphnet import (MeshGraphNet, mgn_forward,
                                             mgn_from_numpy, mgn_init)
from repro_torch.models.equiformer_v2 import (EquiformerV2,
                                              equiformer_forward,
                                              equiformer_from_numpy,
                                              equiformer_init)
from repro_torch.models.gnn_basic import (GIN, SAGE, GINLayer, SAGELayer,
                                          gin_from_numpy, gin_full_graph,
                                          gin_graph_readout, gin_init,
                                          sage_from_numpy, sage_init,
                                          sage_layered)

__all__ = ["SAGE", "SAGELayer", "sage_init", "sage_from_numpy",
           "sage_layered", "GIN", "GINLayer", "gin_init", "gin_from_numpy",
           "gin_full_graph", "gin_graph_readout", "DIN", "DINConfig",
           "din_init", "din_from_numpy", "din_forward",
           "din_score_candidates", "MoE", "MoEConfig", "moe_init",
           "moe_from_numpy", "moe_apply", "LM", "LMBlock", "LMConfig",
           "lm_init", "lm_from_numpy", "lm_prefill", "lm_decode_step",
           "init_decode_cache", "lm_param_count", "lm_active_param_count",
           "SchNet", "schnet_init", "schnet_from_numpy", "schnet_forward",
           "MeshGraphNet", "mgn_init", "mgn_from_numpy", "mgn_forward",
           "EquiformerV2", "equiformer_init", "equiformer_from_numpy",
           "equiformer_forward"]
