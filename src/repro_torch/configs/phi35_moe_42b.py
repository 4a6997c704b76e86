"""phi3.5-moe-42b-a6.6b [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2. [hf:microsoft/Phi-3.5-MoE-instruct]
(``src/repro/configs/phi35_moe_42b.py``)"""
from repro_torch.configs.base import register
from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(vocab=32064, d_model=4096, n_layers=32, n_heads=32,
                  n_kv=8, head_dim=128, d_ff=0, qkv_bias=False,
                  qk_norm=False, rope_theta=1e6, dtype="bfloat16",
                  moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400,
                                capacity_factor=1.25))

ARCH = register(make_lm_arch(
    "phi3.5-moe-42b", CONFIG, family="moe_lm",
    description="16-expert top-2 MoE, GQA kv=8, 6.6B active params."))
