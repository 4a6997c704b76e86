"""deepseek-moe-16b [moe] 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed, fine-grained
[arXiv:2401.06066] (``src/repro/configs/deepseek_moe_16b.py``).
Simplification kept from the reference: DeepSeek's dense layer 0 is made
MoE like the rest, so every layer is the same."""
from repro_torch.configs.base import Arch, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(vocab=102400, d_model=2048, n_layers=28, n_heads=16,
                  n_kv=16, head_dim=128, d_ff=0, qkv_bias=False,
                  qk_norm=False, rope_theta=1e6, dtype="bfloat16",
                  moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408,
                                n_shared=2, d_ff_shared=2 * 1408,
                                capacity_factor=1.25))

ARCH = register(Arch(
    name="deepseek-moe-16b", family="moe_lm",
    description="Fine-grained MoE: 2 shared + 64 routed experts, top-6."))
