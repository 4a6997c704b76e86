"""qwen3-4b [dense] 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
— qk_norm, GQA. [hf:Qwen/Qwen3-*; hf] (``src/repro/configs/qwen3_4b.py``)"""
from repro_torch.configs.base import Arch, register
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(vocab=151936, d_model=2560, n_layers=36, n_heads=32,
                  n_kv=8, head_dim=128, d_ff=9728, qkv_bias=False,
                  qk_norm=True, rope_theta=1e6, dtype="bfloat16")

ARCH = register(Arch(
    name="qwen3-4b", family="lm",
    description="Dense decoder LM with qk-norm and GQA kv=8 (H·dh≠d)."))
