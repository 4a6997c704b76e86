"""codeqwen1.5-7b [dense] 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416 — qwen1.5 arch. [hf:Qwen/CodeQwen1.5-7B; hf]
(``src/repro/configs/codeqwen15_7b.py``)"""
from repro_torch.configs.base import Arch, register
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(vocab=92416, d_model=4096, n_layers=32, n_heads=32,
                  n_kv=32, head_dim=128, d_ff=13440, qkv_bias=True,
                  qk_norm=False, rope_theta=1e6, dtype="bfloat16")

ARCH = register(Arch(
    name="codeqwen1.5-7b", family="lm",
    description="Dense decoder LM (qwen1.5 family), code vocab 92416."))
