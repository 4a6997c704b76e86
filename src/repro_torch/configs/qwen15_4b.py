"""qwen1.5-4b [dense] 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936 — QKV bias. [hf:Qwen/Qwen1.5-*; hf]
(``src/repro/configs/qwen15_4b.py``)"""
from repro_torch.configs.base import Arch, register
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(vocab=151936, d_model=2560, n_layers=40, n_heads=20,
                  n_kv=20, head_dim=128, d_ff=6912, qkv_bias=True,
                  qk_norm=False, rope_theta=1e6, dtype="bfloat16")

ARCH = register(Arch(
    name="qwen1.5-4b", family="lm",
    description="Dense decoder LM, MHA-style GQA (kv=heads), QKV bias."))
