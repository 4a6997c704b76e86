"""Model configurations of the port: the reference's published settings
(``src/repro/configs``), without the JAX-only cell/sharding machinery.
Ported so far: :mod:`repro_torch.configs.din`,
:mod:`repro_torch.configs.gin_tu`, the GNN shapes and batch of
:mod:`repro_torch.configs.gnn_common`, and the dense LMs
(:mod:`~repro_torch.configs.qwen3_4b`,
:mod:`~repro_torch.configs.qwen15_4b`,
:mod:`~repro_torch.configs.codeqwen15_7b`) with the LM shapes of
:mod:`repro_torch.configs.lm_common`."""
from repro_torch.configs import (codeqwen15_7b, din, gin_tu, gnn_common,
                                 lm_common, qwen3_4b, qwen15_4b)

# LM architectures by the reference's registry name; the MoE ones need
# models/moe.py, which is not ported (ROADMAP A11)
LM_ARCHS = {"qwen3-4b": qwen3_4b.CONFIG, "qwen1.5-4b": qwen15_4b.CONFIG,
            "codeqwen1.5-7b": codeqwen15_7b.CONFIG}
LM_NOT_PORTED = ("deepseek-moe-16b", "phi3.5-moe-42b")

__all__ = ["din", "gin_tu", "gnn_common", "lm_common", "qwen3_4b",
           "qwen15_4b", "codeqwen15_7b", "LM_ARCHS", "LM_NOT_PORTED"]
