"""Model configurations of the port: the reference's published settings
(``src/repro/configs``), with each architecture's dry-run cell
(``build_cell``), smoke and sharding rules. Importing the package
registers every architecture (:mod:`repro_torch.configs.base`:
``get_arch``, ``list_archs``).
Ported so far: :mod:`repro_torch.configs.din`, the GNNs
(:mod:`~repro_torch.configs.gin_tu`, :mod:`~repro_torch.configs.schnet`,
:mod:`~repro_torch.configs.meshgraphnet`,
:mod:`~repro_torch.configs.equiformer_v2`) with the GNN shapes, batch and
adapter of :mod:`repro_torch.configs.gnn_common`, the dense LMs
(:mod:`~repro_torch.configs.qwen3_4b`,
:mod:`~repro_torch.configs.qwen15_4b`,
:mod:`~repro_torch.configs.codeqwen15_7b`) and the MoE LMs
(:mod:`~repro_torch.configs.deepseek_moe_16b`,
:mod:`~repro_torch.configs.phi35_moe_42b`) with the LM shapes of
:mod:`repro_torch.configs.lm_common`."""
from repro_torch.configs import (codeqwen15_7b, deepseek_moe_16b, din,
                                 equiformer_v2, gin_tu, gnn_common,
                                 lm_common, meshgraphnet, phi35_moe_42b,
                                 qwen3_4b, qwen15_4b, schnet)
from repro_torch.configs.base import Arch, CellSpec, get_arch, list_archs

# LM architectures by the reference's registry name
LM_ARCHS = {"qwen3-4b": qwen3_4b.CONFIG, "qwen1.5-4b": qwen15_4b.CONFIG,
            "codeqwen1.5-7b": codeqwen15_7b.CONFIG,
            "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
            "phi3.5-moe-42b": phi35_moe_42b.CONFIG}

ALL_ARCHS = list_archs()

__all__ = ["din", "gin_tu", "schnet", "meshgraphnet", "equiformer_v2",
           "gnn_common", "lm_common", "qwen3_4b", "qwen15_4b",
           "codeqwen15_7b", "deepseek_moe_16b", "phi35_moe_42b", "LM_ARCHS",
           "Arch", "CellSpec", "get_arch", "list_archs", "ALL_ARCHS"]
