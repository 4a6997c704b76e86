"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the ``repro`` reference package, and the
package and its launcher import in a process where both are blocked."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch, repro_torch.launch.serve\n"
            "import repro_torch.core, repro_torch.serving, repro_torch.models\n"
            "import repro_torch.kernels.build\n"
            "import repro_torch.launch.recsys_din, repro_torch.configs\n"
            "import repro_torch.kernels.embedding_bag\n"
            "import repro_torch.training, repro_torch.launch.train\n"
            "import repro_torch.configs.gin_tu\n"
            "import repro_torch.kernels.segment_spmm\n"
            "import repro_torch.bench.profile_train\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.models.transformer, repro_torch.launch.lm\n"
            "import repro_torch.configs.qwen3_4b, repro_torch.bench.profile_lm\n"
            "import repro_torch.models.moe, repro_torch.configs.phi35_moe_42b\n"
            "import repro_torch.configs.deepseek_moe_16b\n"
            "import repro_torch.core.gpu_cache, repro_torch.core.prefetch\n"
            "import repro_torch.serving.adaptive, repro_torch.serving.gateway\n"
            "import repro_torch.testing, repro_torch.bench.profile_serve\n"
            "import repro_torch.models.so3, repro_torch.models.schnet\n"
            "import repro_torch.models.meshgraphnet\n"
            "import repro_torch.models.equiformer_v2\n"
            "import repro_torch.configs.base, repro_torch.configs.schnet\n"
            "import repro_torch.configs.meshgraphnet\n"
            "import repro_torch.configs.equiformer_v2\n"
            "import repro_torch.launch.train_gnn_100m\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m])\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
