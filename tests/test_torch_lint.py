"""quiverlint's lock pass over the PyTorch port (``src/repro_torch``): the
port's stores, cache, prefetcher and gateway keep the reference's
guarded-by registry (``tools/quiverlint/repo_config.py``), so every read
or write of a guarded field happens under its lock, or carries a reasoned
suppression. The repo's own gate (``tests/test_lint.py``) lints the JAX
package; this test points the same pass at the port, with ``tools/``
unchanged."""
import dataclasses
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from quiverlint import driver, repo_config  # noqa: E402

PORT_GLOBS = ["src/repro_torch/**/*.py"]


def test_port_has_no_lock_findings():
    config = dataclasses.replace(repo_config.build(REPO),
                                 code_globs=PORT_GLOBS)
    files = driver.collect_files(REPO, config.code_globs)
    assert len(files) > 50, len(files)
    result = driver.run(config, files, {"lock": repo_config.PASSES["lock"]})
    assert result.findings == [], "\n".join(f.render()
                                            for f in result.findings)
