"""The port's ``sharded_hierarchy`` benchmark against the reference's on
the CPU at ``dry_run=True``, at worlds 1, 2 and 8: every row (they read
no clock: bit identity, host fetches a request, stage hits, spill reads,
the exchanged ids and their occurrences) equal.

The reference takes its world from ``len(jax.devices())``, so worlds 2
and 8 run it in a subprocess with that many fake devices (world 1 in this
process, which sees one). The port's world is an argument: logical shards
of one mesh on the CPU. In both, the reference's ``shard_map`` exchanges
are wrapped in ``jax.jit`` for this test: run eagerly, each of their
operations compiles on its own (~2,800 compiles, 2-4 minutes a world);
jitted, each exchange compiles once. The exchange bodies only gather,
select and sum rows with zeros, so the rows and counters are the
same either way; nothing in ``benchmarks/`` or ``src/repro/`` changes."""
import json
import os

import pytest
import torch

from conftest import REPO, run_subprocess
from repro_torch.bench import common as port_common
from repro_torch.bench import sharded_hierarchy as port

# the reference module at this process's device count, its rows as JSON
_REFERENCE = """
import json, os, sys
sys.path.insert(0, {repo!r})
os.environ["BENCH_JSON_DIR"] = {out!r}
import jax
import repro.core.feature_store as fs
from repro.compat import shard_map
fs.shard_map = lambda f, **kw: jax.jit(shard_map(f, **kw))
import benchmarks.common as common
import benchmarks.sharded_hierarchy as m
result = m.run(dry_run=True)
print("ROWS=" + json.dumps({{"world": result["world"], "rows": common.ROWS}}))
"""


def _reference_rows(world: int, tmp_path) -> list:
    code = _REFERENCE.format(repo=REPO, out=str(tmp_path))
    r = run_subprocess(code, devices=world, timeout=600)
    line = [x for x in r.stdout.splitlines() if x.startswith("ROWS=")]
    assert line, r.stderr[-3000:]
    payload = json.loads(line[0][len("ROWS="):])
    assert payload["world"] == world
    return [tuple(row) for row in payload["rows"]]


def _port_rows(world: int, monkeypatch, tmp_path) -> tuple[list, dict]:
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port_common.ROWS.clear()
        result = port.run(dry_run=True, world=world, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return list(port_common.ROWS), result


def _check(ref_rows, port_rows, result, world):
    assert [r[0] for r in port_rows] == [r[0] for r in ref_rows]
    for got, want in zip(port_rows, ref_rows):
        assert tuple(got) == tuple(want), got[0]
    assert result["world"] == world
    dedup = result["dedup"]
    assert dedup["exchanged_ids"] < dedup["occurrences"]
    assert result["staged"]["stage_hits"] > 0


def test_world1_rows_equal_reference(monkeypatch, tmp_path):
    import jax
    import benchmarks.common as ref_common
    import benchmarks.sharded_hierarchy as ref
    import repro.core.feature_store as fs
    from repro.compat import shard_map
    assert len(jax.devices()) == 1
    monkeypatch.setattr(fs, "shard_map",
                        lambda f, **kw: jax.jit(shard_map(f, **kw)))
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path))
    ref_common.ROWS.clear()
    ref.run(dry_run=True)
    ref_rows = list(ref_common.ROWS)
    port_rows, result = _port_rows(1, monkeypatch, tmp_path)
    _check(ref_rows, port_rows, result, 1)


@pytest.mark.subprocess
@pytest.mark.parametrize("world", [2, 8])
def test_world_rows_equal_reference(world, monkeypatch, tmp_path):
    ref_rows = _reference_rows(world, tmp_path)
    port_rows, result = _port_rows(world, monkeypatch, tmp_path)
    _check(ref_rows, port_rows, result, world)
    assert os.path.exists(tmp_path / "BENCH_sharded_hierarchy.json")
