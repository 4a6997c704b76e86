"""Fault-tolerant checkpointing with the reference's semantics
(``src/repro/training/checkpoint.py::CheckpointManager``): atomic publish
(write ``tmp_*``, then rename to ``step_*``), an optional async writer
thread, keep-K garbage collection, and a manifest with a SHA-1 per leaf.

A tree is a nested dict whose leaves are tensors, numpy arrays or numbers
— for training, ``{"params": model.state_dict(), "opt": {"step", "mu",
"nu"}}``. Leaves are named by their key path joined with ``/`` (the
state-dict names appear as they are) and stored as ``.npy`` files, copied
to the host when ``save`` is called.

Restart semantics: :meth:`latest_step` returns the newest step whose
manifest exists, so a directory a crashed writer left without one is
ignored, and stale ``tmp_*`` directories are removed when a manager opens
the directory.

Elastic restore: leaves are stored whole, so ``restore(...,
placements=)`` can split any leaf over any mesh
(:class:`~repro_torch.launch.mesh.Mesh`), whatever world wrote it.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, Mapping):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def _to_host(leaf) -> np.ndarray:
    """A copy on the host: the caller may update the leaf in place while
    an async write is pending."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def _split(leaf: torch.Tensor, mesh, dim: int, name: str
           ) -> list[torch.Tensor]:
    """``leaf`` in ``mesh.world`` equal shards along ``dim``, shard ``i``
    on ``mesh.devices[i]``."""
    if leaf.shape[dim] % mesh.world:
        raise ValueError(f"leaf {name}: dim {dim} of {tuple(leaf.shape)} "
                         f"does not split over {mesh.world} shards")
    return [part.to(dev) for part, dev in
            zip(leaf.chunk(mesh.world, dim), mesh.devices)]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._gc_incomplete()
        self.async_write = async_write
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_write:
            self._worker = threading.Thread(target=self._writer_loop,
                                            daemon=True)
            self._worker.start()

    # ---- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:012d}")

    def _gc_incomplete(self) -> None:
        for name in os.listdir(self.dir):
            if name.startswith("tmp_"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    def _complete_steps(self) -> list[int]:
        return sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_")
            and os.path.exists(os.path.join(self.dir, n, "MANIFEST.json")))

    def latest_step(self) -> Optional[int]:
        """The newest step with a manifest, or None."""
        steps = self._complete_steps()
        return steps[-1] if steps else None

    # ---- save -----------------------------------------------------------
    def save(self, step: int, tree, *, metadata: Optional[dict] = None,
             block: bool = True) -> None:
        """Copy ``tree``'s leaves to the host now; write them on the
        writer thread when the manager is async and ``block`` is False,
        else now, after the queued writes (two writers of one step would
        share its ``tmp_`` directory)."""
        host_leaves = [(name, _to_host(leaf)) for name, leaf in _flatten(tree)]
        if self.async_write and not block:
            self._queue.put((step, host_leaves, metadata))
            return
        self.wait()
        self._write(step, host_leaves, metadata)

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                self._write(*item)
            except Exception as e:  # surfaced on the next wait()
                self._error = e
            finally:
                self._queue.task_done()

    def wait(self) -> None:
        """Block until queued writes are on disk; raise a writer error."""
        if self.async_write:
            self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_leaves, metadata) -> None:
        tmp = os.path.join(self.dir, f"tmp_{step:012d}_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(),
                    "metadata": metadata or {}, "leaves": []}
        for i, (name, arr) in enumerate(host_leaves):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "name": name, "file": fn, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
            })
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc_old()

    def _gc_old(self) -> None:
        for s in self._complete_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore ----------------------------------------------------------
    def restore(self, step: int, template, *, placements=None,
                verify: bool = False):
        """Load ``step`` into the structure of ``template``: a tensor leaf
        comes back as a tensor of its dtype on its device, an ``int`` leaf
        as an ``int``, anything else as a numpy array.

        ``placements`` (the elastic path): a tree of ``template``'s
        structure, or part of it, whose leaves place tensor leaves: a
        device puts the leaf there; ``(mesh, dim)`` splits the whole
        stored leaf along ``dim`` into ``mesh.world`` equal shards and
        returns their list, shard ``i`` on ``mesh.devices[i]``; None (or
        a missing entry) keeps the template's device.

        Raises:
            ValueError: ``verify`` and a leaf's SHA-1 differs from the
                manifest's ("corrupt leaf"), a shape differs from the
                template's, or a leaf's ``dim`` does not split evenly over
                its mesh.
        """
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        by_name = {rec["name"]: rec for rec in manifest["leaves"]}

        def load(sub, prefix: str, place):
            if isinstance(sub, Mapping):
                return {k: load(v, f"{prefix}{k}/",
                                place.get(k) if isinstance(place, Mapping)
                                else None)
                        for k, v in sub.items()}
            name = prefix[:-1]
            rec = by_name[name]
            arr = np.load(os.path.join(d, rec["file"]))
            if verify and hashlib.sha1(arr.tobytes()).hexdigest() \
                    != rec["sha1"]:
                raise ValueError(f"corrupt leaf {name} in {d}")
            if isinstance(sub, torch.Tensor):
                if tuple(arr.shape) != tuple(sub.shape):
                    raise ValueError(f"leaf {name}: checkpoint shape "
                                     f"{arr.shape}, template "
                                     f"{tuple(sub.shape)}")
                leaf = torch.from_numpy(arr).to(dtype=sub.dtype)
                if isinstance(place, tuple):
                    return _split(leaf, *place, name)
                return leaf.to(sub.device if place is None else place)
            return int(arr) if isinstance(sub, int) else arr

        return load(template, "", placements)

    def metadata(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "MANIFEST.json")) as f:
            return json.load(f)["metadata"]
