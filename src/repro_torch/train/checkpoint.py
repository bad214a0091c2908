"""Checkpointing: atomic commit, async writer, auto-resume.

Layout (the reference's)::

    <dir>/step_00001234/arrays.npz      flattened path->array archive
    <dir>/step_00001234/MANIFEST.json   step, checksum, leaf count, meta
    <dir>/LATEST                        name of the newest *committed* step

Writes go to ``<dir>/.tmp-<step>`` first and are ``os.rename``d into place
(rename is atomic on POSIX), the manifest is written last, and LATEST is
swapped by tmp-file rename, so a crash at any point leaves either the old
or the new checkpoint intact, never a torn one.  :func:`latest_valid`
checks the checksum and walks back past corrupt or partial steps.

Tensors go to host numpy on save (bf16 widened to f32, losslessly) and
back to the template leaf's device, dtype and ``requires_grad`` on
restore; numpy leaves stay numpy.  The asynchronous writer takes the host
copy on the caller's thread and leaves the disk to a writer thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.tree import map_with_path, paths, tree_map

PyTree = Any
_SEP = "\x1d"          # path separator inside npz keys


def _to_host(leaf) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype.is_floating_point and t.element_size() < 4:
            t = t.to(torch.float32)                # npz-portable, lossless
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: PyTree) -> dict[str, np.ndarray]:
    return {_SEP.join(map(str, p)): _to_numpy(v) for p, v in paths(tree)}


def _like(arr: np.ndarray, tmpl) -> Any:
    if isinstance(tmpl, torch.Tensor):
        t = torch.from_numpy(np.array(arr)).to(device=tmpl.device,
                                               dtype=tmpl.dtype)
        return t.requires_grad_(tmpl.requires_grad)
    return np.asarray(arr, dtype=np.asarray(tmpl).dtype)


def _tree_like(template: PyTree, arrays: dict[str, np.ndarray]) -> PyTree:
    def leaf(path, tmpl):
        key = _SEP.join(map(str, path))
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _like(arrays[key], tmpl)
    return map_with_path(leaf, template)


def _checksum(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(ckpt_dir: str, step: int, tree: PyTree,
         meta: dict | None = None) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, f".tmp-{name}")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(tree)
    npz_path = os.path.join(tmp, "arrays.npz")
    with open(npz_path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    manifest = {"step": step, "checksum": _checksum(npz_path),
                "n_leaves": len(arrays), "meta": meta or {}}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def _valid(ckpt_dir: str, name: str) -> bool:
    d = os.path.join(ckpt_dir, name)
    mpath = os.path.join(d, "MANIFEST.json")
    npz = os.path.join(d, "arrays.npz")
    if not (os.path.isfile(mpath) and os.path.isfile(npz)):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        return manifest["checksum"] == _checksum(npz)
    except (OSError, ValueError, KeyError, TypeError):
        return False


def list_steps(ckpt_dir: str) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(n for n in os.listdir(ckpt_dir) if n.startswith("step_"))


def latest_valid(ckpt_dir: str) -> str | None:
    """Newest committed and checksummed step (walks past corrupt ones)."""
    for name in reversed(list_steps(ckpt_dir)):
        if _valid(ckpt_dir, name):
            return name
    return None


def restore(ckpt_dir: str, name: str, template: PyTree
            ) -> tuple[PyTree, dict]:
    """Load a step into ``template``'s structure (each tensor onto the
    template leaf's device and dtype)."""
    d = os.path.join(ckpt_dir, name)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    return _tree_like(template, arrays), manifest


def restore_latest(ckpt_dir: str, template: PyTree
                   ) -> tuple[PyTree, dict] | None:
    name = latest_valid(ckpt_dir)
    if name is None:
        return None
    return restore(ckpt_dir, name, template)


class AsyncCheckpointer:
    """Background writer thread: ``save`` returns once the host copy is
    taken; ``wait`` drains the queue (call before exit)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, meta = item
            try:
                save(self.ckpt_dir, step, host_tree, meta)
                self._gc()
            except Exception as e:      # noqa: BLE001 — surfaced on save/wait
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        names = [n for n in list_steps(self.ckpt_dir)
                 if _valid(self.ckpt_dir, n)]
        for n in names[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, n), ignore_errors=True)

    def save(self, step: int, tree: PyTree, meta: dict | None = None):
        if self._err:
            raise self._err
        self._q.put((step, tree_map(_to_host, tree), meta))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()
