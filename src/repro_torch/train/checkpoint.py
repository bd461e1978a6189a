"""Checkpointing: pytree save/restore with atomic, async writes (PyTorch
port of ``repro.train.checkpoint``, in its on-disk format).

Format: one ``.npz`` per checkpoint step holding every leaf (its key path
-> array, copied to the host) + a JSON manifest.  Keys are the strings
``jax.tree_util.keystr`` gives: ``['params']['embed']`` for a dict key,
``.prev_norm`` for a NamedTuple field (the trees hold no lists); bf16
(which ``.npz`` cannot hold) is stored as f32.  A tree in the JAX
package's layout (:func:`repro_torch.models.transformer.params_tree`)
therefore writes the file the JAX package writes, and each package
restores the other's checkpoints.  Writes go to a temp name and are
atomically renamed, so a failure mid-write never corrupts the latest
checkpoint.

Async: :meth:`CheckpointManager.save` copies the tree to the host, then
writes it on a background thread, so the training loop only blocks for
the device-to-host copy.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_NPZ_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16",
               "int8", "uint8", "bool")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) in the JAX package's flattening order: a dict's
    keys sorted, a NamedTuple's fields in order."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _items(getattr(tree, f), f"{prefix}.{f}")
    else:
        yield prefix, tree


def _map(fn: Callable, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(key path, leaf)``."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, getattr(tree, f), f"{prefix}.{f}")
                            for f in tree._fields))
    return fn(prefix, tree)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if str(t.dtype).replace("torch.", "") not in _NPZ_DTYPES:
            t = t.float()                      # bf16 -> f32 for npz
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if str(arr.dtype) not in _NPZ_DTYPES:
        arr = arr.astype(np.float32)
    return arr


def to_host(tree):
    """The tree with every leaf a numpy array on the host (bf16 as f32)."""
    return _map(lambda _, leaf: _host(leaf), tree)


def save_pytree(tree, directory, step: int) -> Path:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    flat = {k: _host(v) for k, v in _items(tree)}
    tmp = d / f".tmp-{step}-{os.getpid()}.npz"
    final = d / f"step_{step:08d}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)                      # atomic publish
    manifest = d / f"step_{step:08d}.json"
    manifest.write_text(json.dumps({
        "step": step, "leaves": len(flat), "time": time.time()}))
    return final


def latest_step(directory) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1]) for p in d.glob("step_*.npz"))
    return steps[-1] if steps else None


def restore_pytree(template, directory, step: Optional[int] = None):
    """Restore into the structure of ``template``: each tensor leaf comes
    back with the template leaf's dtype and device (a numpy leaf as a
    numpy array of its dtype).  Returns ``(tree, step)``."""
    d = Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {d}")
    with np.load(d / f"step_{step:08d}.npz") as data:
        def leaf(key, like):
            arr = data[key]
            if isinstance(like, torch.Tensor):
                return torch.from_numpy(arr).to(device=like.device,
                                                dtype=like.dtype)
            return arr.astype(np.asarray(like).dtype)
        return _map(leaf, template), step


class CheckpointManager:
    """Async checkpointer with retention.

    save(): device-to-host copy synchronously, disk write on a daemon
    thread; keeps the last ``keep`` checkpoints.  ``wait()`` joins pending
    writes (called before exit and in tests).  ``stats`` adds up the bytes
    written and the seconds of the copy and of the write.
    """

    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self.stats: Dict[str, float] = {"saves": 0, "bytes": 0,
                                        "copy_s": 0.0, "write_s": 0.0}

    def save(self, tree, step: int, blocking: bool = False):
        t0 = time.perf_counter()
        host_tree = to_host(tree)                  # snapshot
        self.stats["copy_s"] += time.perf_counter() - t0
        self.wait()

        def write():
            t1 = time.perf_counter()
            path = save_pytree(host_tree, self.dir, step)
            self.stats["write_s"] += time.perf_counter() - t1
            self.stats["bytes"] += path.stat().st_size
            self.stats["saves"] += 1
            self._gc()

        if blocking:
            write()
        else:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore(self, template, step: Optional[int] = None):
        return restore_pytree(template, self.dir, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.dir)

    def _gc(self):
        steps = sorted(int(p.stem.split("_")[1])
                       for p in self.dir.glob("step_*.npz"))
        for s in steps[:-self.keep]:
            for suffix in (".npz", ".json"):
                p = self.dir / f"step_{s:08d}{suffix}"
                if p.exists():
                    p.unlink()
