"""Checkpoint save/restore and async writes, in the JAX package's format
(the port of ``repro.train.checkpoint``).

Layout: one directory per step —
    <dir>/step_00000123/
        manifest.json          # step, paths, dtypes, shapes, extra
        arr_00000.npy ...      # one file per leaf (np.save)
        DONE                   # atomic completion marker

A tree is nested dicts, tuples and lists of tensors (or numpy arrays).
Its leaves are listed, and named in ``paths``, as JAX's
``tree_flatten_with_path`` lists and prints them: dict keys sorted and
printed as ``['name']``, tuple and list indices as ``[i]``, joined with
``/`` (``"[0]/['embed']/['tok']"``).  So a checkpoint written by either
package restores in the other.

Fault-tolerance contract (``launch.train``):
  * writes go to ``step_X.tmp`` then ``os.rename``: crash-safe;
  * ``latest_step`` only considers directories with a DONE marker;
  * ``AsyncCheckpointer`` copies every leaf to the host before ``save``
    returns and writes the files on a background thread; an error there
    is raised at the next ``wait()``.
On a mesh (DTensor leaves) ``save`` writes each leaf's full tensor, so
the files are the same as one device's: every rank calls it (gathering a
leaf is a collective) and rank 0 of the process group writes.
``restore(..., shardings=)`` places each leaf on its target mesh as its
``NamedSharding`` says, so a checkpoint written on one mesh (or by the
JAX package on its) loads onto any other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.dist import sharding
from repro_torch.models.layers import (
    resolve_device, tree_leaves, tree_unflatten,
)


def _flatten_with_paths(tree, prefix: str = ""):
    """(paths, leaves) in JAX's order and naming."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", x) for i, x in enumerate(tree)]
    else:
        return [prefix], [tree]
    paths, out = [], []
    for name, sub in items:
        p, l_ = _flatten_with_paths(sub, f"{prefix}/{name}" if prefix
                                    else name)
        paths += p
        out += l_
    return paths, out


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory as a numpy array (a DTensor's
    full value: a collective, every rank calls it)."""
    if sharding.is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype here; keep "
                            "checkpointed state in f32 (param_dtype, "
                            "opt_dtype)")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _writer() -> bool:
    """Whether this process writes: rank 0 of the process group, or the
    only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _write(path: str, paths: list[str], host: list[np.ndarray], *,
           step: int, extra: dict | None) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    if not _writer():
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "paths": paths,
        "dtypes": [str(a.dtype) for a in host],
        "shapes": [list(a.shape) for a in host],
        "extra": extra or {},
    }
    for i, a in enumerate(host):
        np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(path: str, tree, *, step: int, extra: dict | None = None) -> str:
    """Synchronous checkpoint write.  Returns the final directory."""
    paths, flat = _flatten_with_paths(tree)
    return _write(path, paths, [_to_host(x) for x in flat], step=step,
                  extra=extra)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    best = None
    for name in os.listdir(path):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(path, name, "DONE")):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore(path: str, step: int, like_tree, *, device="cuda",
            shardings=None):
    """Load a checkpoint into the structure of ``like_tree``, every leaf a
    tensor on ``device`` (a CUDA device raises without a card).  Returns
    (tree, manifest).

    ``shardings``: optional tree of ``NamedSharding`` beside
    ``like_tree``: each leaf becomes a DTensor laid out as its sharding
    on the sharding's mesh (on the mesh's device type; every rank reads
    the files and keeps its own slice), so any mesh can load any
    checkpoint (resharding restore)."""
    if shardings is not None:
        device = tree_leaves(shardings)[0].mesh.device_type
    dev = resolve_device(device)
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, _ = _flatten_with_paths(like_tree)
    if paths != manifest["paths"]:
        raise ValueError(
            "checkpoint tree mismatch: "
            f"{set(paths) ^ set(manifest['paths'])}")
    arrays = [torch.from_numpy(np.load(os.path.join(d, f"arr_{i:05d}.npy")))
              .to(dev) for i in range(len(paths))]
    tree = tree_unflatten(like_tree, arrays)
    if shardings is not None:
        tree = _place(tree, shardings)
    return tree, manifest


def _place(tree, shardings):
    """``tree``'s tensors distributed as the matching ``shardings``
    (nested dicts, tuples and lists alike)."""
    if isinstance(tree, dict):
        return {k: _place(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_place(t, s) for t, s in zip(tree, shardings))
    return sharding.distribute(tree, shardings)


class AsyncCheckpointer:
    """Snapshot on-thread, write off-thread; at most one write in flight."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def save(self, tree, *, step: int, extra: dict | None = None) -> None:
        self.wait()
        paths, flat = _flatten_with_paths(tree)
        host = [_to_host(x) for x in flat]      # snapshot before returning

        def work():
            try:
                _write(self.path, paths, host, step=step, extra=extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1))
            for name in os.listdir(self.path)
            if (m := re.fullmatch(r"step_(\d+)", name))
            and os.path.exists(os.path.join(self.path, name, "DONE"))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)
