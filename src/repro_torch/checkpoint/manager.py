"""Checkpointing (the port of ``repro.checkpoint.manager``): atomic step
directories, an async writer thread, elastic restore (onto other devices)
and retention GC.

Layout:  <root>/step_<N>/ arrays.npz + tree.json + COMMIT (marker written
last; a directory without COMMIT is incomplete and ignored by restore),
the JAX package's. Leaves are written in the tree's flattening order
(dict keys sorted, as ``jax.tree_util`` sorts them) as ``leaf_<i>``.
numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf is stored as
its int16 bits; ``tree.json`` records every leaf's torch dtype, and
restore gives each leaf back bit for bit. ``restore`` also reads the JAX
package's checkpoints, which have no dtype record: their bf16 leaves
(``ml_dtypes.bfloat16``, which numpy writes as 2-byte void) come back as
bf16 bit for bit. The other way round, the JAX package's restore reads
the port's bf16 leaves as int16 (its bits; the JAX package cannot
restore its own bf16 leaves either, as ``jnp.asarray`` refuses void).

``restore`` places every leaf on the device of the matching leaf of the
target tree, or on the devices ``shardings`` names -- the port's elastic
case: a tree saved from the card restores onto the CPU, and the other way
round.

On a mesh of ranks (``specs``, ``mesh``: a ``core.mesh.MeshGrid`` and the
spec tree its shards follow, ``models.shard_specs``) the files stay the
one-process layout: ``AsyncCheckpointer.save`` gathers every full leaf
(each rank takes part, leaf by leaf through host memory) and rank 0
writes them, and ``restore`` cuts each rank's shard from the full leaf.
A run saved on one mesh resumes on any other.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.models import sharding

PyTree = Any


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    t = torch.as_tensor(x).detach().cpu()
    name = _dtype_name(t.dtype)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name is None:        # written by the JAX package: no dtype record
        if arr.dtype.kind != "V":
            return torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a leaf stored as {arr.dtype} has no torch "
                             f"dtype")
        # ml_dtypes.bfloat16, which numpy writes as 2-byte void
        arr, name = arr.view(np.int16), "bfloat16"
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if name == "bfloat16":
        return t.view(torch.bfloat16)
    want = getattr(torch, name)
    if t.dtype != want:
        raise ValueError(f"a leaf stored as {arr.dtype} is recorded as {name}")
    return t


def _flatten(tree: PyTree) -> Tuple[Dict[str, np.ndarray], List[str],
                                    List[str]]:
    arrays, dtypes, paths = {}, [], []
    for i, (path, x) in enumerate(tree_mod.paths(tree)):
        arrays[f"leaf_{i}"], name = _to_numpy(x)
        dtypes.append(name)
        paths.append("/".join(path))
    return arrays, dtypes, paths


def save(root: str, step: int, tree: PyTree) -> str:
    """Synchronous atomic save."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes, paths = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"treedef": paths, "step": step, "n_leaves": len(arrays),
                   "dtypes": dtypes}, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, "COMMIT")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    s = steps(root)
    return s[-1] if s else None


def _placements(target: PyTree, shardings) -> List[torch.device]:
    leaves = tree_mod.leaves(target)
    if shardings is None:
        devs = [x.device if isinstance(x, torch.Tensor)
                else torch.device("cpu") for x in leaves]
    elif tree_mod.is_node(shardings):
        devs = [torch.device(d) for d in tree_mod.leaves(shardings)]
    else:
        devs = [torch.device(shardings)] * len(leaves)
    if len(devs) != len(leaves):
        raise ValueError(f"{len(devs)} placements for {len(leaves)} leaves")
    if any(d.type == "meta" for d in devs):
        raise ValueError("a target leaf on the meta device needs a device "
                         "from shardings")
    return devs


def restore(root: str, step: Optional[int] = None,
            target: Optional[PyTree] = None,
            shardings: Optional[PyTree] = None, specs: Optional[PyTree] = None,
            mesh=None) -> Tuple[PyTree, int]:
    """Restore a checkpoint. ``target`` (a tree of tensors, meta tensors
    included, with the same structure) rebuilds the tree, and each leaf
    must match its target's shape and dtype. Leaves go to their target's
    device, or with ``shardings`` (one device, or a tree of devices) where
    it says -- the devices may differ from the ones that saved (elastic
    restart). With ``mesh`` each leaf is cut to this rank's shard under
    ``specs`` (a spec tree of ``target``'s structure, lists for its
    tuples) before it is placed, and ``target`` holds shards."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
    path = os.path.join(root, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"checkpoint {path} is incomplete")
    if target is None:
        raise ValueError("restore requires a target tree (structure donor)")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    want = tree_mod.leaves(target)
    if meta["n_leaves"] != len(want):
        raise ValueError(f"checkpoint {path} holds {meta['n_leaves']} "
                         f"leaves, the target {len(want)}")
    devs = _placements(target, shardings)
    names = meta.get("dtypes", [None] * len(want))
    cuts = ([None] * len(want) if mesh is None
            else sharding.spec_leaves(specs))
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (name, dev, like, cut) in enumerate(zip(names, devs, want,
                                                       cuts)):
            t = _from_numpy(data[f"leaf_{i}"], name)
            if cut is not None:
                t = sharding.shard_leaf(t, cut, mesh).clone()
            if isinstance(like, torch.Tensor) and (
                    t.shape != like.shape or t.dtype != like.dtype):
                raise ValueError(
                    f"leaf {i} is {tuple(t.shape)} {t.dtype}, the "
                    f"target's {tuple(like.shape)} {like.dtype}")
            leaves.append(t.to(dev))
    return tree_mod.unflatten(target, leaves), step


def gc(root: str, keep_last: int = 3) -> List[int]:
    """Delete all but the newest ``keep_last`` complete checkpoints."""
    all_steps = steps(root)
    removed = []
    for s in all_steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"))
        removed.append(s)
    return removed


def _host_copy(x) -> torch.Tensor:
    """A host tensor that no later in-place update of ``x`` reaches:
    ``tensor.to("cpu")`` of a CPU tensor returns the tensor itself."""
    return torch.as_tensor(x).detach().to("cpu", copy=True)


class AsyncCheckpointer:
    """Background-thread writer: ``save`` snapshots the tree to host memory
    synchronously and enqueues the disk write. ``wait()`` drains the
    queue; errors surface on the next call. With ``mesh`` and ``specs``
    every rank of the mesh holds one and calls ``save`` together: the
    full leaves are gathered and rank 0 alone writes them."""

    def __init__(self, root: str, keep_last: int = 3, mesh=None,
                 specs: Optional[PyTree] = None):
        self.root = root
        self.keep_last = keep_last
        self.mesh, self.specs = mesh, specs
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree = item
            try:
                save(self.root, step, host_tree)
                gc(self.root, self.keep_last)
            except Exception as e:  # surfaced on next save/wait
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree: PyTree):
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if self.mesh is not None:
            tree = sharding.unshard(tree, self.specs, self.mesh, to="cpu")
            if self.mesh.rank != 0:
                return
        self._q.put((step, tree_mod.map(_host_copy, tree)))

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self._q.put(None)
        self._q.join()
        self._thread.join()
