"""Fault-tolerant checkpointing: atomic publish, async writer, retention,
restart from the latest, and elastic re-sharding on restore (the JAX
package's ``checkpoint/manager.py``).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``tree.json``, plus
``<dir>/LATEST`` written last (atomic rename), so a crash mid-save never
corrupts the restore path: the previous LATEST stays valid.

Trees nest dicts, lists and tuples of tensors and Python scalars.  Leaves
may be DTensors (the LM mesh path, ``launch/steps.py``): ``save`` then
gathers them one at a time to the full tensor, on the calling thread, on
every rank in the same order (``full_tensor`` is a collective, and one
called from the writer thread could deadlock); rank 0 copies each to the
host at once and the other ranks drop theirs, so the device holds one
gathered leaf at a time above the shards.  Rank 0 alone writes and
publishes, and every rank meets the others at a barrier once the write
is done (in ``wait``), so ``latest_step()`` agrees on every rank after
it.  A checkpoint holds full tensors either way, so the mesh path and
the one-device path read what the other wrote.
``restore(placements=, mesh=)`` re-places each leaf onto the *current*
mesh, the reference's ``restore(shardings=)``: a job saved on one mesh
shape resumes on another, or on one device, with no conversion step.
The placements are the target mesh's (``launch.steps.
train_state_placements``), never the saved ones: ZeRO-1's moments differ
from the parameters' and from mesh to mesh, and a dimension the new mesh
does not divide is replicated there, as when the tensors were first
placed.

One change from the reference: the structure file is the port's own
JSON (the reference pickles a JAX ``PyTreeDef``, which cannot be read
without JAX), so checkpoints do not cross between the two packages.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding_ctx import distribute


def _flatten(tree, host: list, keep: bool = True):
    """The JSON structure of ``tree``; its tensors appended to ``host`` as
    numpy arrays (bf16 as its uint16 bit pattern).  A DTensor leaf is
    gathered to its full tensor first (a collective); with ``keep`` false
    (a mesh rank that does not write) it is dropped, not copied."""
    if isinstance(tree, dict):
        return {"dict": [[k, _flatten(v, host, keep)]
                         for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, host, keep)
                                      for v in tree]}
    if isinstance(tree, torch.Tensor):
        t = tree.full_tensor() if isinstance(tree, DTensor) else tree
        if not keep:
            return None
        t = t.detach().to("cpu", copy=True)
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        host.append(t.numpy())
        return {"tensor": len(host) - 1, "dtype": dtype}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _unflatten(node, arrays, device):
    if "tensor" in node:
        t = torch.from_numpy(arrays[f"a{node['tensor']}"])
        if node["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t if device is None else t.to(device)
    (kind, body), = node.items()
    if kind == "dict":
        return {k: _unflatten(v, arrays, device) for k, v in body}
    if kind in ("list", "tuple"):
        items = [_unflatten(v, arrays, device) for v in body]
        return items if kind == "list" else tuple(items)
    return body                                       # "value"


def _on_mesh(tree) -> bool:
    if isinstance(tree, dict):
        return any(_on_mesh(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_mesh(v) for v in tree)
    return isinstance(tree, DTensor)


def _mesh_device(mesh) -> torch.device:
    """The device this rank's blocks of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._barrier = False            # the pending save was a mesh's
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = False):
        """Copy to host memory now; write to disk on a thread (one write
        at a time) unless ``blocking`` or the manager is synchronous.  A
        tree with DTensor leaves is gathered leaf by leaf, on every rank;
        rank 0 writes it (see the module's docstring)."""
        mesh = _on_mesh(tree)
        writer = not mesh or dist.get_rank() == 0
        host: list = []
        structure = _flatten(tree, host, writer)   # collectives, here
        del tree                            # device→host copy made
        self.wait()                         # one writer at a time
        if writer:
            if self.async_save and not blocking:
                self._thread = threading.Thread(
                    target=self._write, args=(step, host, structure),
                    daemon=True)
                self._thread.start()
            else:
                self._write(step, host, structure)
        self._barrier = mesh
        if blocking or not self.async_save:
            self.wait()

    def _write(self, step: int, host, structure):
        tmp = os.path.join(self.directory, f".tmp_step_{step}")
        final = os.path.join(self.directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(structure, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                        # atomic publish
        latest_tmp = os.path.join(self.directory, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.rename(latest_tmp, os.path.join(self.directory, "LATEST"))
        self._gc()

    def wait(self):
        """Until the last save is on disk; after a mesh's save, until it
        is on disk for every rank (a barrier of the process group)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        path = os.path.join(self.directory, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.directory, f"step_{s}")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device=None, *,
                placements=None, mesh=None):
        """Load a checkpoint (the latest when ``step`` is None) → ``(step,
        tree)``, its tensors on ``device`` (left on the CPU when None);
        ``(None, None)`` when there is none.  With ``placements`` (a tree
        like the saved one whose leaves are placement lists, or ``None``
        for a leaf to keep whole) each tensor becomes a DTensor on
        ``mesh``: this rank's block of it, cut on the host and moved to
        ``device`` (default: the mesh's device on this rank)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "tree.json")) as f:
            structure = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if placements is None:
            return step, _unflatten(structure, arrays, device)
        if mesh is None:
            raise ValueError("restore(placements=) needs the mesh to place "
                             "the tensors on")
        return step, distribute(_unflatten(structure, arrays, None),
                                placements, mesh,
                                device or _mesh_device(mesh))
