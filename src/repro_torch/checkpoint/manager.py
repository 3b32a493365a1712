"""Fault-tolerant checkpointing: atomic publish, async writer, retention,
restart from the latest (the JAX package's ``checkpoint/manager.py``).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``tree.json``, plus
``<dir>/LATEST`` written last (atomic rename), so a crash mid-save never
corrupts the restore path: the previous LATEST stays valid.

Two changes from the reference.  The structure file is the port's own
JSON (dicts, lists and tuples of tensors and Python scalars; the
reference pickles a JAX ``PyTreeDef``, which cannot be read without
JAX), so checkpoints do not cross between the two packages.  And
``restore(device=)`` puts the tensors on one device, where the reference
re-places arrays onto a mesh's shardings.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, host: list):
    """The JSON structure of ``tree``; its tensors appended to ``host`` as
    numpy arrays (bf16 as its uint16 bit pattern)."""
    if isinstance(tree, dict):
        return {"dict": [[k, _flatten(v, host)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, host) for v in tree]}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = False):
        """Copy to host memory now; write to disk on a thread (one write
        at a time) unless ``blocking`` or the manager is synchronous."""
        host: list = []
        structure = _flatten(tree, host)            # device→host copy now
        if self.async_save and not blocking:
            self.wait()                              # one writer at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, host, structure),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, structure)

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
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, step: int | None = None, device=None):
        """Load a checkpoint (the latest when ``step`` is None) → ``(step,
        tree)``, its tensors on ``device`` (left on the CPU when None);
        ``(None, None)`` when there is none."""
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
        return step, _unflatten(structure, arrays, device)
