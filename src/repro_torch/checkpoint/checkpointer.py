"""Checkpointing: async and atomic (the port of
``repro.checkpoint.checkpointer``, with its protocol).

  * **atomic**: writes go to ``step_<N>.tmp/`` and are renamed to
    ``step_<N>/`` only after every leaf and the fsync'd manifest are
    written, so a half-written checkpoint is never visible to restore.
  * **async**: :meth:`Checkpointer.save` copies the tensors to host
    memory synchronously and writes them on a background thread, one
    save outstanding at a time; the train loop is blocked only for the
    device-to-host copy (which is a copy on the CPU too: the loop
    updates its tensors in place afterwards).
  * **keep-k** garbage collection of old steps.

Storage is one ``leaf_%05d.npy`` a leaf in :func:`repro_torch.tree.flatten`
order (a dict by sorted key, a list or tuple in order, an ``OptState``
as mu, nu, step).  numpy has no bfloat16, so a bf16 leaf is stored as
its 16-bit words; the manifest lists every leaf's dtype.

Across ranks (DTensor leaves, :mod:`repro_torch.runtime.sharding`) a
checkpoint holds the same global arrays: every rank joins the gather of
each leaf, rank 0 alone writes, in the foreground, and the others wait
at a barrier until the checkpoint is published.  So checkpoints written
by one rank and by many are interchangeable, and
``restore(shardings=..., device_mesh=...)`` places each leaf on any
mesh (the elastic re-mesh of
:func:`repro_torch.runtime.fault_tolerance.elastic_restore`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.runtime import sharding as shard_rules
from repro_torch.tree import flatten, unflatten

__all__ = ["Checkpointer"]


def _to_host(x: torch.Tensor) -> np.ndarray:
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot now, write in the background."""
        self.wait()  # one outstanding save at a time
        leaves, treedef = flatten(tree)
        ranked = any(shard_rules.is_dtensor(x) for x in leaves)
        # device->host copy, a leaf at a time: a DTensor leaf is gathered
        # whole and copied before the next is gathered, so at most one
        # whole leaf is ever alive on a rank's device
        host_leaves = [_to_host(x.full_tensor() if shard_rules.is_dtensor(x)
                                else x) for x in leaves]
        spec = {"treedef": str(treedef), "n_leaves": len(leaves),
                "step": step,
                "dtypes": [str(x.dtype).removeprefix("torch.")
                           for x in leaves]}

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
                final = os.path.join(self.dir, f"step_{step:010d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, arr in enumerate(host_leaves):
                    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(spec, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)   # atomic publish
                self._gc()
            except Exception as e:       # surfaced on next wait()
                self._error = e

        if ranked:
            # rank 0 publishes the checkpoint before any rank goes on
            if dist.get_rank() == 0:
                write()
            dist.barrier()
            self.raise_if_failed()
        elif blocking:
            write()
            self.raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err}")

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, *, step: int | None = None,
                device=None, shardings: Any = None,
                device_mesh=None) -> tuple[Any, int]:
        """Restore onto ``template``'s structure (global shapes): (tree,
        step), every leaf a tensor of its stored dtype on ``device``
        (None: the card), or, given ``shardings`` (a matching tree of
        :class:`~repro_torch.runtime.sharding.NamedSharding`) and the
        ``device_mesh`` of a mesh over ranks, placed by them on that
        mesh's device."""
        self.wait()
        if shardings is not None:
            device = "cpu"      # placement copies each shard to the mesh
        device = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        leaves, treedef = flatten(template)
        loaded = [np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
                  for i in range(len(leaves))]
        for tpl, arr in zip(leaves, loaded):
            if tuple(tpl.shape) != tuple(arr.shape):
                raise ValueError(
                    f"checkpoint/model shape mismatch: {arr.shape} vs "
                    f"{tuple(tpl.shape)} — wrong arch for this checkpoint?")
        placed = [_from_host(a, d, device) for a, d in zip(loaded, dtypes)]
        tree = unflatten(treedef, placed)
        if shardings is not None:
            tree = shard_rules.place(tree, shardings, device_mesh)
        return tree, step

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)
