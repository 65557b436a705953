"""Device meshes (the port of ``repro.launch.mesh``).

Single pod: (16, 16), axes ('data', 'model').  Multi-pod: (2, 16, 16),
axes ('pod', 'data', 'model').  On the ``meta`` device any shape builds
(placeholders, shapes only): the dry run's production meshes, the
counterpart of JAX's 512 placeholder host devices.

JAX runs a mesh from one process; the port runs one process a rank
(:mod:`repro_torch.runtime.ranks`).  Without a process group a mesh
spans this process's devices: on one H100 the only mesh that builds is
(1, 1) (or (1,) and the like), and a larger shape raises ``ValueError``,
as ``jax.make_mesh`` does when the devices are too few.  Once
``init_ranks`` has made the default process group, a mesh spans the
world's ranks instead: its shape must hold exactly the world's size,
rank r sits at the row-major coordinate r (JAX's device order for a
mesh of that shape), and each rank runs on its own device
(``runtime.ranks.rank_device``).

:class:`Mesh` is the port's own small record: ``axis_names``,
``devices`` (an object array of ``torch.device`` in the mesh's shape)
and, over ranks, ``ranks`` (the rank at each coordinate) and
``device`` (this rank's device).  ``runtime.ranks.device_mesh`` gives a
rank mesh its ``torch.distributed.DeviceMesh`` with the mesh's axis
names, on which :mod:`repro_torch.runtime.sharding` places DTensors;
:func:`fake_device_mesh` gives any mesh one over a fake process group,
for the dry run's DTensors of ``meta`` shards.  The sharding rules read
only ``axis_names`` and ``devices.shape``, so they run over any mesh
shape, the production ones included, whatever devices are present.

Functions, not module constants: importing this module touches no
device and starts no process group.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.runtime.ranks import rank_device, world

__all__ = ["Mesh", "make_mesh_compat", "make_production_mesh",
           "make_host_mesh", "local_devices", "fake_device_mesh"]


class Mesh:
    """Named axes over an array of devices (``devices.shape`` is the
    mesh's shape, ``axis_names`` one name an axis).  A mesh over ranks
    also holds ``ranks``, the rank at each coordinate, and ``device``,
    this rank's device; otherwise both are None."""

    def __init__(self, devices, axis_names, *, ranks=None, device=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        self.ranks = None if ranks is None else np.asarray(ranks)
        self.device = device
        self._device_mesh = None
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axis names {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        where = (f"{self.size} ranks" if self.ranks is not None else
                 sorted({str(d) for d in self.devices.flat}))
        return f"Mesh({axes}; {where})"


def local_devices(device=None) -> list[torch.device]:
    """The devices a mesh may span: every visible CUDA device (``device``
    None or a CUDA device; None raises without a card), or the one CPU
    device when the caller asks for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_mesh_compat(shape: tuple[int, ...], axes: tuple[str, ...], *,
                     device=None) -> Mesh:
    """A mesh of ``shape`` named ``axes``: over the world's ranks when a
    default process group exists (a size other than the world's raises
    ``ValueError``), else over the first ``prod(shape)`` devices of
    :func:`local_devices` (``device``: None for the card, ``"cpu"`` for the
    host, ``"meta"`` for placeholders of any number, also in a world of
    ranks); too few devices raise ``ValueError``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    ranked = world()
    if ranked is not None and torch.device(device or "cuda").type != "meta":
        size = ranked[1]
        if n != size:
            raise ValueError(f"mesh of shape {shape} needs {n} ranks; the "
                             f"world has {size}")
        dev = rank_device(device)
        # every rank of a host sits on its host's cards in LOCAL_RANK order
        local = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        arr = np.empty(n, dtype=object)
        arr[:] = [dev if dev.type != "cuda" else torch.device(
            "cuda", (r % local) % torch.cuda.device_count())
            for r in range(n)]
        return Mesh(arr.reshape(shape), axes,
                    ranks=np.arange(n).reshape(shape), device=dev)
    devices = local_devices(device)
    if devices[0].type == "meta":
        devices = devices * n
    if n > len(devices):
        raise ValueError(f"Number of devices {len(devices)} must be >= the "
                         f"product of mesh_shape {shape}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device=device)


def make_host_mesh(*, data: int | None = None, model: int = 1,
                   device=None) -> Mesh:
    """A small ('data', 'model') mesh over whatever devices exist (tests,
    examples): the world's ranks in a process group (JAX's spans the
    local devices), else this process's devices."""
    ranked = world()
    n = ranked[1] if ranked is not None else len(local_devices(device))
    data = data if data is not None else n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} devices")
    return make_mesh_compat((data, model), ("data", "model"), device=device)


def fake_device_mesh(mesh: Mesh):
    """A ``torch.distributed.DeviceMesh`` of ``mesh``'s shape and axis
    names over a fake process group of ``mesh.size`` ranks, this process
    rank 0: collectives are issued and complete at once, moving nothing.
    The dry run places DTensors of ``meta`` shards on it.

    The fake backend lives in ``torch.testing._internal`` (private to
    PyTorch), so it is imported here and nowhere else.  The default
    process group must not exist yet; the caller tears it down
    (``torch.distributed.destroy_process_group()``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "fake_device_mesh needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "PyTorch build lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    # device type "cpu": DTensor prices redistributions by the device
    # count of its mesh's type, which "meta" has none of; the shards are
    # meta tensors all the same
    return init_device_mesh("cpu", tuple(mesh.devices.shape),
                            mesh_dim_names=mesh.axis_names)
