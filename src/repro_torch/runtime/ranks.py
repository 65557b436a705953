"""Ranks: the process group the port runs a mesh over, one process a rank.

JAX runs a mesh from one process (GSPMD); the port runs one process a
rank (``torch.distributed``).  :func:`init_ranks` makes the default
process group, from ``torchrun``'s environment or over a file store;
:func:`world` reads it; :func:`rank_device` is this rank's device,
``cuda:(LOCAL_RANK % device_count)`` (several ranks may share one card)
or the CPU when the caller asks for it; :func:`device_mesh` gives a mesh
over ranks (:func:`repro_torch.launch.mesh.make_mesh_compat`) its
``torch.distributed.DeviceMesh``; :func:`spawn_ranks` runs a function on
each rank of a new world (tests, ``chip_smoke.py``).

The backend follows from the world: ``nccl`` when every rank of a host
has a card of its own, else gloo (several ranks on one card, or the
CPU), as :class:`HostStagedGloo`.  gloo's own code for CUDA tensors
copies them to pinned host memory, runs the collective there (a
reduction's sums too) and copies the result back.  Two of its paths fail
on CUDA tensors on the H100 (``tests/gloo_cuda_probe.py``, torch 2.11):
point-to-point transfers fail with "Bad address", and the functional
all-gather into a tensor (``torch.ops._c10d_functional``, the one
DTensor calls) kills the process, where ``dist.all_gather_into_tensor``
on the same group passes.  So :class:`HostStagedGloo` hands every
collective to gloo as it is except the all-gathers into a tensor of CUDA
tensors, which it stages through pinned host memory itself
(:func:`host_staged`), and :func:`exchange` stages point-to-point
transfers the same way; each staging is counted in ``obs`` as
``dist.host_staged.<op>``.

Functions, not module constants: importing this module touches no
device and starts no process group.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist
from torch._C import _distributed_c10d as _c10d

from repro_torch import obs, resolve_device

__all__ = ["init_ranks", "world", "rank_device", "device_mesh",
           "HostStagedGloo", "host_staged", "exchange", "spawn_ranks"]

#: the name :func:`init_ranks` registers :class:`HostStagedGloo` under
STAGED_BACKEND = "gloo_host_staged"


def world() -> tuple[int, int] | None:
    """(rank, world size) of the default process group, or None when
    there is none (a fake group, the dry run's, is none either)."""
    if not dist.is_initialized() or dist.get_backend() == "fake":
        return None
    return dist.get_rank(), dist.get_world_size()


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` (None or
    a CUDA device; None raises without a card), or the CPU when the
    caller asks for it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return dev


def device_mesh(mesh):
    """The ``torch.distributed.DeviceMesh`` of a mesh over ranks, with
    the mesh's shape and axis names (made once a mesh, on every rank in
    the same order: it creates the process groups of the axes)."""
    if mesh.ranks is None:
        raise ValueError(f"{mesh!r} spans no ranks: device_mesh needs a "
                         f"mesh made after init_ranks()")
    if mesh._device_mesh is None:
        from torch.distributed.device_mesh import init_device_mesh
        mesh._device_mesh = init_device_mesh(
            mesh.device.type, tuple(mesh.devices.shape),
            mesh_dim_names=mesh.axis_names)
    return mesh._device_mesh


def init_ranks(*, device=None, store_path: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout_s: float = 300.0) -> tuple[int, int]:
    """Initialise the default process group and return (rank, world
    size): from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``), or, given ``store_path``, over a
    file store there with ``rank`` and ``world_size``.  ``device`` is
    where this rank runs (None: the card, ``"cpu"``: the host).

    The backend follows from the world: ``nccl`` when the ranks of a host
    (``LOCAL_WORLD_SIZE``) each have a card of their own, else gloo
    through :class:`HostStagedGloo` (several ranks on one card, or the
    CPU).  ``timeout_s`` bounds every collective, so that a rank that
    died or hangs fails the others instead of holding them for the
    default 30 minutes."""
    dev = resolve_device(device)
    if store_path is not None:
        if rank is None or world_size is None:
            raise ValueError("init_ranks(store_path=...) needs rank and "
                             "world_size")
        store = dist.FileStore(store_path, world_size)
    else:
        rank, world_size = int(os.environ["RANK"]), int(
            os.environ["WORLD_SIZE"])
        store = None
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if dev.type == "cuda":
        # DeviceMesh sets the current device only where none is set
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    if dev.type == "cuda" and local <= torch.cuda.device_count():
        backend = "nccl"
    else:
        if STAGED_BACKEND.upper() not in dist.Backend._plugins:
            dist.Backend.register_backend(STAGED_BACKEND, _make_staged,
                                          devices=["cpu", "cuda"])
        backend = STAGED_BACKEND
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world_size


def host_staged(op: str, reads, writes, run) -> None:
    """Run ``run(host_reads, host_writes)`` on pinned host copies of the
    CUDA tensors ``reads`` (copied from the card; a tensor in both lists
    has one copy) and ``writes`` (copied back to the card after), counting
    ``dist.host_staged.<op>``."""
    obs.counter_inc(f"dist.host_staged.{op}")
    host = {}
    for t in reads:
        host[id(t)] = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=True).copy_(t)
    for t in writes:
        if id(t) not in host:
            host[id(t)] = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
    run([host[id(t)] for t in reads], [host[id(t)] for t in writes])
    for t in writes:
        t.copy_(host[id(t)], non_blocking=True)


def _done(result):
    """A completed ``Work`` holding ``result``."""
    fut = torch.futures.Future()
    fut.set_result(result)
    return _c10d._create_work_from_future(fut)


def _make_staged(store, rank, size, timeout):
    return HostStagedGloo(dist.ProcessGroupGloo(store, rank, size, timeout),
                          rank, size)


class HostStagedGloo(dist.ProcessGroup):
    """gloo, with the all-gathers into a tensor of CUDA tensors staged
    through pinned host memory by :func:`host_staged` (module
    docstring); every other collective, and every collective of CPU
    tensors, goes to gloo as it is.  Point-to-point transfers of CUDA
    tensors go through :func:`exchange`.  The method names are those
    through which ``torch.distributed`` (and DTensor's functional
    collectives) call a process group written in Python."""

    def __init__(self, inner, rank: int, size: int):
        super().__init__(rank, size)
        self._inner = inner

    def getBackendName(self) -> str:
        return STAGED_BACKEND

    # the C++ group reads its name from its backends, which a group
    # written in Python has none of
    def _set_group_name(self, name: str) -> None:
        self._name = name

    @property
    def group_name(self) -> str:
        return self._name

    def allreduce(self, tensors, opts):
        return self._inner.allreduce(tensors, opts)

    def allreduce_coalesced(self, tensors, opts):
        return self._inner.allreduce_coalesced(tensors, opts)

    def broadcast(self, tensors, opts):
        return self._inner.broadcast(tensors, opts)

    def reduce_scatter(self, outputs, input_lists, opts):
        return self._inner.reduce_scatter(outputs, input_lists, opts)

    def reduce_scatter_single(self, output, input, opts):
        return self._inner._reduce_scatter_base(output, input, opts)

    _reduce_scatter_base = reduce_scatter_single

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts).wait()
        return _done(outputs)

    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced

    def all_to_all_single(self, output, input, output_split_sizes,
                          input_split_sizes, opts):
        return self._inner.alltoall_base(output, input, output_split_sizes,
                                         input_split_sizes, opts)

    alltoall_base = all_to_all_single

    def barrier(self, opts=None):
        return self._inner.barrier(opts or _c10d.BarrierOptions())

    def allgather(self, output_lists, inputs, opts):
        return self._inner.allgather(output_lists, inputs, opts)

    def all_gather_single(self, output, input, opts):
        if not input.is_cuda:
            return self._inner._allgather_base(output, input, opts)
        host_staged("all_gather_into_tensor", [input], [output],
                    lambda i, o: self._inner._allgather_base(
                        o[0], i[0], opts).wait())
        return _done(output)

    _allgather_base = all_gather_single

    def all_gather_single_coalesced(self, outputs, inputs, opts):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts).wait()
        return _done(outputs)

    allgather_into_tensor_coalesced = all_gather_single_coalesced

    def send(self, tensors, dst, tag=0):
        if any(t.is_cuda for t in tensors):
            raise RuntimeError("HostStagedGloo.send: CUDA tensors go "
                               "through repro_torch.runtime.ranks.exchange")
        return self._inner.send(tensors, dst, tag)

    def recv(self, tensors, src, tag=0):
        if any(t.is_cuda for t in tensors):
            raise RuntimeError("HostStagedGloo.recv: CUDA tensors go "
                               "through repro_torch.runtime.ranks.exchange")
        return self._inner.recv(tensors, src, tag)


def exchange(x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """Send ``x`` to rank ``dst`` and return what rank ``src`` sends (of
    ``x``'s shape and dtype), in one ``batch_isend_irecv``.  In a gloo
    world a CUDA tensor travels through pinned host memory
    (:func:`host_staged`), both transfers posted before either is
    waited on."""
    x = x.contiguous()
    out = torch.empty_like(x)

    def run(ins, outs):
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, ins[0], dst),
                                         dist.P2POp(dist.irecv, outs[0],
                                                    src)]):
            w.wait()

    if x.is_cuda and dist.get_backend() == STAGED_BACKEND:
        host_staged("batch_isend_irecv", [x], [out], run)
    else:
        run([x], [out])
    return out


def _rank_main(fn, rank, world_size, store_path, device, args, results,
               timeout_s):
    torch.set_num_threads(1)
    try:
        init_ranks(device=device, store_path=store_path, rank=rank,
                   world_size=world_size, timeout_s=timeout_s)
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, *, store_dir: str, args: tuple = (),
                device=None, timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes of one intra-op thread each, each after :func:`init_ranks`
    over a file store in ``store_dir`` (on ``device``: None for the card,
    ``"cpu"`` for the host), and return the ranks' results in rank order
    (``fn`` must be importable and its result picklable).  Any rank's
    exception, or a rank that dies, fails the world: the other ranks are
    killed and ``RuntimeError`` carries the first failure's traceback;
    past ``timeout_s`` every rank is killed and ``TimeoutError`` raised.
    ``timeout_s`` also bounds each collective, so a rank left waiting on
    a dead peer fails too."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, store_path, device, args,
                               results, timeout_s), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn_ranks: {world_size - len(out)} of "
                        f"{world_size} ranks not done after {timeout_s} s")
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"spawn_ranks: rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"spawn_ranks: rank {rank} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    return [out[r] for r in range(world_size)]
