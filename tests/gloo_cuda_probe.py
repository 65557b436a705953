"""Which collectives gloo runs on CUDA tensors: two ranks on one card,
each collective in a world of its own (a refusal may kill the process
instead of raising), each result checked, first over plain gloo, then
over the port's :class:`repro_torch.runtime.ranks.HostStagedGloo`.  Run
on a machine with a card:

    PYTHONPATH=src python tests/gloo_cuda_probe.py

It prints one line a backend and collective: ``ok``, ``WRONG``, the
error's first line, or the ranks' exit codes when they died.  The
all-gather is reached five ways (``dist.all_gather_into_tensor`` waited
at once and asynchronously, ``dist.all_gather``'s list form, the
functional op DTensor calls, and DTensor's own redistribution of a dim-0
and a dim-1 shard) so that the way that fails is named; the functional
all-reduce stands beside them.  On the H100 with torch 2.11 over plain
gloo the functional all-gather and both DTensor all-gathers killed the
ranks (SIGSEGV), send and receive failed ("Bad address"), and every
other case passed; over ``HostStagedGloo`` every case passed.  So
``HostStagedGloo`` stages through pinned host memory itself only the
all-gathers into a tensor of CUDA tensors, and, through
``runtime.ranks.exchange``, point-to-point transfers.
"""

import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _cases(rank: int, n: int, dev, staged: bool):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def gathered(o):
        return bool((o.cpu() == torch.arange(n).repeat_interleave(2)).all())

    def all_reduce():
        t = torch.full((4,), rank + 1.0, device=dev)
        dist.all_reduce(t)
        return bool((t == n * (n + 1) / 2).all())

    def all_gather_into_tensor():
        o = torch.empty(2 * n, device=dev)
        dist.all_gather_into_tensor(o, torch.full((2,), float(rank),
                                                  device=dev))
        return gathered(o)

    def all_gather_into_tensor_async():
        o = torch.empty(2 * n, device=dev)
        dist.all_gather_into_tensor(o, torch.full((2,), float(rank),
                                                  device=dev),
                                    async_op=True).wait()
        return gathered(o)

    def all_gather_list():
        o = [torch.empty(2, device=dev) for _ in range(n)]
        dist.all_gather(o, torch.full((2,), float(rank), device=dev))
        return gathered(torch.cat(o))

    def functional_all_gather():
        f = torch.ops._c10d_functional
        o = f.all_gather_into_tensor(torch.full((2,), float(rank),
                                                device=dev),
                                     n, dist.group.WORLD.group_name)
        return gathered(f.wait_tensor(o))

    def functional_all_reduce():
        f = torch.ops._c10d_functional
        o = f.all_reduce(torch.full((4,), rank + 1.0, device=dev), "sum",
                         dist.group.WORLD.group_name)
        return bool((f.wait_tensor(o) == n * (n + 1) / 2).all())

    def reduce_scatter_tensor():
        o = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(o, torch.arange(2 * n, device=dev,
                                                   dtype=torch.float32))
        return bool((o.cpu() == n * torch.arange(2 * rank, 2 * rank + 2)
                     ).all())

    def all_to_all_single():
        o = torch.empty(n, device=dev)
        dist.all_to_all_single(o, torch.arange(n, device=dev,
                                               dtype=torch.float32)
                               + 10 * rank)
        return bool((o.cpu() == torch.arange(n) * 10 + rank).all())

    def send_recv():
        s = torch.full((4,), float(rank), device=dev)
        if staged:
            from repro_torch.runtime.ranks import exchange
            r = exchange(s, (rank + 1) % n, (rank - 1) % n)
        else:
            r = torch.empty(4, device=dev)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, s, (rank + 1) % n),
                    dist.P2POp(dist.irecv, r, (rank - 1) % n)]):
                w.wait()
        return bool((r == (rank - 1) % n).all())

    g = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)

    def mesh():
        return init_device_mesh(dev.type, (n,), mesh_dim_names=("model",))

    def dtensor_all_gather():
        d = DTensor.from_local(g.chunk(n)[rank].to(dev), mesh(), [Shard(0)])
        return bool((d.full_tensor().cpu() == g).all())

    def dtensor_all_gather_dim1():
        d = DTensor.from_local(g.chunk(n, 1)[rank].contiguous().to(dev),
                               mesh(), [Shard(1)])
        return bool((d.full_tensor().cpu() == g).all())

    def dtensor_reduce_scatter():
        d = DTensor.from_local(g.to(dev), mesh(), [Partial()])
        return bool((d.redistribute(d.device_mesh, [Shard(0)]).to_local()
                     .cpu() == n * g.chunk(n)[rank]).all())

    def dtensor_all_reduce():
        d = DTensor.from_local(g.to(dev), mesh(), [Partial()])
        return bool((d.redistribute(d.device_mesh, [Replicate()]).to_local()
                     .cpu() == n * g).all())

    return {f.__name__: f for f in (
        all_reduce, all_gather_into_tensor, all_gather_into_tensor_async,
        all_gather_list, functional_all_gather, functional_all_reduce,
        reduce_scatter_tensor, all_to_all_single, send_recv,
        dtensor_all_gather, dtensor_all_gather_dim1, dtensor_reduce_scatter,
        dtensor_all_reduce)}


def _rank(rank, n, store, name, staged, results):
    if staged:
        from repro_torch.runtime.ranks import init_ranks
        init_ranks(store_path=store, rank=rank, world_size=n)
    else:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n)
        torch.cuda.set_device(0)
    try:
        ok = _cases(rank, n, torch.device("cuda", 0), staged)[name]()
        torch.cuda.synchronize()
        results.put((rank, "ok" if ok else "WRONG"))
    except Exception as e:
        results.put((rank, f"ERR {str(e).splitlines()[0][:160]}"))
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    ctx = mp.get_context("spawn")
    for staged in (False, True):
        backend = "staged" if staged else "gloo"
        for name in _cases(0, 2, torch.device("cpu"), staged):
            results = ctx.Queue()
            store = os.path.join(tempfile.mkdtemp(), "store")
            procs = [ctx.Process(target=_rank,
                                 args=(r, 2, store, name, staged, results))
                     for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()
            got = {}
            while not results.empty():
                r, what = results.get()
                got[r] = what
            died = [p.exitcode for p in procs if p.exitcode]
            print(f"{backend} {name}: {got.get(0)} / {got.get(1)}"
                  + (f" (exit codes {died})" if died else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
