"""Worlds of ranks for the port's multi-rank tests, and the functions
their ranks run.

Every rank of a test's world imports this module (``spawn_ranks`` starts
fresh processes), so it imports neither JAX nor the JAX package: the
tests hold the ranks' results against JAX in their own process.  Each
world has its own file store and tune cache under the test's
``tmp_path``, so pytest-xdist workers never race for a port or a file,
and each rank runs one intra-op thread.
"""

import tempfile

import numpy as np
import torch

from repro_torch import tune
from repro_torch.runtime.ranks import spawn_ranks

ENGINE_KW = dict(num_slots=2, max_len=32, steps_per_dispatch=4)
# the requests of JAX's test_sharded_engine_8_device_parity
LENS, MAX_NEW = (5, 11, 3, 8), (6, 3, 5, 7)


def _main(rank, n, cache, fn, *args):
    tune.set_cache(tune.TuneCache(cache))
    return fn(rank, n, *args)


def world(fn, n: int, tmp_path, *args, device="cpu", timeout: float = 150.0):
    """``fn(rank, n, *args)`` on each rank of a new world of ``n`` ranks
    (results in rank order)."""
    store = tempfile.mkdtemp(dir=tmp_path)
    return spawn_ranks(_main, n, store_dir=store,
                       args=(f"{store}/tune.json", fn, *args),
                       device=device, timeout_s=timeout)


def requests(vocab: int):
    from repro_torch.serve import Request
    prompts = [np.random.default_rng(i).integers(0, vocab, n)
               for i, n in enumerate(LENS)]
    return [Request(rid=i, prompt=[int(t) for t in p], max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]


def train_batch(vocab: int, device="cpu") -> dict:
    rng = np.random.default_rng(3)
    t = rng.integers(0, vocab, (4, 16))
    return {"tokens": torch.from_numpy(t).to(device),
            "targets": torch.from_numpy(np.roll(t, -1, 1)).to(device)}


def local_tree(tree):
    """Each leaf's local shard (a plain leaf as it is)."""
    from repro_torch.runtime.sharding import is_dtensor
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to_local() if is_dtensor(x) else x, tree)


def sharded_leaves(tree) -> int:
    """The DTensor leaves of ``tree`` sharded on some mesh dim (a
    QTensor's codes and scales counted apart)."""
    from repro_torch.quant.tensor import QTensor
    from repro_torch.tree import leaves
    xs = [y for x in leaves(tree)
          for y in ((x.data, x.scale) if isinstance(x, QTensor) else (x,))]
    return sum(any(not p.is_replicate() for p in x.placements) for x in xs)


def coordinate(mesh) -> tuple:
    import torch.distributed as dist
    return tuple(int(c) for c in np.argwhere(mesh.ranks == dist.get_rank())[0])


# ----------------------------------------------------------------------
# rank functions
# ----------------------------------------------------------------------
def place_params(rank, n, archs):
    """For each (arch, npz of JAX's params) of ``archs``: the params
    placed on (2, 2), this rank's shards in JAX's layout and whether
    they gather back to the global params; the DP-only caches of JAX's
    test_cache_shardings_dp_only_mesh placed (the leaves each shards);
    a mesh of eight over four ranks refused."""
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.runtime.ranks import device_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shr
    mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    out = {"coord": coordinate(mesh), "arch": {}}
    for arch, npz in archs:
        cfg = get_config(arch, reduced=True)
        params = params_from_numpy(_unflat(dict(np.load(npz))), cfg,
                                   device="cpu")
        placed = shr.place(params, shr.param_shardings(mesh, params),
                           device_mesh(mesh))
        out["arch"][arch] = {
            "shards": _flat(params_to_numpy(local_tree(placed), cfg)),
            "global_equal": all(
                bool(torch.equal(a.full_tensor(), b)) for a, b in zip(
                    _leaves(placed), _leaves(params)))}
    sharded = {}
    for shape, axes in (((4,), ("data",)), ((2, 2), ("pod", "data"))):
        m = make_mesh_compat(shape, axes, device="cpu")
        for name in ("zamba2-2.7b", "seamless-m4t-large-v2"):
            c = get_config(name, reduced=True)
            kw = {"enc_len": 8} if c.family == "encdec" else {}
            cache = build_model(c).init_cache(8, 32, torch.float32,
                                              device="cpu", **kw)
            got = shr.place(cache, shr.cache_shardings(m, cache),
                            device_mesh(m))
            sharded[f"{shape}/{name}"] = sharded_leaves(got)
    out["cache_sharded"] = sharded
    try:
        make_mesh_compat((8,), ("data",), device="cpu")
        out["eight"] = None
    except ValueError as e:
        out["eight"] = str(e)
    return out


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def sharded_engine(rank, n, shape, npz, backend):
    """ShardedEngine over ``shape`` on JAX's reduced gemma-7b params: its
    tokens, the leaves it shards, the refusal of ``page_size`` across
    ranks, and the tokens the W8A8 and MoE engines serve there (which
    ``test_torch_multirank_quant_moe.py`` holds against one rank)."""
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import Ctx, build_model
    from repro_torch.serve import ShardedEngine
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    params = params_from_numpy(_unflat(dict(np.load(npz))), cfg,
                               device="cpu")
    mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
    ctx = Ctx(plan=backend, dtype=torch.float32)
    eng = ShardedEngine(model, params, ctx, mesh=mesh, **ENGINE_KW)
    res = eng.run(requests(cfg.vocab_size))
    out = {"tokens": {i: r.tokens for i, r in res.items()},
           "sharded": sharded_leaves(eng.params),
           "captures": eng.captures, "refused": [], "served": {}}
    moe = get_config("olmoe-1b-7b", reduced=True)
    for what, make in (
            ("page_size", lambda: ShardedEngine(
                model, params, ctx, mesh=mesh, max_len=32, page_size=4)),
            ("w8a8", lambda: ShardedEngine(
                model, model.quantize_weights(params), ctx, mesh=mesh,
                max_len=32)),
            ("moe", lambda: ShardedEngine(
                build_model(moe), build_model(moe).init(
                    seed=0, dtype=torch.float32, device="cpu"), ctx,
                mesh=mesh, max_len=32))):
        try:
            got = make().run(requests(cfg.vocab_size)[:1])
        except (ValueError, NotImplementedError) as e:
            out["refused"].append((what, type(e).__name__, str(e)))
        else:
            out["served"][what] = got[0].tokens
    return out


def prefill_across_ranks(rank, n, device):
    """ShardedEngine over (1, n) on reduced gemma-7b drawn from seed 0:
    its tokens and its captures (none across ranks: neither the decode
    block nor a prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import Ctx, build_model
    from repro_torch.serve import ShardedEngine
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    mesh = make_mesh_compat((1, n), ("data", "model"), device=device)
    eng = ShardedEngine(model, model.init(seed=0, device=device),
                        Ctx(plan="auto", dtype=torch.float32), mesh=mesh,
                        **ENGINE_KW)
    res = eng.run(requests(cfg.vocab_size))
    return {"tokens": {i: r.tokens for i, r in res.items()},
            "captures": eng.captures}


def failed_prefill_capture(rank, n):
    """An engine on the card whose prefill body reads a device value on
    the host: the first admission runs it eagerly, then its capture
    fails -> whether it raised a ``RuntimeError`` (torch's CUDA errors
    derive from it) and the graphs kept (none)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(seed=0, device="cuda"),
                      Ctx(plan="auto", dtype=torch.float32), device="cuda",
                      num_slots=2, max_len=32)
    real = eng._prefill_program

    def reads_the_host(key):
        logits, cache = real(key)
        logits.sum().item()
        return logits, cache

    eng._prefill_program = reads_the_host
    try:
        eng._admit(requests(cfg.vocab_size)[0], 0)
        raised = False
    except RuntimeError:
        raised = True
    return {"raised": raised, "graphs": len(eng._pf_graphs)}


def train_steps(rank, n, npz, arch, compression="none"):
    """Five fp32 train steps of the reduced ``arch`` from JAX's params in
    ``npz`` on (2, 2) (or one device with ``n`` None), gradients
    compressed by ``compression``: losses and the replications counted."""
    from repro_torch import obs
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.runtime.ranks import device_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.compression import init_residuals
    from repro_torch.runtime import sharding as shr
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = params_from_numpy(_unflat(dict(np.load(npz))), cfg,
                               device="cpu")
    batch = train_batch(cfg.vocab_size)
    mesh = None
    if n is not None:
        mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
        dm = device_mesh(mesh)
        params = shr.place(params, shr.param_shardings(mesh, params), dm)
        batch = shr.place(batch, shr.batch_shardings(mesh, batch), dm)
    opt = init_opt_state(params)
    residuals = (init_residuals(params) if compression != "none" else {})
    step = make_train_step(model, Ctx(plan="torch", dtype=torch.float32,
                                      mesh=mesh),
                           RunConfig(seq_len=16, global_batch=4, lr=1e-3,
                                     grad_compression=compression))
    obs.reset_counters("dryrun.")
    losses = []
    with shr.across_ranks(mesh is not None):
        for _ in range(5):
            params, opt, residuals, m = step(params, opt, residuals, batch)
            losses.append(float(shr.unplace(m["loss"])))
    return {"losses": losses,
            "replicated": obs.counters("dryrun.redistribute_for_op.")}


def compiled_train_across_ranks(rank, n):
    """``compile_train_step`` of reduced gemma-7b on the card over a (1,
    n) mesh, the state placed as DTensors: 3 steps' losses, the captures
    and the batch keys held (none of either across ranks)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.train import compile_train_step
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime import sharding as shr
    from repro_torch.runtime.ranks import device_mesh
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    mesh = make_mesh_compat((1, n), ("data", "model"), device="cuda")
    dm = device_mesh(mesh)
    params = model.init(seed=0, dtype=torch.float32, device="cuda")
    params = shr.place(params, shr.param_shardings(mesh, params), dm)
    batch = train_batch(cfg.vocab_size, "cuda")
    batch = shr.place(batch, shr.batch_shardings(mesh, batch), dm)
    step = compile_train_step(
        model, Ctx(plan="torch", dtype=torch.float32, mesh=mesh),
        RunConfig(seq_len=16, global_batch=4, lr=1e-3))
    state, losses = (params, init_opt_state(params), {}), []
    with shr.across_ranks():
        for _ in range(3):
            *state, m = step(*state, batch)
            losses.append(float(shr.unplace(m["loss"])))
    return {"losses": losses, "captures": step.captures,
            "batches": len(step.batches)}


def train_steps_compressed(rank, n, npz, schemes):
    """:func:`train_steps` of reduced gemma-7b on (2, 2) under each
    gradient compression of ``schemes``: the losses of each."""
    return {c: train_steps(rank, n, npz, "gemma-7b", c)["losses"]
            for c in schemes}


def train_loop_twice(rank, n, ckpt_dir, total):
    """``train_loop`` of reduced gemma-7b for ``total`` steps, then, its
    last checkpoint removed, again: it resumes from the one before.  Both
    runs' losses."""
    import shutil
    import torch.distributed as dist
    from repro_torch.launch.train import train_loop
    first = train_loop("gemma-7b", loop_run(ckpt_dir, total),
                       log_every=1000, device="cpu")["losses"]
    if rank == 0:
        shutil.rmtree(f"{ckpt_dir}/step_{total - 1:010d}")
    dist.barrier()
    resumed = train_loop("gemma-7b", loop_run(ckpt_dir, total),
                         log_every=1000, device="cpu")["losses"]
    return first, resumed


def loop_run(ckpt_dir, steps):
    from repro_torch.configs import RunConfig
    return RunConfig(seq_len=16, global_batch=4, lr=3e-3, warmup_steps=2,
                     total_steps=steps, ckpt_dir=str(ckpt_dir),
                     ckpt_every=3, dtype="float32")


def pp_grads(rank, n, npz):
    """``pp_loss_fn`` of JAX's reduced gemma-7b params on (2, 2) ('pod',
    'data'), B 4, S 16, two microbatches (``n`` None: ``model.loss`` on
    one device): the loss and every gradient (None for another stage's
    layers), in JAX's layout by leaf path."""
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import Ctx, build_model
    from repro_torch.runtime import pp_loss_fn
    from repro_torch.tree import flatten, unflatten
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    flat = dict(np.load(npz))
    batch = {"tokens": torch.from_numpy(flat.pop("batch/tokens")),
             "targets": torch.from_numpy(flat.pop("batch/targets"))}
    params = params_from_numpy(_unflat(flat), cfg, device="cpu")
    ps, treedef = flatten(params)
    xs = [p.detach().requires_grad_() for p in ps]
    ctx = Ctx(plan="torch", dtype=torch.float32)
    tree = unflatten(treedef, xs)
    if n is None:
        loss = model.loss(tree, batch, ctx)
    else:
        mesh = make_mesh_compat((2, 2), ("pod", "data"), device="cpu")
        loss = pp_loss_fn(tree, batch, cfg, ctx, mesh, n_microbatches=2)
    loss.backward()
    return float(loss.detach()), [None if x.grad is None else x.grad.numpy()
                         for x in xs]


def elastic_save(rank, n, one_rank_dir, save_dir):
    """A four-rank world: the one-rank checkpoint in ``one_rank_dir``
    restored onto (2, 2) (its step and leaves), then reduced gemma-7b
    params placed on (2, 2) saved at step 10 in ``save_dir``."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.runtime.ranks import device_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import elastic_restore
    from repro_torch.runtime import sharding as shr
    params = build_model(get_config("gemma-7b", reduced=True)).init(
        seed=0, dtype=torch.float32, device="cpu")
    mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    state, step = elastic_restore(Checkpointer(one_rank_dir, keep=1),
                                  {"params": params}, mesh)
    got = {"step": step, "equal": all(
        bool(torch.equal(a.full_tensor(), b))
        for a, b in zip(_leaves(state["params"]), _leaves(params)))}
    Checkpointer(save_dir, keep=1).save(
        10, {"params": shr.place(params, shr.param_shardings(mesh, params),
                                 device_mesh(mesh))}, blocking=True)
    return got


def elastic_restore_small(rank, n, save_dir):
    """A two-rank world: the (2, 2) save restored onto (1, 2): step,
    equality and each leaf's local shape."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build_model
    from repro_torch.runtime import elastic_restore
    params = build_model(get_config("gemma-7b", reduced=True)).init(
        seed=0, dtype=torch.float32, device="cpu")
    mesh = make_mesh_compat((1, 2), ("data", "model"), device="cpu")
    state, step = elastic_restore(Checkpointer(save_dir, keep=1),
                                  {"params": params}, mesh)
    from repro_torch.interop import params_to_numpy
    local = params_to_numpy(local_tree(state["params"]),
                            get_config("gemma-7b", reduced=True))
    return {"step": step,
            "equal": all(bool(torch.equal(a.full_tensor(), b)) for a, b in
                         zip(_leaves(state["params"]), _leaves(params))),
            "coord": coordinate(mesh),
            "local_shapes": {k: v.shape for k, v in _flat(local).items()}}


def ops_on_shards(rank, n, device):
    """Kernel 1 on column-, row- and batch-sharded operands and kernel 2
    through ``map_heads``, each against its plain version on the same
    global operands: the largest errors, the plain scale and the launches
    made (none on the CPU)."""
    from repro_torch.kernels import launches, ops
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.runtime.ranks import device_mesh
    from repro_torch.models import layers as L
    from repro_torch.plan import as_plan
    from repro_torch.runtime.sharding import (P, NamedSharding,
                                              from_replicated, place)
    dt = torch.bfloat16 if device != "cpu" else torch.float32
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 256, generator=g).to(device, dt)
    b = torch.randn(256, 384, generator=g).to(device, dt)
    want = matmul_ref(a, b, dt).float()
    out, before = {}, launches.snapshot()
    cols = make_mesh_compat((1, n), ("data", "model"), device=device)
    rows = make_mesh_compat((n, 1), ("data", "model"), device=device)

    def placed(x, mesh, *spec):
        sh = NamedSharding(mesh, P(*spec))
        return place({"x": x}, {"x": sh}, device_mesh(mesh))["x"]

    cases = {"column": (cols, (), (None, "model")),
             "row": (cols, (None, "model"), ("model", None)),
             "batch": (rows, ("data", None), ())}
    for name, (mesh, sa, sb) in cases.items():
        y = ops.matmul(placed(a, mesh, *sa), placed(b, mesh, *sb),
                       config="auto", out_dtype=dt)
        out[name] = (float((y.full_tensor().float() - want).abs().max()),
                     [str(p) for p in y.placements])
    q = torch.randn(2, 32, 4, 64, generator=g).to(device, dt)
    k = torch.randn(2, 32, 4, 64, generator=g).to(device, dt)
    v = torch.randn(2, 32, 4, 64, generator=g).to(device, dt)
    want_o = L._gqa_full(q, k, v, causal=True, config=as_plan("torch"))
    dm = device_mesh(cols)
    o = L._gqa_full(*(from_replicated(x, dm) for x in (q, k, v)),
                    causal=True, config=as_plan("auto"))
    out["attention"] = (float((o.full_tensor().float()
                               - want_o.float()).abs().max()),
                        [str(p) for p in o.placements])
    out["scale"] = float(want.abs().max())
    out["launches"] = launches.since(before)
    return out


def int8_and_grouped_ops_on_shards(rank, n, device):
    """Kernels 4, 5 and 6 on DTensor operands, each against its plain
    version on the same global operands: the int8 product column-, row-
    and batch-sharded, the grouped product sharded by group, by
    contraction and by group against a replicated bank, the int8 grouped
    product by group and by contraction.  The row-parallel (contraction)
    cases give each rank's slice of every row a different absmax, so a
    scale taken over a rank's slice alone would show.  The largest
    errors and placements, the plain scales and the launches made (none
    on the CPU)."""
    from repro_torch.kernels import launches, ops
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.quant import quantize, quantize_rows
    from repro_torch.quant.tensor import QTensor
    from repro_torch.runtime.ranks import device_mesh
    from repro_torch.runtime.sharding import P, NamedSharding, place
    dt = torch.bfloat16 if device != "cpu" else torch.float32
    g = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    # every row's slices of K differ in magnitude: a per-slice absmax
    # differs from the row's
    ramp = torch.linspace(0.25, 4.0, 256)
    x = (randn(64, 256) * ramp).to(device, dt)
    xg = (randn(4, 16, 256) * ramp).to(device, dt)
    w, wg = quantize(randn(256, 384)), quantize(randn(4, 256, 96))
    w = QTensor(w.data.to(device), w.scale.to(device), w.fmt, w.w8a8)
    wg = QTensor(wg.data.to(device), wg.scale.to(device), wg.fmt, wg.w8a8)
    bg = randn(4, 256, 96).to(device, dt)

    def plain_int8(a, qw, rf):
        a_q, a_s = quantize_rows(a)
        return rf(a_q, qw.data, a_s, qw.scale, torch.float32)

    want = {"int8": plain_int8(x, w, ref.quantized_matmul_ref),
            "grouped": ref.grouped_matmul_ref(xg, bg, torch.float32),
            "int8_grouped": plain_int8(xg, wg,
                                       ref.quantized_grouped_matmul_ref)}
    cols = make_mesh_compat((1, n), ("data", "model"), device=device)
    rows = make_mesh_compat((n, 1), ("data", "model"), device=device)

    def placed(t, mesh, spec, scale_spec=None):
        dm = device_mesh(mesh)
        if isinstance(t, QTensor):
            sh = QTensor(NamedSharding(mesh, P(*spec)),
                         NamedSharding(mesh, P(*scale_spec)), t.fmt, t.w8a8)
        else:
            sh = NamedSharding(mesh, P(*spec))
        return place({"t": t}, {"t": sh}, dm)["t"]

    R3 = (None, None, None)
    cases = {
        "int8_column": ("int8", cols, x, (), w, (None, "model"),
                        (None, "model")),
        "int8_row": ("int8", cols, x, (None, "model"), w, (), ()),
        "int8_batch": ("int8", rows, x, ("data", None), w, (), ()),
        "grouped_groups": ("grouped", cols, xg, ("model",), bg,
                           ("model",), None),
        "grouped_contraction": ("grouped", cols, xg, (None, None, "model"),
                                bg, (None, "model", None), None),
        "grouped_bank_replicated": ("grouped", cols, xg, ("model",), bg, R3,
                                    None),
        "int8_grouped_groups": ("int8_grouped", cols, xg, ("model",), wg, R3,
                                R3),
        "int8_grouped_row": ("int8_grouped", cols, xg, (None, None, "model"),
                             wg, R3, R3),
    }
    out, before = {}, launches.snapshot()
    for name, (kind, mesh, a, sa, b, sb, ss) in cases.items():
        ad, bd = placed(a, mesh, sa), placed(b, mesh, sb, ss)
        fn = {"int8": ops.quantized_matmul, "grouped": ops.grouped_matmul,
              "int8_grouped": ops.quantized_grouped_matmul}[kind]
        y = fn(ad, bd, config="auto", out_dtype=dt)
        out[name] = (float((y.full_tensor().float() - want[kind]).abs().max()),
                     [str(p) for p in y.placements])
    out["scale"] = {k: float(v.abs().max()) for k, v in want.items()}
    out["launches"] = launches.since(before)
    return out


S_ENC = 12      # an encdec request's source frames (enc_len)


def family_requests(cfg):
    """:func:`requests` with the family's frontend: a vlm request's
    ``frontend_tokens`` prefix positions, an encdec request's ``S_ENC``
    source frames (random, 0.1 scale, from seed 4)."""
    import dataclasses
    reqs = requests(cfg.vocab_size)
    n = {"vlm": getattr(cfg, "frontend_tokens", 0),
         "encdec": S_ENC}.get(cfg.family)
    if not n:
        return reqs
    fe = (np.random.default_rng(4).standard_normal(
        (len(reqs), n, cfg.d_model)) * 0.1).astype(np.float32)
    return [dataclasses.replace(r, frontend_embeds=f)
            for r, f in zip(reqs, fe)]


def family_engine_kw(cfg) -> dict:
    kw = dict(ENGINE_KW)
    if cfg.family == "encdec":
        kw["cache_kwargs"] = {"enc_len": S_ENC}
    return kw


def family_engine(rank, n, arch, npz, quant, shapes):
    """``ShardedEngine`` of the reduced ``arch`` on JAX's params in
    ``npz`` (W8A8 with ``quant``; the kernel path, whose wrappers run
    their plain versions on the CPU) over each mesh of ``shapes`` in
    turn: its tokens, the param and cache leaves it shards, its captures
    and the operations replicated for want of a DTensor plan."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import Ctx, build_model
    from repro_torch.plan import KernelConfig
    from repro_torch.serve import ShardedEngine
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = params_from_numpy(_unflat(dict(np.load(npz))), cfg,
                               device="cpu")
    if quant:
        params = model.quantize_weights(params)
    ctx = Ctx(plan=KernelConfig(quant="int8") if quant else "auto",
              dtype=torch.float32)
    out = {}
    for shape in shapes:
        mesh = make_mesh_compat(tuple(shape), ("data", "model"),
                                device="cpu")
        obs.reset_counters("dryrun.")
        eng = ShardedEngine(model, params, ctx, mesh=mesh,
                            **family_engine_kw(cfg))
        res = eng.run(family_requests(cfg))
        out[tuple(shape)] = {
            "tokens": {i: r.tokens for i, r in res.items()},
            "sharded": sharded_leaves(eng.params),
            "cache_sharded": sharded_leaves(
                {k: v for k, v in eng.cache.items() if k != "pos"}),
            "captures": eng.captures,
            "replicated": obs.counters("dryrun.redistribute_for_op.")}
    return out


def save_one_leaf_at_a_time(rank, n, save_dir):
    """Reduced gemma-7b params (seed 0) placed on (2, 2) and saved at step
    10 in ``save_dir``, every ``DTensor.full_tensor`` result counted
    while it is alive: how many gathers ran and the most alive at once."""
    import weakref
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shr
    from repro_torch.runtime.ranks import device_mesh
    params = build_model(get_config("gemma-7b", reduced=True)).init(
        seed=0, dtype=torch.float32, device="cpu")
    mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    placed = shr.place(params, shr.param_shardings(mesh, params),
                       device_mesh(mesh))
    count = {"alive": 0, "peak": 0, "gathers": 0}
    gather = DTensor.full_tensor

    def dead():
        count["alive"] -= 1

    def counted(self, *args, **kwargs):
        t = gather(self, *args, **kwargs)
        count["gathers"] += 1
        count["alive"] += 1
        count["peak"] = max(count["peak"], count["alive"])
        weakref.finalize(t, dead)
        return t

    DTensor.full_tensor = counted
    try:
        Checkpointer(save_dir, keep=1).save(10, {"params": placed},
                                            blocking=True)
    finally:
        DTensor.full_tensor = gather
    return count
