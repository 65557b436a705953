"""The port's dry run (``repro_torch.launch.dryrun``) and its parts
against the JAX package's.

* ``configs.input_specs`` gives JAX's shapes for every registered config
  and every ``SHAPES`` entry, and JAX's dtypes under the port's map
  (int32 token ids -> int64, the port's embedding index dtype).
* ``core.trace_costs`` counts exactly the FLOPs JAX's ``analyze_hlo``
  counts on the three programs of ``tests/test_hlo_costs.py`` (scan,
  nested scan, unrolled), computed from JAX here, not from constants;
  it weights collectives as JAX's ``parse_collective_bytes`` does
  (all-reduce 2x input, all-gather the gathered output, reduce-scatter
  the input) on a fake (2, 4) world; and it counts one rank's local
  products only (a sharded product and its weight gradient give the
  global count over 8, not the DTensor-level count on top of it).
* The per-device argument bytes (fp32 params, bf16 moments, step,
  batch) of reduced gemma-7b and olmoe-1b-7b train cells on (2, 4) equal
  the sum of JAX's ``NamedSharding.shard_shape`` x itemsize (8 host
  devices in a subprocess, nothing compiled).
* JAX's ``run_cell`` and the port's on six reduced cells on (2, 4)
  (gemma-7b prefill, decode and train, mamba2-130m decode and train,
  olmoe-1b-7b prefill): the port's FLOPs equal JAX's where GSPMD's plan
  repeats no product, and lie below JAX's by at most what its plan
  repeats (stated per cell); the port's collectives gather and reduce
  where JAX's do.
* ``ReplicateOnGap`` replicates a view DTensor cannot plan, counted,
  and lets a view of a wrong shape fail with nothing replicated.
* A reduced gemma-7b train cell on a fake (2, 4) world records
  collectives, an all-reduce or reduce-scatter among them, and the
  mamba2-130m ``decode_32k`` multi-pod cell of JAX's own CLI smoke
  prints ``[OK]``.
* With ``mesh=None`` reduced gemma-7b's prefill logits, one decode step
  and the loss are bit-equal to the parent tree's
  (``tests/data/torch_gemma_mesh_none.npz``, written by it), and so are
  the embedding's gradient and every leaf's squared gradient norm of
  the loss (``tests/data/torch_gemma_mesh_none_grads.npz``).
* The dry run's modules import neither ``jax`` nor ``repro``.
Every subprocess has its own timeout.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.configs import list_configs
from repro.core.hlo_costs import analyze_hlo
from repro.core.roofline import parse_collective_bytes
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.core.trace_costs import trace_costs
from repro_torch.models import Ctx, build_model
from repro_torch.tree import flatten, unflatten
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
# JAX's dtype -> the port's
_DTYPES = {jnp.dtype(jnp.int32): torch.int64,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _run(code: str, tmp_path, *, jax_devices: int = 0,
         timeout: int = 240) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "tune.json"))
    if jax_devices:
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={jax_devices}"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


# ----------------------------------------------------------------------
# input_specs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_match_jax(arch, shape):
    want = j_input_specs(j_get_config(arch), J_SHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert list(got) == list(want)
    for k, sds in want.items():
        assert tuple(got[k].shape) == tuple(sds.shape), k
        assert got[k].dtype == _DTYPES[jnp.dtype(sds.dtype)], k
        assert got[k].is_meta


# ----------------------------------------------------------------------
# trace_costs: FLOPs on the programs of test_hlo_costs.py
# ----------------------------------------------------------------------
def _jax_scan(x):
    def body(c, w):
        return c @ w + 1.0, jnp.sum(c)
    c, s = jax.lax.scan(body, x, jnp.ones((7, 16, 16)))
    return c.sum() + s.sum()


def _torch_scan(x):
    sums = []
    for w in torch.ones((7, 16, 16)):
        sums.append(x.sum())
        x = x @ w + 1.0
    return x.sum() + torch.stack(sums).sum()


def _jax_nested(x):
    def outer(c, _):
        def inner(ci, _):
            return ci @ ci, None
        ci, _ = jax.lax.scan(inner, c, None, length=3)
        return ci, None
    c, _ = jax.lax.scan(outer, x, None, length=5)
    return c.sum()


def _torch_nested(x):
    for _ in range(5):
        for _ in range(3):
            x = x @ x
    return x.sum()


def _jax_unrolled(x):
    w = jnp.ones((4, 12, 12))
    for i in range(4):
        x = x @ w[i]
    return x.sum()


def _torch_unrolled(x):
    w = torch.ones((4, 12, 12))
    for i in range(4):
        x = x @ w[i]
    return x.sum()


@pytest.mark.parametrize("jf,tf,n", [(_jax_scan, _torch_scan, 16),
                                     (_jax_nested, _torch_nested, 8),
                                     (_jax_unrolled, _torch_unrolled, 12)],
                         ids=["scan", "nested_scan", "unrolled"])
def test_trace_flops_equal_jax_hlo_flops(jf, tf, n):
    hlo = jax.jit(jf).lower(
        jax.ShapeDtypeStruct((n, n), jnp.float32)).compile().as_text()
    want = analyze_hlo(hlo).flops
    for device in ("cpu", "meta"):
        _, costs = trace_costs(tf, torch.ones((n, n), device=device))
        assert costs.flops == want
        assert sum(costs.dot_flops_by_shape.values()) == want


_COLLECTIVES = """
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.core.trace_costs import trace_costs
from repro_torch.launch.mesh import fake_device_mesh, make_mesh_compat
dm = fake_device_mesh(make_mesh_compat((2, 4), ("data", "model"),
                                       device="meta"))
try:
    def collectives():
        x = torch.empty((128, 256), dtype=torch.float32, device="meta")
        y = torch.empty((256, 64), dtype=torch.bfloat16, device="meta")
        z = torch.empty((256,), dtype=torch.float32, device="meta")
        return (funcol.all_reduce(x, "sum", (dm, 0)),
                funcol.all_gather_tensor(y, 0, (dm, 0)),
                funcol.reduce_scatter_tensor(z, "sum", 0, (dm, 1)))
    outs, c = trace_costs(collectives)
    assert [tuple(o.shape) for o in outs] == [(128, 256), (512, 64), (64,)]
    print("COLL", json.dumps([c.collective_by_kind, c.collective_count]))

    # a batch-sharded (16, 256) @ a column-sharded (256, 1024) weight,
    # forward and weight gradient (the output gradient in the output's
    # layout)
    def product(x, w, g):
        with torch.enable_grad():
            (x @ w).backward(g)
        return w.grad
    x = DTensor.from_local(torch.empty((8, 256), device="meta"), dm,
                           [Shard(0), Replicate()])
    w = DTensor.from_local(torch.empty((256, 256), device="meta"), dm,
                           [Replicate(), Shard(1)]).detach()
    w.requires_grad_()
    g = DTensor.from_local(torch.empty((8, 256), device="meta"), dm,
                           [Shard(0), Shard(1)])
    _, c = trace_costs(product, x, w, g)
    print("FLOPS", json.dumps(c.flops))
finally:
    dist.destroy_process_group()
"""


def test_collective_weights_and_local_only_flops(tmp_path):
    out = _run(_COLLECTIVES, tmp_path)
    by_kind, count = json.loads(out.split("COLL", 1)[1].splitlines()[0])
    # JAX's traffic model on the HLO of test_collective_text_parser
    want = parse_collective_bytes("""
  %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x), replica_groups={}
  %ag.1 = bf16[512,64]{1,0} all-gather(bf16[256,64]{1,0} %y), dimensions={0}
  %rs = f32[64]{0} reduce-scatter(f32[256]{0} %z), dimensions={0}
""")
    assert by_kind == want.bytes_by_kind
    assert count == want.count_by_kind
    flops = json.loads(out.split("FLOPS", 1)[1].splitlines()[0])
    # forward 2*16*256*1024 plus weight gradient 2*256*16*1024, over the
    # 8 ranks: one rank's local products times the rank count
    assert flops * 8 == 2 * (2 * 16 * 256 * 1024) == 16_777_216
    assert flops * 8 != 22_020_096     # FlopCounterMode's double count


# ----------------------------------------------------------------------
# per-device argument bytes against JAX's shard shapes
# ----------------------------------------------------------------------
_JAX_ARG_BYTES = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.optim import init_opt_state
from repro.runtime import sharding as shr
mesh = make_mesh_compat((2, 4), ("data", "model"))
int_bytes = 8          # the port's int64 token ids
out = {}
for arch in ("gemma-7b", "olmoe-1b-7b"):
    model = build_model(get_config(arch, reduced=True))
    params = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    opt = jax.eval_shape(lambda p: init_opt_state(
        p, moments_dtype=jnp.bfloat16), params)
    batch = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
             "targets": jax.ShapeDtypeStruct((8, 16), jnp.int32)}

    def total(tree, shardings, itemsize=None):
        leaves = jax.tree.leaves(tree)
        shs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
        assert len(leaves) == len(shs)
        return sum(int(np.prod(sh.shard_shape(x.shape)))
                   * (itemsize or x.dtype.itemsize)
                   for x, sh in zip(leaves, shs))
    out[arch] = {
        "params": total(params, shr.param_shardings(mesh, params)),
        "moments": total(opt.mu, shr.param_shardings(mesh, opt.mu))
        + total(opt.nu, shr.param_shardings(mesh, opt.nu)),
        "step": opt.step.dtype.itemsize,
        "batch": total(batch, shr.batch_shardings(mesh, batch), int_bytes)}
print("BYTES", json.dumps(out))
"""

_PORT_ARG_BYTES = """
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import ShapeSpec
from repro_torch.core.trace_costs import argument_bytes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_device_mesh, make_mesh_compat
mesh = make_mesh_compat((2, 4), ("data", "model"), device="meta")
out = {}
for arch in ("gemma-7b", "olmoe-1b-7b"):
    dm = fake_device_mesh(mesh)
    try:
        with implicit_replication():
            _, (params, opt, batch), donate, _ = dryrun.build_cell(
                arch, ShapeSpec("t", 16, 8, "train"), mesh, dm,
                reduced=True)
        out[arch] = {"params": argument_bytes(params),
                     "moments": argument_bytes((opt.mu, opt.nu)),
                     "step": argument_bytes(opt.step),
                     "batch": argument_bytes(batch)}
        assert donate == (0, 1)
    finally:
        dist.destroy_process_group()
print("BYTES", json.dumps(out))
"""


def test_argument_bytes_equal_jax_shard_shapes(tmp_path):
    want = json.loads(_run(_JAX_ARG_BYTES, tmp_path, jax_devices=8)
                      .split("BYTES", 1)[1])
    got = json.loads(_run(_PORT_ARG_BYTES, tmp_path).split("BYTES", 1)[1])
    assert got == want
    for arch in got:
        assert got[arch]["params"] > 0 and got[arch]["batch"] > 0


# ----------------------------------------------------------------------
# cells
# ----------------------------------------------------------------------
_TRAIN_CELL = """
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import ShapeSpec
from repro_torch.core.roofline import analyze_trace
from repro_torch.core.trace_costs import trace_costs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_device_mesh, make_mesh_compat
mesh = make_mesh_compat((2, 4), ("data", "model"), device="meta")
dm = fake_device_mesh(mesh)
try:
    with implicit_replication(), torch.no_grad():
        fn, args, donate, useful = dryrun.build_cell(
            "gemma-7b", ShapeSpec("t", 32, 4, "train"), mesh, dm,
            reduced=True)
        _, costs = trace_costs(fn, *args, donate=donate,
                               inner=dryrun.ReplicateOnGap())
finally:
    dist.destroy_process_group()
rep = analyze_trace("t", costs, 8, model_flops_useful=useful)
print("CELL", json.dumps({"flops": rep.hlo_flops,
                          "coll": rep.collective_bytes,
                          "count": rep.collectives.count_by_kind,
                          "memory": costs.memory}))
"""


def test_reduced_gemma_train_cell_records_collectives(tmp_path):
    out = json.loads(_run(_TRAIN_CELL, tmp_path).split("CELL", 1)[1])
    assert out["flops"] > 0
    assert out["coll"] > 0, "expected TP/DP collectives"
    assert "all-reduce" in out["count"] or "reduce-scatter" in out["count"]
    mem = out["memory"]
    assert mem["argument"] > 0 and mem["temp"] > 0
    # params and moments updated in place: every output byte but the
    # metrics' is donated
    assert 0 < mem["alias"] <= mem["output"]


# ----------------------------------------------------------------------
# cells against JAX's run_cell
# ----------------------------------------------------------------------
# reduced cells on a (2, 4) mesh: (arch, seq, batch, kind); the batches
# divide the reference's microbatch counts (olmoe prefill: 16)
_CELLS = {"gemma-7b/prefill": ("gemma-7b", 32, 4, "prefill"),
          "gemma-7b/decode": ("gemma-7b", 32, 4, "decode"),
          "mamba2-130m/decode": ("mamba2-130m", 64, 4, "decode"),
          "olmoe-1b-7b/prefill": ("olmoe-1b-7b", 16, 32, "prefill"),
          "gemma-7b/train": ("gemma-7b", 32, 4, "train"),
          "mamba2-130m/train": ("mamba2-130m", 64, 4, "train")}

_RUN_CELLS = """
import json, sys
cells = json.loads(sys.argv[1])
if sys.argv[2] == "jax":
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun as d
    from repro.launch.mesh import make_mesh_compat
    d.get_config = lambda a: get_config(a, reduced=True)
    d.make_production_mesh = lambda multi_pod: make_mesh_compat(
        (2, 4), ("data", "model"))
else:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as d
    from repro_torch.launch.mesh import make_mesh_compat
    d.get_config = lambda a, reduced=False: get_config(a, reduced=True)
    d.make_production_mesh = lambda multi_pod, device=None: \
        make_mesh_compat((2, 4), ("data", "model"), device="meta")
d.SKIP = {}
out = {}
for key, (arch, seq, batch, kind) in cells.items():
    d.SHAPES = {"x": ShapeSpec("x", seq, batch, kind)}
    row = d.run_cell(arch, "x", multi_pod=False)
    assert row["status"] == "ok", row
    out[key] = {"flops": row["hlo_gflops"] * 1e9,
                "collectives": row["collectives"]}
print("CELLS", json.dumps(out))
"""


@pytest.fixture(scope="module")
def cell_rows(tmp_path_factory):
    """Each cell of ``_CELLS`` through JAX's ``run_cell`` (8 host devices,
    compiled) and the port's (a fake 8-rank world), both with the
    production mesh swapped for (2, 4) and the full configs for the
    reduced ones; the two subprocesses run at once."""
    tmp = tmp_path_factory.mktemp("cells")
    procs = {}
    for side in ("jax", "torch"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   REPRO_TORCH_TUNE_CACHE=str(tmp / "tune.json"))
        if side == "jax":
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        procs[side] = subprocess.Popen(
            [sys.executable, "-c", _RUN_CELLS, json.dumps(_CELLS), side],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    rows = {}
    for side, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
        assert proc.returncode == 0, err[-4000:]
        rows[side] = json.loads(out.split("CELLS", 1)[1])
    return rows


# the port's FLOPs over JAX's, as a closed range: 1 where GSPMD's plan
# repeats no product; below 1 by what its plan repeats and the port's
# does not (by shape, from the two programs' products):
#  * olmoe prefill: the attention output product, whole on each rank of
#    'data' (8,388,608 of JAX's 111,149,056);
#  * gemma train: one more forward of every product (33,554,432 of
#    151,060,480; the same with REPRO_REMAT=none);
#  * mamba2 train: a second one-hot product of the loss (131,072).
_FLOP_RATIO = {"gemma-7b/prefill": (1.0, 1.0),
               "gemma-7b/decode": (1.0, 1.0),
               "mamba2-130m/decode": (1.0, 1.0),
               "olmoe-1b-7b/prefill": (0.9, 1.0),
               "gemma-7b/train": (0.75, 1.0),
               "mamba2-130m/train": (0.999, 1.0)}


@pytest.mark.parametrize("cell", list(_CELLS))
def test_cell_flops_and_collectives_against_jax_run_cell(cell, cell_rows):
    want, got = cell_rows["jax"][cell], cell_rows["torch"][cell]
    lo, hi = _FLOP_RATIO[cell]
    assert want["flops"] > 0
    assert lo * want["flops"] <= got["flops"] <= hi * want["flops"], \
        (got["flops"], want["flops"])
    # the collective kinds: only those JAX's traffic model weights; an
    # all-gather wherever JAX gathers; a reduction (all-reduce, or its
    # reduce-scatter form: XLA's CPU compile emits none) wherever JAX
    # reduces.  GSPMD's all-to-all and permute reshards have no DTensor
    # counterpart here (the fake group gathers and slices instead).
    kinds = set(got["collectives"])
    assert kinds <= {"all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute"}
    if "all-gather" in want["collectives"]:
        assert "all-gather" in kinds
    if "all-reduce" in want["collectives"]:
        assert kinds & {"all-reduce", "reduce-scatter"}


_SHAPE_FAULT = """
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.core.trace_costs import trace_costs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_device_mesh, make_mesh_compat
mesh = make_mesh_compat((2, 4), ("data", "model"), device="meta")
dm = fake_device_mesh(mesh)
try:
    x = DTensor.from_local(torch.empty((2, 16, 8), device="meta"), dm,
                           [Shard(0), Shard(2)])
    # a view DTensor cannot plan (heads split across the model shards)
    # is replicated and counted
    from repro_torch import obs
    obs.reset_counters("dryrun.")
    y, _ = trace_costs(lambda t: t.view(4, 16, 2, 16), x,
                       inner=dryrun.ReplicateOnGap())
    print("GAP", tuple(y.shape) == (4, 16, 2, 16),
          obs.counters("dryrun.redistribute_for_op.")
          == {"dryrun.redistribute_for_op.view.default": 1})
    # a wrong shape in the program is an error, raised with nothing
    # replicated first
    obs.reset_counters("dryrun.")
    try:
        trace_costs(lambda t: t.view(4, 16, 3, 16), x,
                    inner=dryrun.ReplicateOnGap())
    except RuntimeError:
        print("FAULT", obs.counters("dryrun.redistribute_for_op.") == {})
finally:
    dist.destroy_process_group()
"""


def test_replicate_on_gap_retries_plans_not_shape_faults(tmp_path):
    out = _run(_SHAPE_FAULT, tmp_path)
    assert "GAP True True" in out and "FAULT True" in out, out


_ODD_VOCAB = """
import dataclasses, json
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core.trace_costs import trace_costs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_device_mesh, make_mesh_compat
cfg = dataclasses.replace(get_config("gemma-7b", reduced=True),
                          vocab_size=250)
dryrun.get_config = lambda arch, reduced=False: cfg
mesh = make_mesh_compat((2, 4), ("data", "model"), device="meta")
dm = fake_device_mesh(mesh)
try:
    with implicit_replication(), torch.no_grad():
        fn, args, donate, _ = dryrun.build_cell(
            "gemma-7b", ShapeSpec("t", 16, 4, "train"), mesh, dm)
        _, costs = trace_costs(fn, *args, donate=donate,
                               inner=dryrun.ReplicateOnGap())
finally:
    dist.destroy_process_group()
print("SHAPES", json.dumps(sorted(costs.dot_flops_by_shape)))
"""


def test_train_cell_with_a_vocabulary_the_model_axis_does_not_divide(
        tmp_path):
    """250 logits over a 4-way 'model' axis: the rules leave the table's
    vocabulary unsharded, the head splits it unevenly (63, 63, 62, 62
    columns) rather than repeat it on each rank, and the loss's label
    logit reads the uneven shards."""
    shapes = json.loads(_run(_ODD_VOCAB, tmp_path).split("SHAPES", 1)[1])
    assert "f32[16,63]" in shapes, shapes      # rank 0's 63 head columns
    assert not any(s.endswith(",250]") for s in shapes), shapes


def test_dryrun_entrypoint_smoke(tmp_path):
    """JAX's own smoke cell: mamba2-130m decode_32k on the multi-pod
    mesh (512 fake ranks)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "tune.json"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--mesh", "multi",
         "--out", str(tmp_path / "rows.jsonl")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[OK]" in out.stdout, out.stdout
    row = json.loads((tmp_path / "rows.jsonl").read_text())
    assert row["chips"] == 512 and row["kind"] == "decode"
    assert row["hlo_gflops"] > 0 and row["dev_bytes_total"] > 0
    assert row["fits_hbm"] is True
    for key in ("dev_bytes_tpu_adj", "fits_hbm_tpu_adj"):
        assert key not in row


# ----------------------------------------------------------------------
# mesh=None is unchanged
# ----------------------------------------------------------------------
def test_mesh_none_outputs_are_bit_equal_to_the_parent_tree():
    want = np.load(ROOT / "tests" / "data" / "torch_gemma_mesh_none.npz")
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    for name, ctx in (("torch_f32", Ctx(plan="torch", dtype=torch.float32)),
                      ("auto_bf16", Ctx(dtype=torch.bfloat16))):
        assert ctx.mesh is None
        params = m.init(seed=0, dtype=ctx.dtype, device="cpu")
        got = {"prefill_logits": m.prefill_logits(params,
                                                  {"tokens": tokens}, ctx)}
        _, cache = m.prefill(params, {"tokens": tokens}, ctx, 12)
        assert cache["pos"].dim() == 0        # the scalar-position write
        got["decode"] = m.decode(params, cache, nxt, ctx)[0]
        got["loss"] = m.loss(params, {"tokens": tokens, "targets": tokens},
                             ctx)
        for k, v in got.items():
            assert np.array_equal(v.float().numpy(), want[f"{name}_{k}"]), \
                (name, k)


def test_mesh_none_gradients_are_bit_equal_to_the_parent_tree():
    """The backward pass without a mesh, as the one-rank train step runs
    it: the embedding table's gradient and every leaf's squared gradient
    norm (float64) of ``m.loss``, bit-equal to the same computation on
    the tree before execution across ranks (the embedding's backward, an
    index's, is the one a DTensor's lookup would change)."""
    want = np.load(ROOT / "tests" / "data" / "torch_gemma_mesh_none_grads.npz")
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    for name, ctx in (("torch_f32", Ctx(plan="torch", dtype=torch.float32)),
                      ("auto_bf16", Ctx(dtype=torch.bfloat16))):
        ps, treedef = flatten(m.init(seed=0, dtype=ctx.dtype, device="cpu"))
        xs = [p.detach().requires_grad_() for p in ps]
        loss = m.loss(unflatten(treedef, xs),
                      {"tokens": tokens, "targets": tokens}, ctx)
        gs = torch.autograd.grad(loss, xs)
        embed = unflatten(treedef, list(gs))["embed"]["tokens"]
        assert np.array_equal(embed.float().numpy(),
                              want[f"{name}_embed_grad"]), name
        assert np.array_equal([float(g.double().square().sum()) for g in gs],
                              want[f"{name}_grad_sq"]), name


# ----------------------------------------------------------------------
# imports
# ----------------------------------------------------------------------
_NO_JAX = """
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import SHAPES, ShapeSpec, input_specs, get_config
from repro_torch.core import roofline, trace_costs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_device_mesh, make_mesh_compat
input_specs(get_config("zamba2-2.7b"), SHAPES["train_4k"])
mesh = make_mesh_compat((1, 2), ("data", "model"), device="meta")
dm = fake_device_mesh(mesh)
try:
    with implicit_replication(), torch.no_grad():
        fn, args, donate, useful = dryrun.build_cell(
            "olmoe-1b-7b", ShapeSpec("p", 8, 16, "prefill"), mesh, dm,
            reduced=True)
        _, costs = trace_costs.trace_costs(fn, *args, donate=donate,
                                           inner=dryrun.ReplicateOnGap())
finally:
    dist.destroy_process_group()
assert roofline.analyze_trace("p", costs, 2).hlo_flops > 0
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print("clean")
"""


def test_dry_run_imports_neither_jax_nor_the_jax_package(tmp_path):
    assert _run(_NO_JAX, tmp_path).strip().endswith("clean")
