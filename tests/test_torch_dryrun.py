"""The port's dry run on H100 meshes held against the JAX package's and
against the port's own CPU runs.

* Configs: ``SHAPES``, ``cells()``, ``runs_shape``, ``input_specs``
  (shapes and dtypes), ``is_subquadratic``, ``params_count`` and
  ``active_params_count`` equal JAX's for all ten archs; ``model_flops``
  equals JAX's for every cell, exactly.
* Report: ``RooflineReport``'s ``dominant`` and ``useful_fraction`` equal
  JAX's on the same inputs; JAX's ``report.table`` renders the port's
  rows as the port's ``table`` does, the note column apart (the port
  notes an H100's 80 GB, JAX a v5e's 16 GiB).
* Meta routes: every kernel's ``meta`` route gives the shapes and dtypes
  of its plain version's CPU output, and a call is charged the same cost
  on both devices.
* Smoke cells on a (1, 1) fake mesh (seven archs, train, prefill and
  decode): argument bytes equal the CPU tree's; FLOPs, bytes and peak
  equal a CPU run of the same step under the same cost mode, exactly for
  the dense configs and at or above it for MoE (the ``meta`` branch
  computes every expert and takes the decode-then-quantize Q_W).
* JAX's dry run: smollm-smoke's train-step argument bytes equal JAX's
  ``memory_analysis()`` on a one-device mesh once the leaves the port
  widens are counted at JAX's width (H2: 16-bit words in int32; the step
  and Madam count are host ints in the port, int32 arrays in JAX); the
  port's FLOPs lie between a hand count of the GEMMs (6 N T) and JAX's
  ``cost_analysis()`` with the layers unrolled. JAX runs in a subprocess,
  so the dry run's ``XLA_FLAGS`` stay out of this worker.
* Collectives: a (1, 2) mesh of gloo ranks takes real decode steps
  (smollm, gemma3) and a real tensor-parallel train step (gemma3, heads
  and MLP over model), a (2, 1) one a real data-parallel train step and a
  (2, 2) one a real prefill with the rows over data (smollm); the
  collective counts and bytes by kind and axis equal the dry run's on the
  fake backend. Every cell runs under ``dryrun.cell_rules``, the rules the
  dry run gives it.
* Mesh: ``make_production_mesh``'s shapes, coordinates, group sizes and
  hosts, and its refusal off ``meta`` without torchrun.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as T  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.distributed.sharding import shard_ctx  # noqa: E402
from repro_torch.kernels import costs, dispatch, ref  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE_ARCHS = ("smollm-135m", "gemma3-12b", "rwkv6-1.6b", "zamba2-7b",
               "deepseek-v3-671b", "musicgen-medium", "phi-3-vision-4.2b")
MOE = {"deepseek-v3-671b"}
SPECS = {"train": ShapeSpec("tiny_train", 16, 2, "train"),
         "prefill": ShapeSpec("tiny_prefill", 16, 2, "prefill"),
         "decode": ShapeSpec("tiny_decode", 16, 2, "decode")}


@pytest.fixture(scope="module", autouse=True)
def background():
    """JAX's compile (a subprocess) and the gloo ranks start before the
    first test and run beside the others; their tests collect them."""
    import shutil
    import torch.multiprocessing as mp
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_CELL], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    d = tempfile.mkdtemp()
    ranks = {}
    for shape in COLL_CELLS:
        sub = Path(d) / f"{shape[0]}x{shape[1]}"
        sub.mkdir()
        n = shape[0] * shape[1]
        ranks[shape] = (sub, mp.start_processes(
            _coll_rank, args=(n, f"{sub}/store", shape, str(sub)),
            nprocs=n, join=False, start_method="spawn"))
    yield {"jax": jax_proc, "gloo": ranks}
    if jax_proc.poll() is None:
        jax_proc.kill()
    jax_proc.communicate()
    for _, ctx in ranks.values():
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs and the roofline's arithmetic


def test_shapes_and_cells_equal_jax():
    import repro.configs as J
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in T.SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in J.SHAPES.items()}
    assert T.cells() == J.cells() and len(T.cells()) == 33
    assert T.cells(include_skipped=True) == J.cells(include_skipped=True)


@pytest.mark.parametrize("arch", list(T.ARCHS))
def test_config_counts_and_input_specs_equal_jax(arch):
    import repro.configs as J
    cj, ct = J.get_config(arch), T.get_config(arch)
    assert ct.is_subquadratic == cj.is_subquadratic
    assert ct.params_count() == cj.params_count()
    assert ct.active_params_count() == cj.active_params_count()
    for shape in J.SHAPES:
        assert T.runs_shape(ct, shape) == J.runs_shape(cj, shape)
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in J.input_specs(cj, shape).items()}
        got = T.input_specs(ct, shape)
        assert all(v.device.type == "meta" for v in got.values())
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == want, (arch, shape)


@pytest.mark.parametrize("arch,shape", T.cells(include_skipped=True))
def test_model_flops_equal_jax(arch, shape):
    import repro.configs as J
    from repro.launch import roofline as jr
    spec = J.SHAPES[shape]
    assert roofline.model_flops(T.get_config(arch), T.SHAPES[shape],
                                spec.kind) == jr.model_flops(
        J.get_config(arch), spec, spec.kind)


REPORTS = [
    dict(flops_per_device=4e12, bytes_per_device=1e9,
         collective_bytes_per_device=1e6, t_compute=2.0, t_memory=1.0,
         t_collective=0.5, model_flops_global=1e14, chips=256),
    dict(flops_per_device=1e9, bytes_per_device=8e11,
         collective_bytes_per_device=0.0, t_compute=0.1, t_memory=3.0,
         t_collective=0.0, model_flops_global=2e11, chips=512),
    dict(flops_per_device=0.0, bytes_per_device=1e3,
         collective_bytes_per_device=5e9, t_compute=0.0, t_memory=1e-3,
         t_collective=4.0, model_flops_global=0.0, chips=8),
]


@pytest.mark.parametrize("kw", REPORTS)
def test_report_properties_equal_jax(kw):
    from repro.launch import roofline as jr
    args = dict(arch="a", shape="s", mesh="m", **kw)
    mine, theirs = roofline.RooflineReport(**args), jr.RooflineReport(**args)
    assert mine.dominant == theirs.dominant
    assert mine.useful_fraction == theirs.useful_fraction


def test_table_renders_as_jax_apart_from_the_note():
    from repro.launch import report as jrep
    rows = []
    for i, kw in enumerate(REPORTS):
        r = roofline.RooflineReport(arch=f"a{i}", shape="decode_32k",
                                    mesh="32x8", **kw).row()
        r["memory"] = {"peak_bytes": [None, 20 * 2**30, 90e9][i]}
        rows.append(r)
    mine, theirs = report.table(rows), jrep.table(rows)
    cut = lambda t: [line.rsplit("|", 2)[0] for line in t.splitlines()]
    assert cut(mine) == cut(theirs)
    notes = [line.rsplit("|", 2)[1].strip() for line in mine.splitlines()]
    assert notes[2:] == ["", "", "exceeds H100 80 GB"]


# ---------------------------------------------------------------------------
# the kernels' meta route


def _kernel_calls():
    """(name, thunk(device)) for every dispatch entry point, on inputs
    made on the CPU and moved to ``device`` (``meta`` keeps the shapes
    and dtypes)."""
    from repro_torch.core.lns import LNSFormat
    rng = np.random.default_rng(0)
    fmt, f16 = LNSFormat(8, 8), LNSFormat(16, 2048)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    pa, sa = ref.encode_pack(x, fmt)
    pb = torch.from_numpy(rng.integers(0, 256, (32, 8), dtype=np.uint8))
    sb = torch.ones((1, 8))
    q = torch.randn(2, 2, 4, 32, dtype=torch.bfloat16)
    pool = torch.from_numpy(rng.integers(0, 256, (5, 4, 2, 32),
                                         dtype=np.uint8))
    psc = torch.ones(5, 4, 2, 1, dtype=torch.bfloat16)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    ln = torch.tensor([3, 8], dtype=torch.int32)
    w16 = torch.from_numpy(rng.integers(0, 1 << 16, (2, 6, 10)).astype(
        np.int32))
    g, v = torch.randn(2, 6, 10), torch.rand(2, 6, 10)
    code = torch.from_numpy(rng.integers(0, 1 << 15, (6, 10)).astype(
        np.int16))
    sign = torch.from_numpy(np.where(rng.random((6, 10)) < 0.5, 1, -1)
                            .astype(np.int8))
    lg = torch.randn(3, 50)
    temp = np.full(3, 0.7, np.float32)
    seed, step = np.arange(3, dtype=np.uint32), np.zeros(3, np.int32)
    d = dispatch
    return {
        "encode_pack": lambda m: d.encode_pack(m(x), fmt),
        "encode_pack_scale": lambda m: d.encode_pack(
            m(x), fmt, 0, m(torch.ones(4, 1))),
        "qmatmul": lambda m: d.qmatmul(m(pa), m(pb), fmt, m(sa), m(sb)),
        "qmatmul_bf16": lambda m: d.qmatmul(m(pa), m(pb), fmt,
                                            out_dtype=torch.bfloat16),
        "qmatmul_decode": lambda m: d.qmatmul_decode(m(pa), m(pb), fmt),
        "paged_attend": lambda m: d.paged_attend(
            m(q), m(pool), m(pool), m(psc), m(psc), m(bt), m(ln), fmt=fmt,
            sm_scale=0.25),
        "fused_sample": lambda m: d.fused_sample(m(lg), None, None),
        "fused_sample_noise": lambda m: d.fused_sample(
            m(lg), m(torch.randn(3, 50)), m(torch.full((3,), 0.7))),
        "fused_sample_seeded": lambda m: d.fused_sample_seeded(
            m(lg), temp, seed, step, noise_out=True),
        "requant_pack": lambda m: d.requant_pack(m(pb), fmt,
                                                 fmt.with_bits(6)),
        "requant_pack_many": lambda m: d.requant_pack_many(
            [m(pb), m(pa)], fmt, fmt.with_bits(5)),
        "madam_step": lambda m: d.madam_step(m(w16), m(g), m(v), 3, f16,
                                             lr=0.01),
        "madam_step_stats": lambda m: d.madam_step(
            m(w16), m(g), m(v), 3, f16, lr=0.01, with_stats=True),
        "madam_step_unpacked": lambda m: d.madam_step_unpacked(
            m(code), m(sign), m(g[0]), m(v[0]), 3, f16, lr=0.01),
        "lns_matmul_packed": lambda m: d.lns_matmul_packed(
            m(pa), m(pb), fmt, lut_entries=2),
    }


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.dtype, out.device.type)
    if isinstance(out, dict):
        return {k: _shapes(v) for k, v in out.items()}
    return [_shapes(o) for o in out]


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_meta_route_gives_the_plain_versions_shapes(name):
    from repro_torch.launch.cost import CostMode
    call = _kernel_calls()[name]
    to_meta = lambda t: t.to("meta")
    costs.reset_tally()
    with CostMode() as cpu_mode:
        want = call(lambda t: t)
    with CostMode() as meta_mode:
        got = call(to_meta)
    cpu_s = _shapes(want)
    meta_s = _shapes(got)
    swap = lambda s: (s.replace("cpu", "meta") if isinstance(s, str) else
                      tuple(swap(x) for x in s) if isinstance(s, tuple) else
                      [swap(x) for x in s] if isinstance(s, list) else
                      {k: swap(x) for k, x in s.items()}
                      if isinstance(s, dict) else s)
    assert meta_s == swap(cpu_s)
    # one charge a call, the same on both devices (K5's at most: on meta
    # it counts every position of the block table, the lengths unread),
    # and the meta tally
    if name == "paged_attend":
        (m,), (c,) = (meta_mode.kernels.values(),
                      cpu_mode.kernels.values())
        assert m[0] == c[0] == 1 and m[1] >= c[1] and m[2] >= c[2]
    else:
        assert meta_mode.kernels == cpu_mode.kernels
    tally = costs.tally()
    assert len(tally) == 1
    (k, row), = tally.items()
    assert row["calls"] == 1 and row["ops"] == meta_mode.kernels[k][1]


def test_cuda_route_unchanged_by_a_cost_sink():
    """A cost sink changes no route: a CPU tensor still takes the plain
    version (no launch counted), and ``meta`` is never a fallback."""
    from repro_torch.kernels import ops
    from repro_torch.launch.cost import CostMode
    ops.reset_launch_counts()
    with CostMode():
        for call in _kernel_calls().values():
            call(lambda t: t)
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}
    assert dispatch.route(torch.empty(1)) == "plain"


# ---------------------------------------------------------------------------
# smoke cells on a (1, 1) fake mesh, held to a CPU run of the same step


def _run_cell_both(arch, kind):
    from repro_torch.launch.cost import tensor_bytes
    cfg = T.get_smoke_config(arch)
    spec = SPECS[kind]
    out = {}
    with dryrun.meta_mesh({"data": 1, "model": 1}, 1) as mesh:
        rules = dryrun.cell_rules(arch, cfg, kind, mesh, spec.global_batch)
        for dev in ("cpu", "meta"):
            with shard_ctx(mesh, rules):
                args, run = dryrun.cell_step(cfg, spec, mesh, rules,
                                             device=dev)
                out[dev] = dryrun.measure(args, run)
                out[dev]["tree"] = tensor_bytes(args)
    return out


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_cell_equals_its_cpu_run(arch, kind):
    out = _run_cell_both(arch, kind)
    cpu, meta = out["cpu"], out["meta"]
    assert meta["memory"]["argument_size_in_bytes"] == cpu["tree"] == \
        cpu["memory"]["argument_size_in_bytes"]
    assert meta["kernels"] and meta["flops"] > 0
    keys = [("flops",), ("bytes",), ("memory", "peak_bytes")]
    get = lambda r, k: r[k[0]] if len(k) == 1 else r[k[0]][k[1]]
    for k in keys:
        if arch in MOE:
            assert get(meta, k) >= get(cpu, k), (k, meta, cpu)
        else:
            assert get(meta, k) == get(cpu, k), (k, meta, cpu)
    if arch not in MOE:
        assert meta["memory"] == cpu["memory"]
        assert {n: r["calls"] for n, r in meta["kernels"].items()} == \
            {n: r["calls"] for n, r in cpu["kernels"].items()}


# ---------------------------------------------------------------------------
# held to JAX's dry run (a subprocess: its module forces 512 devices)

JAX_CELL = r"""
import json
import numpy as np
import jax
import repro.launch.dryrun as D
from repro.configs import SHAPES, ShapeSpec, get_rules, get_smoke_config
spec = ShapeSpec("tiny_train", 32, 4, "train")
SHAPES[spec.name] = spec
mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
cost, mem, _, _ = D._lower_compile(
    get_smoke_config("smollm-135m"), spec, mesh, get_rules("smollm-135m"),
    scan_unroll=True)
print(json.dumps({"flops": cost["flops"], "mem": mem}))
"""


def test_smollm_smoke_train_held_to_jax_dry_run(background):
    from repro_torch.core.lns import is_lns_weight
    from repro_torch.tree import leaves
    proc = background["jax"]
    cfg = T.get_smoke_config("smollm-135m")
    spec = ShapeSpec("tiny_train", 32, 4, "train")
    with dryrun.meta_mesh({"data": 1, "model": 1}, 1) as mesh, \
            shard_ctx(mesh, T.get_rules("smollm-135m")):
        args, run = dryrun.cell_step(cfg, spec, mesh,
                                     T.get_rules("smollm-135m"))
        mine = dryrun.measure(args, run)
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    jax_row = json.loads(out.strip().splitlines()[-1])
    state = args[0]
    # H2: 16-bit words live in int32 (JAX: uint16); the step and Madam's
    # count are host ints (JAX: two int32 scalars)
    wide = sum(p.packed.numel() for _, p in leaves(state.params)
               if is_lns_weight(p) and p.fmt.bits > 8)
    assert wide > 0 and isinstance(state.step, int) and \
        isinstance(state.opt.count, int)
    assert (mine["memory"]["argument_size_in_bytes"] - 2 * wide + 2 * 4
            == jax_row["mem"]["argument_size_in_bytes"])
    # the band: 6 N T over the GEMM weights (attention, MLP, the tied
    # head) below, JAX's every-op count above
    d, hd = cfg.d_model, cfg.head_dim
    n_gemm = (cfg.num_layers * (d * cfg.num_heads * hd
                                + 2 * d * cfg.num_kv_heads * hd
                                + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
              + d * cfg.vocab_size)
    lower = 6 * n_gemm * spec.global_batch * spec.seq_len
    assert lower <= mine["flops"] <= jax_row["flops"], (
        lower, mine["flops"], jax_row["flops"])


# ---------------------------------------------------------------------------
# collectives: real gloo ranks against the fake backend

COLL_CELLS = {(1, 2): [("smollm-135m", "decode"), ("gemma3-12b", "decode"),
                       ("gemma3-12b", "train")],
              (2, 1): [("smollm-135m", "train")],
              (2, 2): [("smollm-135m", "prefill")]}


def _cell_collectives(arch, kind, mesh, device):
    cfg = T.get_smoke_config(arch)
    rules = dryrun.cell_rules(arch, cfg, kind, mesh,
                              SPECS[kind].global_batch)
    with shard_ctx(mesh, rules):
        args, run = dryrun.cell_step(cfg, SPECS[kind], mesh, rules,
                                     device=device)
        rep = dryrun.measure(args, run)
    return {"bytes": rep["collectives"], "calls": rep["collective_calls"]}


def _coll_rank(r, n, store, shape, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=n)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device="cpu")
    out = {f"{a}/{k}": _cell_collectives(a, k, mesh, "cpu")
           for a, k in COLL_CELLS[shape]}
    (Path(out_dir) / f"rank{r}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_collectives(background):
    out = {}
    for shape, (sub, ctx) in background["gloo"].items():
        while not ctx.join():
            pass
        out[shape] = [pickle.loads((sub / f"rank{r}.pkl").read_bytes())
                      for r in range(shape[0] * shape[1])]
    return out


@pytest.mark.parametrize("shape,cell", [(s, c) for s, cs in
                                        COLL_CELLS.items() for c in cs])
def test_collectives_equal_the_fake_backends(gloo_collectives, shape, cell):
    arch, kind = cell
    with dryrun.meta_mesh({"data": shape[0], "model": shape[1]},
                          shape[0] * shape[1]) as mesh:
        want = _cell_collectives(arch, kind, mesh, "meta")
    assert sum(want["calls"].values()) > 0
    for r, got in enumerate(gloo_collectives[shape]):
        assert got[f"{arch}/{kind}"] == want, (r, got, want)


# ---------------------------------------------------------------------------
# the production mesh


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes_groups_and_hosts(multi_pod):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    assert not dist.is_initialized()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        want = ({"pod": 2} if multi_pod else {}) | {"data": 32, "model": 8}
        assert mesh.shape == want and mesh.size == (512 if multi_pod
                                                    else 256)
        assert mesh.rank == 0 and set(mesh.coords.values()) == {0}
        assert mesh.device.type == "meta" and mesh.cards_per_host == 8
        names = tuple(want)
        import itertools
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                size = int(np.prod([want[a] for a in axes]))
                assert dist.get_world_size(mesh.group(axes)) == size
                assert len(mesh.group_ranks(axes)) == size
        assert mesh.group_ranks("model") == tuple(range(8))
        assert mesh.group_ranks("data") == tuple(range(0, 256, 8))
        assert mesh.within_host("model") and not mesh.within_host("data")
        if multi_pod:
            assert mesh.group_ranks("pod") == (0, 256)
        y = torch.distributed.all_reduce(torch.empty(4, device="meta"),
                                         group=mesh.group("model"))
        del y
    finally:
        dist.destroy_process_group()


def test_production_mesh_refuses_cards_without_torchrun(monkeypatch):
    from repro_torch.launch.mesh import make_production_mesh
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        make_production_mesh(hosts=1, cards=2, device="cpu")


# ---------------------------------------------------------------------------
# split-KV decode: the decode cells under JAX's batch and kv_seq rules

DECODE_CELLS = [(a, s) for a, s in T.cells() if T.SHAPES[s].kind == "decode"]


def _jax_shard_shape(shape, spec, mesh_shape):
    out = []
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n = 1
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            n *= mesh_shape[a]
        out.append(size // n)
    return tuple(out)


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_cache_local_shapes_equal_jax_spec(arch, shape):
    """Each cache leaf of a decode cell, as ``init_caches`` places it on
    rank 0 of the production mesh under the decode rules, has the shard
    shape of JAX's ``spec_for`` of that leaf under ``get_rules(arch)``
    (with JAX's batch-1 override; the rows over the data axes and the KV
    heads as the serving rules shard the weights, as ``decode_rules``
    keeps them): dense KV caches, MLA latents and
    cursors exactly; a ring JAX's rows with every slot (the port keeps
    ring slots whole) and the serving head group; recurrent state JAX's
    rows with every head."""
    import jax
    from repro.configs import get_config as j_config
    from repro.configs import get_rules as j_rules
    from repro.distributed import params_sharding as jps
    from repro.distributed import sharding as jsh
    from repro.models import init_caches as j_init_caches
    from repro_torch.distributed.sharding import decode_rules
    from repro_torch.models.model import init_caches
    from repro_torch.tree import leaves
    cfg, spec = T.get_config(arch), T.SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    jc = jax.eval_shape(lambda: j_init_caches(B, S, j_config(arch)))
    is_axes = (lambda x: isinstance(x, tuple)
               and all(e is None or isinstance(e, str) for e in x))
    flat = lambda t, **kw: {
        "::".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
        for p, v in jax.tree_util.tree_flatten_with_path(t, **kw)[0]}
    jshapes = flat(jc)
    jaxes = flat(jps.cache_logical_axes(jc), is_leaf=is_axes)
    with dryrun.meta_mesh({"data": 32, "model": 8}, 8) as mesh:
        rules = decode_rules(cfg, mesh, B, T.get_rules(arch))
        # the port's rows go over the data axes only and its KV heads as
        # its weights hold them (decode_rules)
        jr = dict(j_rules(arch), batch=("pod", "data"),
                  kv_heads=rules["kv_heads"])
        if B % 32:
            jr.update(batch=None, kv_seq=("data", "model"))
        with shard_ctx(mesh, rules):
            tc = init_caches(B, S, cfg, device="meta")
        mine = {"::".join(str(k) for k in p): tuple(t.shape)
                for p, t in leaves(tc)}
        assert mine.keys() == jshapes.keys()
        prefix, _, period = cfg.layer_pattern()
        exact = 0
        for key, jshape in jshapes.items():
            parts = key.split("::")
            kind = (prefix[int(parts[1])] if parts[0] == "prefix"
                    else period[int(parts[1][3:])])
            axes = jaxes[key]
            want = _jax_shard_shape(jshape.shape, tuple(jsh.spec_for(
                axes, mesh, jr)), mesh.shape)
            got = mine[key]
            b = list(axes).index("batch") if "batch" in axes else None
            if kind == "local" and parts[-1] in ("k", "v"):
                assert got[b] == want[b] and got[b + 1] == jshape.shape[
                    b + 1], (key, got, want)
            elif kind in ("mamba", "rwkv"):
                assert got[b] == want[b] and got[b + 1:] == tuple(
                    jshape.shape[b + 1:]), (key, got, want)
            else:
                assert got == want, (key, got, want)
                exact += parts[-1] in ("k", "v", "c_kv", "k_rope")
        split = tuple(jsh.spec_for(("kv_seq",), mesh, jr))[0]
    if cfg.family not in ("ssm",):
        assert exact > 0
    if arch != "smollm-135m" and cfg.family != "ssm":
        assert split is not None


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_decode_rows_name_split_kv(shape):
    """gemma3-12b's decode cells run split-KV: the row's placement says
    so, long_500k's cache spreads over data and model (2048 positions a
    rank) and decode_32k's over model with 4 of the 128 rows a rank, and
    every global layer merges with one SUM reduce (8 a step)."""
    row = dryrun.run_cell("gemma3-12b", shape)
    assert "split-KV decode" in row["placement"]
    assert "no split-KV" not in row["placement"]
    if shape == "long_500k":
        assert "over data+model (2048 of 524288 positions" in row[
            "placement"]
        assert "batch of 1 over replicated" in row["placement"]
    else:
        assert "over model (4096 of 32768 positions" in row["placement"]
        assert "batch of 128 over data (4 a rank)" in row["placement"]
    assert row["collective_calls"]["sum"] == 8
