"""The port's sharding rules, placements and single-process mesh pieces
against the JAX package, on the CPU with no devices and no process group.

* ``spec_for`` and ``serving_rules`` equal JAX's (which take a duck-typed
  mesh: ``axis_names`` and ``shape``) for every ``ARCHS`` config, smoke
  and full, under the default rules, each config's ``get_rules`` and its
  serving rules, over the meshes (1, 1), (1, 2), (2, 1), (2, 2), (1, 4)
  and a (pod, data, model) one, for every logical name, every leaf's
  axes and the composite cache annotations (first-wins dedup).
* ``params_logical_axes`` (serving off and on), ``cache_logical_axes``
  and ``opt_logical_axes`` (full and factored second moments) equal
  JAX's leaf for leaf on ``jax.eval_shape`` trees (the port's trees are
  made of meta tensors of the same shapes: no init compute).
* A rank's local tree: ``init_params(shard=LocalShard(...))`` gives,
  word for word, ``shard_tree`` of the whole draw, for every rank of
  (2, 2) and (1, 4) meshes (gemma3-smoke head-sharded, kimi-smoke's
  experts).
* ``error_feedback_update`` against JAX's: codes equal, values within
  H12's scale error (ROADMAP), residuals to 1e-6.
* ``build_prefill_step``/``build_decode_step`` against JAX's
  ``test_prefill_then_decode_serving`` (gemma3-smoke, the 16-bit store):
  each within 2e-5 of JAX's logits, and prefill vs decode within JAX's
  5e-2.
* ``examples/quickstart_torch.py --device cpu`` runs its four steps in
  under 20 s; ``launch.serve --mesh 1,1`` serves a world of one without
  torchrun and equals the run without a mesh; ``--mesh 2,2`` without
  torchrun raises.
"""
import itertools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_rules as j_rules  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.distributed import params_sharding as jps  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_rules  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.lns import LNSFormat, LNSWeight  # noqa: E402
from repro_torch.distributed import params_sharding as tps  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class DuckMesh:
    """What both packages' ``spec_for`` read from a mesh."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = [{"data": 1, "model": 1}, {"data": 1, "model": 2},
          {"data": 2, "model": 1}, {"data": 2, "model": 2},
          {"data": 1, "model": 4}, {"pod": 2, "data": 2, "model": 2}]
NAMES = sorted(tsh.LOGICAL_RULES) + [None]
COMPOSITE = [("batch", "kv_seq", "kv_heads", None),
             (None, None, "kv_heads", None), ("batch", "act_heads", None),
             ("batch_full", "seq_shard", "heads"), ("experts", "embed",
                                                    "moe_ff"),
             ("stack", "experts", "moe_ff", "embed"), ("batch", "batch_full")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _name_tuples():
    out = [(n,) for n in NAMES] + COMPOSITE
    out += [a for a in tps._BY_NAME.values()]
    out += [a for a in tps._CACHE_AXES.values()]
    out += list(itertools.product(["vocab", "qkv_out", None],
                                  ["mlp", "experts", "embed"]))
    return out


def test_tables_are_jax_tables():
    assert tsh.LOGICAL_RULES == jsh.LOGICAL_RULES
    assert tps._BY_NAME == jps._BY_NAME
    assert tps._RWKV_NAMES == jps._RWKV_NAMES
    assert tps._SERVING_NAMES == jps._SERVING_NAMES
    assert tps._CACHE_AXES == jps._CACHE_AXES
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for arch in ARCHS:
        assert get_rules(arch) == j_rules(arch)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_for_and_serving_rules_equal_jax(arch):
    tuples = _name_tuples()
    for smoke in (True, False):
        tcfg = get_smoke_config(arch) if smoke else get_config(arch)
        jcfg = j_smoke(arch) if smoke else j_config(arch)
        for shape in MESHES:
            mesh = DuckMesh(shape)
            serve = tsh.serving_rules(tcfg, mesh)
            assert serve == jsh.serving_rules(jcfg, mesh), (arch, shape)
            assert tsh.model_axis_size(mesh) == jsh.model_axis_size(mesh)
            for rules in (None, get_rules(arch), serve):
                for names in tuples:
                    want = tuple(jsh.spec_for(names, mesh, rules))
                    assert tsh.spec_for(names, mesh, rules) == want, (
                        arch, smoke, shape, rules, names)
                with tsh.shard_ctx(mesh, rules), jsh.shard_ctx(mesh, rules):
                    for names in tuples[:len(NAMES)]:
                        assert tsh.spec_for(names) == tuple(
                            jsh.spec_for(names))
    assert tsh.spec_for(("vocab",)) == () == tuple(jsh.spec_for(("vocab",)))


# ---------------------------------------------------------------------------
# trees: JAX's eval_shape trees, the port's as meta tensors of those shapes


def _flat_axes(tree, is_port):
    """``{path: axes}`` of a JAX or a port axes tree (a packed leaf's
    ``packed``/``scale`` entries under ``::packed``/``::scale``)."""
    out = {}
    if is_port:
        def walk(t, path):
            if isinstance(t, LNSWeight):
                out[path + "::packed"] = tuple(t.packed)
                out[path + "::scale"] = tuple(t.scale)
            elif isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}::{k}" if path else str(k))
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    walk(v, f"{path}::{i}" if path else str(i))
            elif hasattr(t, "_fields"):
                for k in t._fields:
                    walk(getattr(t, k), f"{path}::{k}" if path else k)
            else:
                out[path] = tuple(t)
        walk(tree, "")
        return out
    is_axes = lambda x: isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_axes)[0]:
        key = "::".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)
        out[key] = tuple(leaf)
    return out


def _meta(tree):
    """A port tree of meta tensors shaped like a JAX shape tree (packed
    leaves become ``LNSWeight``)."""
    from repro.core.lns import LNSWeight as JW
    if isinstance(tree, JW):
        return LNSWeight(torch.empty(tree.packed.shape, device="meta"),
                         torch.empty(tree.scale.shape, device="meta"),
                         LNSFormat(8, 8))
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return [_meta(v) for v in tree]
    return torch.empty(tuple(tree.shape), device="meta")


@pytest.fixture(scope="module")
def shape_trees():
    from repro.optim.madam import MadamConfig
    from repro.training import init_train_state
    out = {}
    for arch in sorted(ARCHS):
        for smoke in (True, False):
            jcfg = j_smoke(arch) if smoke else j_config(arch)
            for factored in (False, True):
                mcfg = MadamConfig(factored=factored)
                st = jax.eval_shape(lambda k: init_train_state(k, jcfg, mcfg),
                                    jax.random.PRNGKey(0))
                out[(arch, smoke, factored)] = st
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_and_opt_axes_equal_jax(shape_trees, arch):
    from repro_torch.optim.madam import MadamState
    for smoke in (True, False):
        for factored in (False, True):
            st = shape_trees[(arch, smoke, factored)]
            tp = _meta(st.params)
            for serving in (False, True):
                want = _flat_axes(jps.params_logical_axes(st.params, serving),
                                  False)
                got = _flat_axes(tps.params_logical_axes(tp, serving), True)
                assert got == want, (arch, smoke, serving)
            tg2 = _meta(st.opt.g2)
            want = _flat_axes(jps.opt_logical_axes(st.params, st.opt), False)
            got = _flat_axes(tps.opt_logical_axes(tp, MadamState(
                g2=tg2, count=0)), True)
            assert got == want, (arch, smoke, factored)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_axes_equal_jax(arch):
    from repro.models import init_caches as j_init_caches
    from repro_torch.models.model import init_caches
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    for page in (None, 4):
        jc = jax.eval_shape(lambda: j_init_caches(
            2, 16, jcfg, page_size=page, num_pages=8 if page else None))
        tc = init_caches(2, 16, cfg, page_size=page,
                         num_pages=8 if page else None, device="meta")
        want = _flat_axes(jps.cache_logical_axes(jc), False)
        got = _flat_axes(tps.cache_logical_axes(tc), True)
        assert got == want, (arch, page)
        mesh = DuckMesh({"data": 2, "model": 2})
        rules = tsh.serving_rules(cfg, mesh)
        for key, axes in got.items():
            assert tsh.spec_for(axes, mesh, rules) == tuple(
                jsh.spec_for(axes, mesh, rules)), (arch, key)


def test_batch_shardings_equal_jax():
    mesh = DuckMesh({"pod": 2, "data": 2, "model": 2})
    batch = {"tokens": np.zeros((8, 4)), "labels": np.zeros((8, 4)),
             "patches": np.zeros((8, 3, 2))}
    got = tps.batch_shardings(batch, mesh)
    for k, v in batch.items():
        assert got[k] == tuple(jsh.spec_for(("batch",) + (None,) * (
            v.ndim - 1), mesh))


# ---------------------------------------------------------------------------
# a rank's local tree


def _port_params(arch, shard=None):
    from repro_torch.models.model import init_params
    from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
    enc = lns_leaf_encoder(MadamConfig(update_format=LNSFormat(8, 8)))
    return init_params(get_smoke_config(arch), device="cpu", leaf_fn=enc,
                       shard=shard)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["gemma3-12b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_local_shard_draw_equals_sliced_whole_tree(arch, shape):
    cfg = get_smoke_config(arch)
    whole = _port_params(arch)
    full = dict(_leaves(whole))
    for r in range(shape[0] * shape[1]):
        mesh = Mesh({"data": shape[0], "model": shape[1]}, r, "cpu")
        rules = tsh.serving_rules(cfg, mesh)
        want = dict(_leaves(tps.shard_tree(whole, mesh, rules)))
        got = dict(_leaves(_port_params(arch, tps.LocalShard(mesh, rules))))
        assert got.keys() == want.keys()
        sharded = 0
        for k, w in want.items():
            g = got[k]
            if isinstance(w, LNSWeight):
                assert torch.equal(g.packed, w.packed), (r, k)
                assert torch.equal(g.scale, w.scale), (r, k)
                sharded += g.packed.shape != full[k].packed.shape
            else:
                assert torch.equal(g, w), (r, k)
        assert sharded > 0
    up = tps.shard_tree(whole, Mesh({"data": 1, "model": 4}, 3, "cpu"),
                        tsh.serving_rules(cfg, DuckMesh(
                            {"data": 1, "model": 4})))
    if arch == "kimi-k2-1t-a32b":
        w = up["period"]["pos0"]["moe"]["w_up"]
        assert w.packed.shape[1] == cfg.num_experts // 4
        assert torch.equal(w.packed, whole["period"]["pos0"]["moe"]["w_up"]
                           .packed[:, 6:8])


def test_local_shape_and_refusal():
    mesh = Mesh({"data": 2, "model": 2}, 3, "cpu")
    assert mesh.coords == {"data": 1, "model": 1}
    assert tps.local_shape((8, 6), ("model", None), mesh) == (4, 6)
    assert tps.local_shape((8, 6), (("data", "model"), None), mesh) == (2, 6)
    t = torch.arange(48).reshape(8, 6)
    assert torch.equal(tps.shard_leaf(t, (("data", "model"), None), mesh),
                       t[6:8])
    with pytest.raises(ValueError, match="does not split"):
        tps.local_shape((6, 3), ("model", ("data",)), DuckMeshCoords())


class DuckMeshCoords(DuckMesh):
    def __init__(self):
        super().__init__({"data": 2, "model": 2})
        self.coords = {"data": 0, "model": 0}


# ---------------------------------------------------------------------------
# compression, the serving steps, the quickstart, the CLI


def test_error_feedback_update_matches_jax():
    from repro.core.lns import LNSFormat as JFormat
    from repro.optim.compression import error_feedback_update as j_efu
    from repro_torch.optim.compression import error_feedback_update
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((16, 32)).astype(np.float32) * 3,
         "b": [rng.standard_normal(7).astype(np.float32)]}
    r = {"w": rng.standard_normal((16, 32)).astype(np.float32) * 1e-2,
         "b": [np.zeros(7, np.float32)]}
    jq, jr = j_efu(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r),
                   JFormat(bits=8, gamma=8))
    as_t = lambda t: {"w": torch.from_numpy(t["w"]),
                      "b": [torch.from_numpy(t["b"][0])]}
    tq, tr = error_feedback_update(as_t(g), as_t(r), LNSFormat(8, 8))
    for key in ("w", "b"):
        pick = (lambda t: t[key]) if key == "w" else (lambda t: t[key][0])
        a, b = pick(tq).numpy(), np.asarray(pick(jq))
        loc = pick(g) + pick(r)
        s = 2.0 ** np.ceil(np.log2(np.abs(loc).max()))
        code = lambda v: np.round(-np.log2(np.maximum(np.abs(v) / s,
                                                      2.0 ** -40)) * 8)
        np.testing.assert_array_equal(code(a), code(b))
        np.testing.assert_array_equal(np.sign(a), np.sign(b))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        np.testing.assert_allclose(pick(tr).numpy(), np.asarray(pick(jr)),
                                   rtol=0, atol=1e-6)


def test_prefill_then_decode_serving_matches_jax():
    from repro.kernels import dispatch as jd
    from repro.core.quantizer import QuantConfig as JQ
    from repro.models import init_caches as j_init_caches
    from repro.optim.madam import MadamConfig as JM
    from repro.training import build_decode_step as j_decode
    from repro.training import build_prefill_step as j_prefill
    from repro.training import init_train_state
    from repro_torch.convert import params_from_flat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.model import init_caches
    from repro_torch.training.steps import (build_decode_step,
                                            build_prefill_step)
    jcfg, cfg = j_smoke("gemma3-12b"), get_smoke_config("gemma3-12b")
    jm = JM()
    state = init_train_state(jax.random.PRNGKey(0), jcfg, jm)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                              jcfg.vocab_size)
    with jd.configured(backend="reference"):
        jp = jax.jit(j_prefill(jcfg, JQ.lns_madam(), jm))(
            state.params, {"tokens": toks})
        jdl, _ = jax.jit(j_decode(jcfg, JQ.lns_madam(), jm))(
            state.params, j_init_caches(2, 24, jcfg), {"tokens": toks},
            jnp.asarray(0, jnp.int32))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        flat["::".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)] = np.array(leaf)
    uf = jm.update_format
    params = params_from_flat(flat, LNSFormat(uf.bits, uf.gamma),
                              device="cpu")
    qcfg = QuantConfig.lns_madam()
    tok = np.asarray(toks)
    tp = build_prefill_step(cfg, qcfg)(params, {"tokens": tok})
    caches = init_caches(2, 24, cfg, device="cpu")
    td, back = build_decode_step(cfg, qcfg)(params, caches, {"tokens": tok},
                                            0)
    cursors = [leaf for path, leaf in _leaves(caches) if path[-1] == "idx"]
    assert back is caches and all(bool((c == 12).all()) for c in cursors)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jdl), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), td.numpy(), rtol=5e-2, atol=5e-2)


def _run(argv, timeout=120, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")]))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        env.pop(k, None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + argv, env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_quickstart_runs_its_four_steps():
    t0 = time.monotonic()
    out = _run([str(ROOT / "examples" / "quickstart_torch.py"), "--device",
                "cpu"])
    took = time.monotonic() - t0
    assert out.returncode == 0, out.stderr
    for marker in ("Q_log(x)", "qeinsum max |err|", "step 9: loss",
                   "bit-exact datapath (plain)", "ok"):
        assert marker in out.stdout
    assert took < 20, took


def test_serve_cli_mesh_of_one_and_refusal():
    base = ["-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--prompt-len", "8",
            "--gen-len", "6", "--page-size", "4"]
    alone = _run(base)
    one = _run(base + ["--mesh", "1,1"])
    assert alone.returncode == 0 and one.returncode == 0, one.stderr
    samples = lambda o: [ln for ln in o.stdout.splitlines()
                         if "new tokens, sample" in ln]
    assert samples(one) == samples(alone) and len(samples(one)) == 3
    assert "mesh 1,1" in one.stdout
    refused = _run(base + ["--mesh", "2,2"])
    assert refused.returncode != 0
    assert "torchrun" in refused.stderr
