"""Mesh serving of the recurrent families on the CPU: gloo ranks stand in
for the cards.

rwkv6-smoke and zamba2-smoke, carried from JAX's packed 8-bit tree
(``convert.params_from_flat``; zamba2's ``lora_b``, zero at JAX's init,
is given random words first so the LoRA path moves the weights), are
served by the port's ``Engine(mesh=)`` on a ``(1, 2)`` and a ``(2, 2)``
mesh, each rank slicing its shard: rwkv6 with ``page_size`` given, which
stays dense; zamba2 paged on demand. The cases:

* streams: the greedy rows of a mixed trace equal JAX's single-device
  ``Engine`` stream for stream, the seeded rows the port's one-device
  engine (ROADMAP H4: the port's seeded noise is its own); every rank's
  streams equal rank 0's;
* placements, by local shape: rwkv6's ``ck`` and zamba2's shared
  ``up``/``gate`` are column blocks, ``cv``/``down`` whole; zamba2's
  shared ``wq``/``wk``/``wv`` and every ``lora_a``/``lora_b`` are whole
  on every rank (``params_sharding.kept_whole``: the merged QKV runs at
  the whole width and the rank keeps its heads), while its pools hold
  the rank's KV heads;
* ``_lora_qkv`` on ``wq``/``wk``/``wv`` column blocks (the ``qkv_out``
  placement) merges exactly one device's columns of the rank's heads;
* state: after the run every rank's ``S``/``shift_*`` (rwkv6) and
  ``ssm``/``conv_*`` (zamba2) rows equal the one-device engine's;
* abort: a running zamba2 request aborted on rank 0 returns every page
  on every rank;
* speculation is still refused for both families on a mesh.

Tolerances: tokens, pages, shapes, weights and states exact.
"""
import pickle
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MAX_LEN = 32
ARCHS = ("rwkv6-1.6b", "zamba2-7b")
KW = {"rwkv6-1.6b": dict(num_slots=3, page_size=8, num_pages=4),
      "zamba2-7b": dict(num_slots=3, page_size=8, num_pages=12,
                        alloc_policy="ondemand")}
MESHES = ((1, 2), (2, 2))
STATE_KEYS = ("S", "shift_tm", "shift_cm", "ssm", "conv_x", "conv_b",
              "conv_c")


def _trace(vocab: int, n: int = 5, seed: int = 0):
    """``(rid, prompt, max_new, (temp, top_k, seed) or None)``: two prompt
    lengths (a recurrent prefill runs at the exact length), greedy and
    seeded rows interleaved, more requests than slots."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, vocab, (4 + 3 * (i % 2),)).tolist(),
             5 + i % 3, (0.8, 40, 500 + i) if i % 2 else None)
            for i in range(n)]


def _requests(vocab):
    from repro_torch.server.sampling import SamplingParams
    from repro_torch.serving import Request
    return [Request(rid=i, prompt=p, max_new_tokens=m,
                    sampling=None if s is None else SamplingParams(
                        temperature=s[0], top_k=s[1], seed=s[2]))
            for i, p, m, s in _trace(vocab)]


def _streams(eng):
    return {rs.request.rid: list(rs.generated)
            for rs in eng.finished + eng.aborted}


def _engine(arch, flat, mesh, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_flat
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.serving import Engine
    cfg = get_smoke_config(arch)
    params = params_from_flat(flat, LNSFormat(8, 8), device="cpu")
    return cfg, Engine(cfg, QuantConfig.lns_madam(), params,
                       max_len=MAX_LEN, mesh=mesh,
                       device=None if mesh else "cpu", **kw)


def _states(eng):
    """Every recurrent state leaf of the engine's caches, as numpy."""
    out = {}
    for group, caches in (("prefix", enumerate(eng.caches.get("prefix",
                                                              ()))),
                          ("period", eng.caches.get("period", {}).items())):
        for key, c in caches:
            for name in STATE_KEYS:
                if name in c:
                    out[(group, key, name)] = c[name].numpy().copy()
    return out


# ---------------------------------------------------------------------------
# the ranks (no JAX is imported here)


def _rank(r, n, store, shape, flats, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=n)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device="cpu")
    root = mesh.rank == 0
    out = {"streams": {}, "states": {}, "pages_back": {}}
    for arch in ARCHS:
        cfg, eng = _engine(arch, flats[arch], mesh, **KW[arch])
        eng.run(_requests(cfg.vocab_size) if root else ())
        out["streams"][arch] = _streams(eng)
        out["states"][arch] = _states(eng)
        out["pages_back"][arch] = (eng.allocator is None or
                                   eng.allocator.available == eng.num_pages)
        out.setdefault("paged", {})[arch] = eng.page_size
        if arch == "rwkv6-1.6b":
            rw = eng.params["period"]["pos0"]["rwkv"]
            out["ck"] = tuple(rw["ck"].packed.shape)
            out["cv"] = tuple(rw["cv"].packed.shape)
        else:
            sh = eng.params["shared"]
            out["shared"] = {k: tuple(sh[g][k].packed.shape)
                             for g, ks in (("attn", ("wq", "wk", "wv")),
                                           ("mlp", ("up", "gate", "down")))
                             for k in ks}
            pos = next(k for k, c in eng.caches["period"].items()
                       if "kp" in c)
            lora = eng.params["period"][pos]
            out["lora"] = (tuple(lora["lora_a"].packed.shape),
                           tuple(lora["lora_b"].packed.shape))
            out["pool"] = tuple(eng.caches["period"][pos]["kp"].shape)
    # abort: one running zamba2 request, then drain; every page comes back
    cfg, eng = _engine("zamba2-7b", flats["zamba2-7b"], mesh,
                       **KW["zamba2-7b"])
    if root:
        for req in _requests(cfg.vocab_size)[:4]:
            eng.submit(req)
    for _ in range(3):
        eng.step()
    running = sorted(rs.request.rid for rs in eng.scheduler.running.values())
    if root:
        eng.abort(running[0])
    eng.run(())
    out["abort"] = dict(running=running,
                        aborted=[rs.request.rid for rs in eng.aborted],
                        pages_back=eng.allocator.available == eng.num_pages)
    with open(Path(out_dir) / f"rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: JAX's side, the port's one-device engines, one spawn a shape


def _perturb_lora(params, flat_params):
    """zamba2's ``lora_b`` with random words (a sign and a code of at
    most 2^-1 of the scale) at scale 0.25, in JAX's tree."""
    import jax
    rng = np.random.default_rng(11)

    def one(path, leaf):
        key = "::".join(str(getattr(k, "key", getattr(k, "idx",
                                                      getattr(k, "name", k))))
                        for k in path)
        if "lora_b::packed" in key:
            words = rng.integers(8, 128, leaf.shape) | (
                rng.integers(0, 2, leaf.shape) << 7)
            return jax.numpy.asarray(words.astype(np.uint8))
        if "lora_b::scale" in key:
            return jax.numpy.full(leaf.shape, 0.25, leaf.dtype)
        return leaf
    params = jax.tree_util.tree_map_with_path(one, params)
    return params, flat_params(params)


@pytest.fixture(scope="module")
def mesh_run():
    """JAX's draws carried, one spawn of gloo ranks a mesh shape started
    at once; JAX's engines and the port's one-device engines run here
    meanwhile. Returns ``(flats, jax streams, port engines, per-rank
    results by shape)``."""
    import jax
    import torch.multiprocessing as mp
    from repro.configs import get_smoke_config
    from repro.core.lns import LNSFormat
    from repro.core.quantizer import QuantConfig
    from repro.kernels import dispatch as jd
    from repro.optim.madam import MadamConfig
    from repro.server.sampling import SamplingParams
    from repro.serving import Engine, Request
    from repro.training import init_train_state
    from test_torch_model import flat_params
    mcfg = MadamConfig(update_format=LNSFormat(bits=8, gamma=8))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    params, flats = {}, {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params[arch] = jax.jit(lambda k: init_train_state(k, cfg, mcfg)
                               .params)(jax.random.PRNGKey(0))
        flats[arch] = flat_params(params[arch])
    params["zamba2-7b"], flats["zamba2-7b"] = _perturb_lora(
        params["zamba2-7b"], flat_params)
    with tempfile.TemporaryDirectory() as d:
        procs = {}
        for shape in MESHES:
            n = shape[0] * shape[1]
            sub = Path(d) / f"{shape[0]}x{shape[1]}"
            sub.mkdir()
            procs[shape] = (n, sub, mp.start_processes(
                _rank, args=(n, f"{sub}/store", shape, flats, str(sub)),
                nprocs=n, join=False, start_method="spawn"))
        want, port = {}, {}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            with jd.configured(backend="reference"):
                eng = Engine(cfg, QuantConfig.lns_madam(), mcfg,
                             params[arch], max_len=MAX_LEN, **KW[arch])
                eng.run([Request(
                    rid=i, prompt=p, max_new_tokens=m,
                    sampling=None if s is None else SamplingParams(
                        temperature=s[0], top_k=s[1], seed=s[2]))
                    for i, p, m, s in _trace(cfg.vocab_size)])
            want[arch] = {rs.request.rid: list(rs.generated)
                          for rs in eng.finished}
            tcfg, teng = _engine(arch, flats[arch], None, **KW[arch])
            teng.run(_requests(tcfg.vocab_size))
            port[arch] = teng
        out = {}
        for shape, (n, sub, ctx) in procs.items():
            while not ctx.join():
                pass
            out[shape] = [pickle.loads((sub / f"rank{r}.pkl").read_bytes())
                          for r in range(n)]
    torch.set_num_threads(threads)
    return flats, want, port, out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_streams_equal_jax_and_one_device(mesh_run, shape, arch):
    _, want, port, ranks = mesh_run
    from repro_torch.configs import get_smoke_config
    trace = _trace(get_smoke_config(arch).vocab_size)
    greedy = {i for i, _, _, s in trace if s is None}
    one = _streams(port[arch])
    assert len(one) == len(trace)
    for r, res in enumerate(ranks[shape]):
        got = res["streams"][arch]
        assert got == one, (shape, arch, r)
        assert got == ranks[shape][0]["streams"][arch]
        for rid in greedy:
            assert got[rid] == want[arch][rid], (shape, arch, r, rid)
        assert res["pages_back"][arch]
        assert res["paged"][arch] == port[arch].page_size


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_recurrent_state_equals_one_device(mesh_run, shape, arch):
    _, _, port, ranks = mesh_run
    want = _states(port[arch])
    assert want, "no recurrent state: the harness is broken"
    for r, res in enumerate(ranks[shape]):
        got = res["states"][arch]
        assert got.keys() == want.keys()
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w, err_msg=str(
                (shape, arch, r, key)))


@pytest.mark.parametrize("shape", MESHES)
def test_placements_by_local_shape(mesh_run, shape):
    """model = 2: rwkv6's ``ck`` holds 80 of d_ff 160 columns and ``cv``
    all 160 rows; zamba2's shared ``up``/``gate`` 80 columns, ``down``
    whole, ``wq``/``wk``/``wv`` and the LoRA leaves whole (the port's
    rule), the shared block's pools 2 of 4 KV heads; rwkv6 stays dense."""
    from repro_torch.configs import get_smoke_config
    rw, zb = get_smoke_config("rwkv6-1.6b"), get_smoke_config("zamba2-7b")
    d, f = rw.d_model, rw.d_ff
    qkv = (zb.num_heads + 2 * zb.num_kv_heads) * zb.head_dim
    for res in mesh_run[3][shape]:
        assert res["ck"] == (rw.num_layers, d, f // 2)
        assert res["cv"] == (rw.num_layers, f, d)
        assert res["paged"]["rwkv6-1.6b"] is None
        zd, zf = zb.d_model, zb.d_ff
        hd = zb.num_heads * zb.head_dim
        assert res["shared"] == {"wq": (zd, hd), "wk": (zd, hd),
                                 "wv": (zd, hd), "up": (zd, zf // 2),
                                 "gate": (zd, zf // 2), "down": (zf, zd)}
        n_occ = res["lora"][0][0]
        r = zb.shared_block_lora_rank
        assert res["lora"] == ((n_occ, zd, r), (n_occ, r, qkv))
        assert res["pool"][-2:] == (zb.num_kv_heads // 2, zb.head_dim)


@pytest.mark.parametrize("m", [2, 4])
def test_lora_qkv_blocks_are_one_devices_columns(mesh_run, m):
    """``_lora_qkv`` with ``wq``/``wk``/``wv`` as rank r's ``qkv_out``
    column blocks adds the delta's columns of r's heads in each of the
    fused [q | k | v] blocks: the merged blocks equal one device's merged
    weights restricted to those heads, bit for bit, for every rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_flat
    from repro_torch.core.lns import LNSFormat
    from repro_torch.distributed.params_sharding import shard_leaf
    from repro_torch.distributed.sharding import serving_rules, shard_ctx
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import _lora_qkv
    cfg = get_smoke_config("zamba2-7b")
    params = params_from_flat(mesh_run[0]["zamba2-7b"], LNSFormat(8, 8),
                              device="cpu")
    bp = {k: v for k, v in params["period"]["pos2"].items()
          if k.startswith("lora")}
    bp = {k: type(v)(v.packed[0], v.scale[0], v.fmt) for k, v in bp.items()}
    attn = params["shared"]["attn"]
    whole = _lora_qkv(attn, bp, cfg)
    assert not torch.equal(whole["wq"], _lora_qkv(
        attn, {**bp, "lora_b": type(bp["lora_b"])(
            torch.zeros_like(bp["lora_b"].packed), bp["lora_b"].scale,
            bp["lora_b"].fmt)}, cfg)["wq"]), "the delta is zero"
    for r in range(m):
        mesh = Mesh({"data": 1, "model": m}, r, "cpu")
        rules = serving_rules(cfg, mesh)
        block = {k: shard_leaf(v, type(v)((None, "model"), (None, "model"),
                                          v.fmt), mesh)
                 if k in ("wq", "wk", "wv") else v for k, v in attn.items()}
        with shard_ctx(mesh, rules):
            got = _lora_qkv(block, bp, cfg)
        for k in ("wq", "wk", "wv"):
            n = whole[k].shape[-1] // m
            assert got[k].shape[-1] == n
            assert torch.equal(got[k], whole[k][:, r * n:(r + 1) * n]), (m,
                                                                         r, k)


def test_abort_returns_every_page(mesh_run):
    for shape in MESHES:
        first = mesh_run[3][shape][0]["abort"]
        assert first["running"], "nothing admitted: the harness is broken"
        for res in mesh_run[3][shape]:
            assert res["abort"]["running"] == first["running"]
            assert res["abort"]["aborted"] == [first["running"][0]]
            assert res["abort"]["pages_back"]


@pytest.mark.parametrize("arch", ARCHS)
def test_speculation_still_refused_on_a_mesh(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving import Engine
    mesh = Mesh({"data": 1, "model": 2}, 0, "cpu")
    with pytest.raises(ValueError, match="recurrent layers cannot rewind"):
        Engine(get_smoke_config(arch), QuantConfig.lns_madam(), {},
               mesh=mesh, speculate_k=2)
