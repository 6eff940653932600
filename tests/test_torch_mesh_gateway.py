"""The gateway on a mesh on the CPU: ``launch.serve``'s ``--http`` path
over gloo ranks, the parent process as the HTTP client.

One spawn of a ``(2, 2)`` mesh serves smollm-smoke, carried from JAX's
packed 8-bit tree (``convert.params_from_flat``), each rank slicing its
shard; the engine is paged on demand with speculation k = 2. Rank 0 runs
``launch.serve.run_http``'s gateway on ``127.0.0.1:0`` and hands its
address to the parent through the spawn's temporary directory; every
other rank follows. The cases:

* streams: six streamed completions, one after another (a row's tokens
  depend on what shares its batch, so each runs alone as in the
  reference), equal JAX's ``Engine`` on the same requests in the same
  order (greedy rows) and the port's one-device engine (seeded rows,
  ROADMAP H4);
* an idle second between requests, the ranks stepping through it;
* ``/health``: ``mesh == {"data": 2, "model": 2}`` and the whole tree's
  numerics equal to the one-device engine's (counts and code shares
  exact, the draft view's mean error within 1e-5 relative: its sums
  split over the ranks add in another order); ``/metrics`` carries the
  mesh label as JAX's driver writes it;
* a DELETE mid-stream gives ``aborted``; 429 at the watermark;
* a clean stop: SIGINT to every rank, as torchrun passes it; every rank
  exits 0 within 60 s with every page back and as many step broadcasts
  as rank 0.

A second spawn, of a ``(1, 2)`` mesh, takes a fatal step on rank 0 (an
injected fault once a flag file exists and a request waits): the stream
ends in ``error``, and both ranks exit non-zero within 60 s (rank 0 by
``run_http``'s exit, the follower on its dead peer). Also ``--http
--mesh 1,1`` runs without torchrun (a subprocess, stopped by SIGINT,
exit 0), and ``--http --mesh 2,2`` without torchrun raises.
"""
import os
import pickle
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gateway import _client, _http, _json, _stream  # noqa: E402

MAX_LEN, MAX_QUEUE = 48, 3
KW = dict(num_slots=3, page_size=4, num_pages=24, alloc_policy="ondemand",
          speculate_k=2, draft_bitwidth=6)
EXIT_S = 60


def _bodies(vocab):
    """Six completions: greedy and seeded interleaved, two of them on one
    prompt (the second reuses the first's pages)."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(6):
        prompt = rng.integers(1, vocab, (5 + 2 * i,)).tolist()
        if i == 3:
            prompt = out[1]["prompt"]
        body = {"prompt": prompt, "max_tokens": 4 + i % 3}
        if i % 2:
            body.update(temperature=0.8, top_k=40, seed=300 + i)
        out.append(body)
    return out


def _engine(flat, mesh):
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_flat
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.serving import Engine
    cfg = get_smoke_config("smollm-135m")
    params = params_from_flat(flat, LNSFormat(8, 8), device="cpu")
    return cfg, Engine(cfg, QuantConfig.lns_madam(), params,
                       max_len=MAX_LEN, mesh=mesh,
                       device=None if mesh else "cpu", **KW)


def _port_requests(bodies):
    from repro_torch.server.sampling import SamplingParams
    from repro_torch.serving import Request
    return [Request(rid=i, prompt=b["prompt"], max_new_tokens=b["max_tokens"],
                    sampling=SamplingParams(temperature=b["temperature"],
                                            top_k=b["top_k"], seed=b["seed"])
                    if "seed" in b else None)
            for i, b in enumerate(bodies)]


# ---------------------------------------------------------------------------
# the ranks (no JAX is imported here)


def _rank(r, n, store, shape, flat, out_dir, fatal):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=n)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import run_http
    mesh = make_host_mesh(*shape, device="cpu")
    cfg, eng = _engine(flat, mesh)
    if fatal and mesh.rank == 0:
        real, flag = eng._step, Path(out_dir) / "fatal"

        def step(now, ready):
            if flag.exists() and eng.queue:
                raise RuntimeError("injected fault")
            return real(now, ready)
        eng._step = step

    def ready(host, port):
        tmp = Path(out_dir) / "addr.tmp"
        tmp.write_text(f"{host}:{port}")
        tmp.rename(Path(out_dir) / "addr")

    run_http(eng, "127.0.0.1:0", cfg.name, MAX_QUEUE, ready=ready)
    out = {"free": eng.allocator.available, "pages": eng.num_pages,
           "running": len(eng.scheduler.running), "queued": len(eng.queue),
           "syncs": eng.mesh_syncs}
    with open(Path(out_dir) / f"rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _spawn(d, shape, flat, fatal):
    import torch.multiprocessing as mp
    n = shape[0] * shape[1]
    sub = Path(d) / ("fatal" if fatal else "serve")
    sub.mkdir()
    ctx = mp.start_processes(_rank, args=(n, f"{sub}/store", shape, flat,
                                          str(sub), fatal),
                             nprocs=n, join=False, start_method="spawn")
    return sub, ctx


def _address(sub, ctx, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if (sub / "addr").exists():
            host, port = (sub / "addr").read_text().rsplit(":", 1)
            return host, int(port)
        assert all(p.exitcode is None for p in ctx.processes), \
            "a rank ended before the gateway listened"
        time.sleep(0.05)
    raise AssertionError("the gateway never listened")


def _exits(ctx, timeout=EXIT_S):
    """Each rank's exit code, waiting at most ``timeout`` s in all; a
    rank still running then is killed and reported as None."""
    deadline = time.monotonic() + timeout
    codes = []
    for p in ctx.processes:
        p.join(max(deadline - time.monotonic(), 0.1))
        if p.exitcode is None:
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


# ---------------------------------------------------------------------------
# the parent


@pytest.fixture(scope="module")
def gateway_run():
    """Both spawns, the client's session on each, JAX's and the port's
    references. Returns a dict of what the tests read."""
    import jax
    from repro.configs import get_smoke_config
    from repro.core.lns import LNSFormat
    from repro.core.quantizer import QuantConfig
    from repro.kernels import dispatch as jd
    from repro.optim.madam import MadamConfig
    from repro.server.sampling import SamplingParams
    from repro.serving import Engine, Request
    from repro.training import init_train_state
    from test_torch_model import flat_params
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = get_smoke_config("smollm-135m")
    mcfg = MadamConfig(update_format=LNSFormat(bits=8, gamma=8))
    jparams = jax.jit(lambda k: init_train_state(k, cfg, mcfg).params)(
        jax.random.PRNGKey(0))
    flat = flat_params(jparams)
    bodies = _bodies(cfg.vocab_size)
    res = {"bodies": bodies}
    with tempfile.TemporaryDirectory() as d:
        sub, ctx = _spawn(d, (2, 2), flat, fatal=False)
        fsub, fctx = _spawn(d, (1, 2), flat, fatal=True)
        # the references, one request after another as the client sends
        with jd.configured(backend="reference"):
            jeng = Engine(cfg, QuantConfig.lns_madam(), mcfg, jparams,
                          max_len=MAX_LEN, **KW)
            for i, b in enumerate(bodies):
                jeng.run([Request(
                    rid=i, prompt=b["prompt"], max_new_tokens=b["max_tokens"],
                    sampling=SamplingParams(temperature=b["temperature"],
                                            top_k=b["top_k"], seed=b["seed"])
                    if "seed" in b else None)])
        res["jax"] = {rs.request.rid: list(rs.generated)
                      for rs in jeng.finished}
        _, teng = _engine(flat, None)
        for req in _port_requests(bodies):
            teng.run([req])
        res["port"] = {rs.request.rid: list(rs.generated)
                       for rs in teng.finished}
        res["numerics"] = teng.numerics_snapshot()

        host, port = _address(sub, ctx)
        res["streams"] = []
        for i, b in enumerate(bodies):
            if i == 3:
                time.sleep(1.2)          # idle: the ranks keep stepping
            status, toks, _, reason, _ = _client(_stream(host, port, b))
            res["streams"].append((status, toks, reason))
        res["health"] = _json(_client(_http(host, port, "GET", "/health")))
        res["metrics"] = _client(_http(host, port, "GET", "/metrics"))
        long = {"prompt": bodies[0]["prompt"], "max_tokens": 30}
        res["delete"] = _client(_stream(host, port, long, delete_after=4))

        async def over_watermark():
            import asyncio
            streams = [asyncio.ensure_future(_stream(
                host, port, {**long, "max_tokens": 16}))
                for _ in range(MAX_QUEUE)]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                _, st = _json(await _http(host, port, "GET",
                                          "/metrics.json"))
                if st["inflight"] >= MAX_QUEUE:
                    break
                await asyncio.sleep(0.01)
            over = await _http(host, port, "POST", "/v1/completions", long)
            return over, await asyncio.gather(*streams)
        res["over"] = _client(over_watermark())
        res["after"] = _json(_client(_http(host, port, "GET",
                                           "/metrics.json")))
        for p in ctx.processes:           # as torchrun passes Ctrl-C on
            os.kill(p.pid, signal.SIGINT)
        t0 = time.monotonic()
        res["exits"] = _exits(ctx)
        res["exit_s"] = time.monotonic() - t0
        res["ranks"] = [pickle.loads((sub / f"rank{r}.pkl").read_bytes())
                        for r in range(4) if (sub / f"rank{r}.pkl").exists()]

        fhost, fport = _address(fsub, fctx)
        (fsub / "fatal").write_text("1")
        res["fatal_stream"] = _client(_stream(fhost, fport,
                                              {"prompt": [1, 2, 3],
                                               "max_tokens": 8}))
        t0 = time.monotonic()
        res["fatal_exits"] = _exits(fctx)
        res["fatal_s"] = time.monotonic() - t0
    torch.set_num_threads(threads)
    return res


def test_streams_equal_jax_and_one_device(gateway_run):
    res = gateway_run
    for i, (body, (status, toks, reason)) in enumerate(
            zip(res["bodies"], res["streams"])):
        assert status == 200 and reason == "length", i
        assert toks == res["port"][i], f"request {i} left the one-device " \
                                       f"engine's stream"
        if "seed" not in body:
            assert toks == res["jax"][i], f"greedy request {i} left JAX's"


def test_health_carries_mesh_and_whole_tree_numerics(gateway_run):
    status, health = gateway_run["health"]
    assert status == 200 and health["status"] == "ok"
    assert health["mesh"] == {"data": 2, "model": 2}
    got, want = health["numerics"], gateway_run["numerics"]
    assert got["weights"] == want["weights"]
    assert got["draft_requant"].keys() == want["draft_requant"].keys() \
        == {"b6"}
    for k, w in want["draft_requant"]["b6"].items():
        g = got["draft_requant"]["b6"][k]
        if k == "rel_err_mean":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            assert g == w, k


def test_metrics_carry_the_mesh_label_as_jax_writes_it(gateway_run):
    """The build-info line's ``mesh`` label, rendered by JAX's
    ``render_prometheus`` from the same label value its driver makes."""
    from repro.obs.prom import render_prometheus
    status, text = gateway_run["metrics"]
    assert status == 200
    line = next(ln for ln in text.decode().splitlines()
                if ln.startswith("repro_build_info{"))
    want = render_prometheus({}, (), {"mesh": ",".join(
        f"{k}={v}" for k, v in {"data": 2, "model": 2}.items())})
    label = re.search(r'mesh="[^"]*"', want).group(0)
    assert label == 'mesh="data=2,model=2"' and label in line


def test_delete_and_429(gateway_run):
    status, toks, _, reason, _ = gateway_run["delete"]
    assert status == 200 and reason == "aborted" and 4 <= len(toks) < 30
    over, streams = gateway_run["over"]
    assert _json(over)[0] == 429
    assert all(s[0] == 200 and s[3] == "length" for s in streams)
    _, after = gateway_run["after"]
    assert after["aborted_total"] == 1 and after["inflight"] == 0


def test_clean_stop_every_rank_exits_0_with_pages_back(gateway_run):
    res = gateway_run
    assert res["exits"] == [0, 0, 0, 0], res["exits"]
    assert res["exit_s"] < EXIT_S
    assert len(res["ranks"]) == 4
    for r in res["ranks"]:
        assert r["free"] == r["pages"]
        assert r["running"] == r["queued"] == 0
        # every broadcast rank 0 made was taken by every rank; the idle
        # second alone holds tens of them (one a 20 ms poll)
        assert r["syncs"] == res["ranks"][0]["syncs"] > 50


def test_fatal_step_ends_every_rank_nonzero(gateway_run):
    status, toks, _, reason, _ = gateway_run["fatal_stream"]
    assert status == 200 and reason == "error" and toks == []
    codes = gateway_run["fatal_exits"]
    assert None not in codes, f"a rank hung after the fatal step: {codes}"
    assert all(c != 0 for c in codes), codes
    assert gateway_run["fatal_s"] < EXIT_S


def test_http_on_a_one_rank_mesh_runs_without_torchrun():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(Path(__file__).resolve().parents[1] / "src"),
                    os.environ.get("PYTHONPATH", "")]))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--mesh", "1,1", "--page-size", "4",
         "--http", "127.0.0.1:0"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"listening on http://([\d.]+):(\d+)", line)
            if m:
                break
        assert m, "".join(lines)
        status, obj = _json(_client(_http(m.group(1), int(m.group(2)),
                                          "POST", "/v1/completions",
                                          {"prompt": [1, 2, 3],
                                           "max_tokens": 3})))
        assert status == 200 and len(obj["choices"][0]["token_ids"]) == 3
        _, health = _json(_client(_http(m.group(1), int(m.group(2)), "GET",
                                        "/health")))
        assert health["mesh"] == {"data": 1, "model": 1}
        proc.send_signal(signal.SIGINT)
        assert proc.wait(EXIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_http_on_a_larger_mesh_without_torchrun_raises(monkeypatch):
    from repro_torch.launch import serve
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "2,2",
                    "--http", "127.0.0.1:0"])
