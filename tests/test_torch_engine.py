"""The port's serving engine against the JAX package's on one synthetic
trace (the smollm smoke config, the same packed weights), in the dense
and the paged (``page_size=4``) KV layouts, the paged one under both
page policies (reserve, ondemand).

Both engines batch the same way (admission order, buckets, idle rows
decoding), so the greedy token streams are held equal outright: the
margin rule of test_torch_model only spares a step whose JAX top-2 margin
is under the 1e-5 logit tolerance, and with the logits agreeing to ~1e-7
on this trace no step needs it. Every request completes and the slot and
page bookkeeping ends empty.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import dispatch as jd  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import synthetic_trace as j_trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.serving import Engine, synthetic_trace  # noqa: E402

from test_torch_model import flat_params, jax_smoke  # noqa: E402

TRACE = dict(requests=5, prompt_len=12, gen_len=8, lengths="uniform",
             seed=3)


@pytest.fixture(scope="module")
def smoke():
    return jax_smoke()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(engine):
    return {rs.request.rid: list(rs.generated) for rs in engine.finished}


@pytest.mark.parametrize("page_size,alloc_policy", [
    pytest.param(None, "reserve", id="None"),
    pytest.param(4, "reserve", id="4"),
    pytest.param(4, "ondemand", id="4-ondemand"),
])
def test_engine_streams_match_jax(smoke, page_size, alloc_policy):
    cfg, qcfg, mcfg, params = smoke
    kw = dict(num_slots=3, max_len=40, page_size=page_size,
              alloc_policy=alloc_policy)
    with jd.configured(backend="reference"):
        jeng = JEngine(cfg, qcfg, mcfg, params, prefix_cache=False, **kw)
        jagg = jeng.run(j_trace(cfg, **TRACE))
    teng = Engine(get_smoke_config("smollm-135m"), QuantConfig.lns_madam(),
                  params_from_flat(flat_params(params), LNSFormat(8, 8),
                                   device="cpu"), device="cpu",
                  prefix_cache=False, **kw)
    tagg = teng.run(synthetic_trace(teng.cfg, **TRACE))

    assert jagg["completed"] == tagg["completed"] == TRACE["requests"]
    assert teng.decode_steps == jeng.decode_steps
    assert teng.preemptions == jeng.preemptions
    assert teng.decode_page_allocs == jeng.decode_page_allocs
    js, ts = _streams(jeng), _streams(teng)
    assert js.keys() == ts.keys()
    mismatched = [rid for rid in js if js[rid] != ts[rid]]
    assert not mismatched, (
        f"greedy streams differ for requests {mismatched}")

    assert not teng.scheduler.running and not teng.queue
    assert teng.scheduler.free_slots == teng.num_slots
    if page_size:
        assert teng.allocator.in_use == 0
        assert teng.allocator.free == teng.num_pages
        assert (teng._block_tables == teng._null_page).all()


@pytest.mark.parametrize("top_k", [0, 5])
def test_seeded_sampling_replays(smoke, top_k):
    """Seeded sampling replays token for token within the port (the
    gumbel noise is a counter-based hash of (seed, step, token id),
    ``ref.gumbel_noise``); the top-k leg takes the plain sort path with
    that noise, the temperature-only leg K6's seeded plain version. Token
    equality with JAX's seeded stream is not claimed: the two frameworks
    draw different noise."""
    from repro_torch.server.sampling import SamplingParams

    _, _, _, params = smoke
    cfg = get_smoke_config("smollm-135m")
    tp = params_from_flat(flat_params(params), LNSFormat(8, 8), device="cpu")

    def run():
        eng = Engine(cfg, QuantConfig.lns_madam(), tp, num_slots=2,
                     max_len=24, device="cpu")
        trace = synthetic_trace(cfg, requests=3, prompt_len=6, gen_len=6,
                                seed=5)
        for i, r in enumerate(trace):
            r.sampling = SamplingParams(temperature=0.9, top_k=top_k,
                                        seed=100 + i)
        eng.run(trace)
        return _streams(eng)

    first, second = run(), run()
    assert first == second
    assert len({tuple(s) for s in first.values()}) > 1


def _rows(n, over=None):
    """``n`` sampled rows (temperature 0.8, seed 42, step 6); ``over``
    maps a row to more SamplingParams fields."""
    from repro_torch.server.sampling import (SamplingParams, sampling_rows,
                                             set_row)
    rows = sampling_rows(n)
    for b in range(n):
        set_row(rows, b, SamplingParams(temperature=0.8, seed=42,
                                        **(over or {}).get(b, {})))
        rows["step"][b] = 6
    return rows


def test_masked_and_unmasked_rows_draw_the_same_noise():
    """Two rows with the same seed, step and logits, one sort-free (top-k
    0) and one through the masked sort path (top-k = V keeps every
    token): the same token, since the noise is indexed by token id. And a
    row's token does not depend on whether a masked neighbour sends the
    batch down the sort path."""
    from repro_torch.server.sampling import sample_logits
    rows = _rows(2, {1: dict(top_k=64)})
    rng = np.random.default_rng(8)
    V = 64
    for trial in range(20):
        one = torch.from_numpy(rng.standard_normal((1, V)).astype(np.float32))
        lg = one.repeat(2, 1)
        rows["step"][:] = trial
        toks = sample_logits(lg, rows)
        assert toks[0] == toks[1]
        alone = {k: v[:1] for k, v in rows.items()}
        assert sample_logits(one, alone)[0] == toks[0]


def test_sample_logits_draws_ref_gumbel_noise():
    """A temperature-only batch is the seeded K6 on ``ref.gumbel_noise``;
    ``step_offset`` shifts the counter as the verify does, so a verify
    row at offset j samples what step + j samples."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.server.sampling import sample_logits
    rows = _rows(3)
    rows["seed"][:] = [1, 2, 3]
    rows["step"][:] = [0, 4, 9]
    rng = np.random.default_rng(9)
    lg = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    noise = ref.gumbel_noise(rows["seed"], rows["step"], 50)
    want = dispatch.fused_sample(lg, noise, torch.from_numpy(rows["temp"]))
    assert torch.equal(sample_logits(lg, rows), want)
    shifted = sample_logits(lg, rows, step_offset=np.array([2, 0, 1]))
    moved = {k: v.copy() for k, v in rows.items()}
    moved["step"] += np.array([2, 0, 1], np.int32)
    assert torch.equal(shifted, sample_logits(lg, moved))
