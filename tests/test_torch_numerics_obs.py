"""The port's ``NumericsObserver`` and training-trace contract against the
JAX package's.

* The same metrics (the same float32 values, as ``jnp`` scalars on one
  side and 0-d tensors on the other, a NaN stat among them) through both
  observers: jsonl rows (but their clocks ``t`` and ``dt_s``), the
  progress lines, ``prom_text`` byte for byte, the counter tracks (but
  ``ts``) and ``summary()`` are equal.
* ``validate_train_trace``: JAX's rejection cases on the port's validator;
  each package's export passes the other's.
* Two smoke train steps with ``numerics=True`` through each package's own
  step and observer: the packed words equal after each step, and every
  per-layer stat within the rtol of
  ``test_torch_train.test_train_step_numerics_matches_jax`` (1e-5 for the
  error and code-mean stats, 1e-6 for the rest), except the error stats
  of the second step: with the words equal, ``qerr_rel`` is an f32 sum of
  up to 32768 positive terms that the two packages add in other orders
  (their difference is bounded by (n - 1)·2^-24 ≈ 2e-3 relative; it reads
  1.1e-5 to 5.0e-5 here), so it is held to ``QERR_SUM_RTOL`` = 1e-4, the
  bound ``chip_smoke.py`` holds K4's f32 ``qerr_sum`` to against its plain
  version for the same reason.
* The port's observer moves every scalar of a step to the host in one
  transfer.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.obs.numerics import NumericsObserver as JObserver  # noqa: E402
from repro.obs.numerics import \
    validate_train_trace as j_validate  # noqa: E402
from repro_torch.obs import NumericsObserver, validate_train_trace  # noqa: E402
from repro_torch.obs import numerics as tnum  # noqa: E402
from repro_torch.obs.numerics import REQUIRED_TRAIN_COUNTERS  # noqa: E402

from test_torch_train import _run_both, _word_diffs  # noqa: E402
from test_torch_train import jax_state  # noqa: E402,F401

STAT_RTOL = {"qerr_rel": 1e-5, "qerr_gap_ratio": 1e-5, "code_mean": 1e-5}
QERR_SUM_RTOL = 1e-4


def _metrics(step, seed=0):
    """One step's metrics as float32 numpy values: two sites, three
    layers, JAX's stat keys, one NaN stat."""
    rng = np.random.default_rng(seed * 100 + step)
    f = lambda: np.float32(rng.uniform(0.0, 0.01))
    layers = ("embed.tok", "period.pos0.attn.wq", "period.pos0.mlp.down")
    upd = {layer: {"sat_lo": f(), "sat_hi": f(), "dead_frac": f(),
                   "qerr_rel": f(), "qerr_gap_ratio": f(),
                   "code_mean": np.float32(60.0 + step),
                   "requant_sat_hi": np.float32(0.0),
                   "scale_log2": np.float32(-3.0)}
           for layer in layers}
    upd[layers[1]]["requant_sat_hi"] = np.float32(np.nan)
    enc = {layer: {"sat_lo": f(), "sat_hi": f(), "scale_log2": np.float32(-7)}
           for layer in layers}
    return {"loss": np.float32(3.0 - 0.1 * step), "grad_norm": f(),
            "numerics": {"update": upd, "grad_encode": enc}}


def _tensor(v):
    return torch.from_numpy(np.asarray(v))


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return fn(tree)


def _feed(steps=3, quiet=True, tmp=None):
    """Both observers fed the same metrics; returns them and their jsonl
    paths."""
    paths = [None, None]
    if tmp is not None:
        paths = [str(tmp / "jax.jsonl"), str(tmp / "port.jsonl")]
    jo = JObserver(log_path=paths[0], quiet=quiet, progress_every=2)
    to = NumericsObserver(log_path=paths[1], quiet=quiet, progress_every=2)
    for s in range(1, steps + 1):
        m = _metrics(s)
        jo.record_step(s, _as(m, jnp.asarray), walltime_s=0.01 * s)
        to.record_step(s, _as(m, _tensor), walltime_s=0.01 * s)
    jo.close()
    to.close()
    return jo, to, paths


def _without_clock(line):
    row = json.loads(line)
    row.pop("t")
    row.pop("dt_s", None)
    return json.dumps(row)  # NaN compares as its text


def test_jsonl_rows_equal_jax(tmp_path):
    _feed(tmp=tmp_path)
    rows = [[_without_clock(x) for x in (tmp_path / f).read_text()
             .splitlines()] for f in ("jax.jsonl", "port.jsonl")]
    assert len(rows[1]) == 3
    assert rows[0] == rows[1]
    assert '"requant_sat_hi": NaN' in rows[1][0]


def test_progress_lines_equal_jax(capsys):
    _feed(steps=4, quiet=False)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6  # steps 1, 2, 4, JAX's line first each time
    assert lines[0::2] == lines[1::2]
    assert lines[0].startswith("[train] step 1  loss 2.9000  dt 10.0ms  sat")


def test_prom_text_equal_jax():
    jo, to, _ = _feed()
    assert to.prom_text() == jo.prom_text()
    assert 'repro_numerics_update_sat_hi{layer="embed.tok"}' in to.prom_text()


def test_counters_and_summary_equal_jax():
    jo, to, _ = _feed()
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}
                         for e in evs]
    assert strip(to.to_chrome_counters()) == strip(jo.to_chrome_counters())
    assert to.summary() == jo.summary()
    assert to.n_steps == jo.n_steps == 3


def test_exports_validate_across_packages(tmp_path):
    jo, to, _ = _feed()
    for doc in (jo.to_chrome(), to.to_chrome()):
        assert validate_train_trace(doc) == j_validate(doc)
        assert validate_train_trace(doc)["steps"] == 3
    paths = to.export(str(tmp_path), tag="unit")
    doc = json.loads(open(paths["trace"]).read())
    assert j_validate(doc)["tracks"] == validate_train_trace(doc)["tracks"]
    assert json.loads(open(paths["summary"]).read())["steps"] == 3


def test_validate_train_trace_rejections():
    """JAX's rejection cases (tests/test_numerics.py) on the port."""
    _, to, _ = _feed(steps=1)
    doc = to.to_chrome()
    for track in REQUIRED_TRAIN_COUNTERS:
        assert track in validate_train_trace(doc)["tracks"]
    with pytest.raises(ValueError, match="traceEvents"):
        validate_train_trace({"events": []})
    no_steps = {"traceEvents": [e for e in doc["traceEvents"]
                                if e.get("name") != "train_step"]}
    with pytest.raises(ValueError, match="train_step"):
        validate_train_trace(no_steps)
    no_counters = {"traceEvents": [
        e for e in doc["traceEvents"]
        if not str(e.get("name", "")).startswith("numerics/update")]}
    with pytest.raises(ValueError, match="counter track"):
        validate_train_trace(no_counters)
    bad = json.loads(json.dumps(doc))
    ev = next(e for e in bad["traceEvents"] if e["ph"] == "C")
    ev["args"] = {"layer": "high"}
    with pytest.raises(ValueError, match="non-numeric"):
        validate_train_trace(bad)
    ev["args"] = {}
    with pytest.raises(ValueError, match="no series"):
        validate_train_trace(bad)


def test_one_host_transfer_a_step(monkeypatch):
    """``record_step`` stacks every scalar of the step (loss, grad norm,
    both sites' stats) and reads them back in one ``.cpu().tolist()``,
    with no ``.item()``."""
    m = _as(_metrics(1), _tensor)
    n_leaves = 2 + sum(len(per) for site in m["numerics"].values()
                       for per in site.values())
    stacks, items = [], []
    stack, item = torch.stack, torch.Tensor.item
    monkeypatch.setattr(torch, "stack", lambda xs, *a, **k: (
        stacks.append(len(xs)), stack(xs, *a, **k))[1])
    monkeypatch.setattr(torch.Tensor, "item", lambda self: (
        items.append(1), item(self))[1])
    row = NumericsObserver().record_step(1, m)
    assert stacks == [n_leaves] and items == []
    assert row["loss"] == float(np.float32(2.9))
    assert math.isnan(row["numerics"]["update"]["period.pos0.attn.wq"]
                      ["requant_sat_hi"])


def test_two_train_steps_through_both_observers(jax_state):  # noqa: F811
    """Each package's train step with ``numerics=True`` into its own
    observer, two steps from one state: every per-layer stat within the
    train test's rtol, the same layers, sites and keys."""
    out = _run_both(jax_state, "qg", numerics=True, steps=2)
    jo, to = JObserver(), NumericsObserver()
    for i, (jm, tm, jf, tf) in enumerate(out, start=1):
        assert _word_diffs(jf, tf)[0] == 0, f"words differ after step {i}"
        jrow = jo.record_step(i, jm, walltime_s=0.1)
        trow = to.record_step(i, tm, walltime_s=0.1)
        assert set(trow["numerics"]) == set(jrow["numerics"]) == {
            "update", "grad_encode"}
        for site, layers in jrow["numerics"].items():
            assert set(trow["numerics"][site]) == set(layers), site
            for layer, stats in layers.items():
                got = trow["numerics"][site][layer]
                assert set(got) == set(stats), (site, layer)
                for k, v in stats.items():
                    rtol = STAT_RTOL.get(k, 1e-6)
                    if i > 1 and k in ("qerr_rel", "qerr_gap_ratio"):
                        rtol = QERR_SUM_RTOL
                    np.testing.assert_allclose(
                        got[k], v, rtol=rtol, atol=1e-12,
                        err_msg=f"step {i} {site}.{layer}.{k}")
        np.testing.assert_allclose(trow["loss"], jrow["loss"], rtol=1e-3)
    assert validate_train_trace(to.to_chrome())["steps"] == 2
    assert j_validate(to.to_chrome())["steps"] == 2


def test_to_float_tree_keeps_plain_numbers():
    tree = {"a": {"x": torch.tensor(0.5, dtype=torch.float64), "y": 2},
            "b": torch.tensor([0.25])}
    assert tnum._to_float_tree(tree) == {"a": {"x": 0.5, "y": 2.0},
                                         "b": 0.25}
    assert tnum._to_float_tree({}) == {}
