"""Dry run of every (arch x shape) cell on an H100 mesh: does it fit in a
rank's 80 GB, what are its three roofline terms, what does it cost in
collectives, with no card.

Each cell runs the port's own step once on the ``meta`` device, as rank 0
of ``launch.mesh.make_production_mesh`` over torch's fake process-group
backend, under the cost mode (``launch.cost``):

* The state is placed at each rank's ``local_shape`` on ``meta``
  (:class:`MetaShard`): nothing is allocated, and no leaf is held whole
  where the rank keeps a shard. Training uses the JAX dry run's state
  (``MadamConfig(factored=(family == "moe"))``), serving its packed 8-bit
  words (``update_format=LNSFormat(8, 8)``).
* The step is run as the port runs it. prefill runs
  ``build_prefill_step(mesh=)`` under ``data_rules``, JAX's prefill
  placement of the rows: the batch over the data axes (one row a rank of
  prefill_32k's 32 on (32, 8)), the weights on the serving rules. decode
  runs ``build_decode_step(mesh=)`` under ``decode_rules``, JAX's decode
  placement (split-KV decode): the rows over the data axes, each dense KV
  and MLA latent cache from ``init_caches(B, S, cfg)`` split by position
  over ``model``, and long_500k's batch of 1 replicated with its
  positions over ``(data, model)``, as JAX's ``get_rules(arch)`` with its
  batch-1 override; the weights stay on the serving rules. train runs
  ``build_train_step``: the dense family tensor-parallel on the
  production mesh ``(pod, data=hosts, model=cards)`` under
  ``train_rules``, JAX's training placement (the rows over the data
  axes; ``wq``/``wk``/``wv``/``up``/``gate`` by columns, ``wo``/``down``
  by rows, the embedding, head and logits by vocabulary over model; each
  rank's shard of the state from ``init_train_state(shard=)``), the
  other families data-parallel on the mesh flattened to
  ``(hosts·cards, 1)`` under ``get_rules(arch)``, with the whole state on
  every rank (their tensor-parallel backward is not ported, ROADMAP 7j).
  The row's ``placement`` names what was run and why; where it differs
  from JAX's GSPMD placement: prefill and decode keep the second GEMM of
  each column-parallel pair replicated (``sharding.data_rules``), and a
  dim that does not divide ``model`` stays whole (GSPMD pads it).
* The kernels take their ``meta`` route (``kernels.meta``) and are
  charged their own cost (``kernels.costs``); the collectives run on the
  fake backend and are counted by kind and mesh axis
  (``distributed.collectives``).

There is no while loop whose body a compiler counts once: every layer
runs, so the counts are exact in one pass at full depth
(``cost_extrapolated`` is always false). Where a step branches on its
data (MoE's expert skip, the re-grid test), the ``meta`` branch is the
one that computes more, so the row bounds the card from above.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import (SHAPES, cells, get_config, get_rules,
                                 input_specs)
from repro_torch.core.lns import LNSFormat, LNSWeight, is_lns_weight
from repro_torch.core.quantizer import QuantConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.params_sharding import (LocalShard, kept_whole,
                                                     local_shape)
from repro_torch.distributed.sharding import (axis_shards, batch_divisor,
                                              data_rules, decode_rules,
                                              shard_ctx, train_rules)
from repro_torch.launch import roofline
from repro_torch.launch.cost import CostMode
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import init_caches, init_params
from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
from repro_torch.training.steps import (TP_FAMILIES, build_decode_step,
                                        build_prefill_step, build_train_step,
                                        init_train_state)

__all__ = ["SERVE_FMT", "MetaShard", "cell_rules", "cell_step", "measure",
           "meta_mesh", "run_cell", "main"]

SERVE_FMT = LNSFormat(bits=8, gamma=8)  # served weights: packed 8-bit LNS


class MetaShard(LocalShard):
    """:class:`LocalShard` for a dry run: each leaf becomes an empty
    ``meta`` tensor at the rank's ``local_shape`` (a kept-whole leaf at
    its whole shape). ``meta`` leaves hold no storage, so the whole
    leaf ``init_params`` hands over is only its shape."""

    def __call__(self, path, leaf):
        if self.serving and kept_whole(path):
            return leaf
        spec = self._spec(path, leaf)

        def local(t, s):
            return torch.empty(local_shape(t.shape, s, self.mesh),
                               dtype=t.dtype, device="meta")
        if is_lns_weight(leaf):
            return LNSWeight(local(leaf.packed, spec.packed),
                             local(leaf.scale, spec.scale), leaf.fmt)
        return local(leaf, spec)


def _flattened(cfg, kind: str) -> bool:
    """Whether a cell trains on the flattened mesh: a train cell of a
    family whose tensor-parallel backward is not ported."""
    return kind == "train" and cfg.family not in TP_FAMILIES


def _mesh_shape(multi_pod: bool, hosts: int, cards: int,
                flat: bool) -> Dict[str, int]:
    shape = ({"data": hosts * cards, "model": 1} if flat
             else {"data": hosts, "model": cards})
    return {"pod": 2, **shape} if multi_pod else shape


def cell_rules(arch: str, cfg, kind: str, mesh, B: int) -> Dict:
    """The rules a cell's step runs under: ``data_rules`` for prefill,
    ``train_rules`` (JAX's training placement) for a tensor-parallel
    train cell (raising where the batch does not split over the data
    axes), ``get_rules(arch)`` for a flattened train cell,
    ``decode_rules`` for decode. A prefill batch
    that does not split over the data axes (prefill_32k's 32 rows over
    two pods' 64) is replicated, as JAX's dry run overrides ``batch``
    for any cell whose batch its data axes do not divide."""
    if kind == "decode":
        return decode_rules(cfg, mesh, B, get_rules(arch))
    if _flattened(cfg, kind):
        return get_rules(arch)
    if kind == "train":
        return train_rules(cfg, mesh, B)
    if B % batch_divisor(mesh):
        return dict(data_rules(cfg, mesh), batch=None)
    return data_rules(cfg, mesh, B)


def _axes(entry, mesh) -> str:
    """A rule's mesh axes present in ``mesh``, joined by ``+``."""
    axes = [a for a in ((entry,) if isinstance(entry, str) else entry or ())
            if a in mesh.axis_names]
    return "+".join(axes) or "replicated"


def _placement(kind: str, shape: str, mesh, B: int, rules=None,
               flat: bool = False) -> str:
    dims = ", ".join(f"{a}={n}" for a, n in mesh.shape.items())
    weights = ("weights on serving_rules (heads, MLP and experts over "
               "model where they divide it; the second GEMM of each pair "
               "replicated, no split sum, where JAX's GSPMD shards it "
               "row-parallel)")
    if kind == "train" and flat:
        n = mesh.size
        return (f"train: build_train_step data-parallel on ({dims}), the "
                f"production mesh flattened (this family's "
                f"tensor-parallel backward is not ported, ROADMAP 7j); "
                f"parameters and optimizer state replicated, "
                f"{B // n} of the {B} rows a rank")
    with shard_ctx(mesh, rules):
        rows = axis_shards("batch")
    rows_on = _axes(rules["batch"], mesh)
    if kind == "train":
        with shard_ctx(mesh, rules):
            split = [n for n in ("qkv_out", "mlp", "vocab")
                     if axis_shards(n) > 1]
        return (f"train: build_train_step tensor-parallel on ({dims}) "
                f"under train_rules, JAX's training placement: the batch "
                f"of {B} over {rows_on} ({B // rows} a rank); "
                f"{', '.join(split) or 'nothing'} over model (each "
                f"column-parallel leaf's columns and its row-parallel "
                f"partner's rows, wo and down, their partial products "
                f"SUM-reduced; the embedding, head and logits by "
                f"vocabulary), a dim that does not divide model whole "
                f"where JAX's GSPMD pads it; each rank's shard of the "
                f"words and second moments, gradients SUM-reduced over "
                f"data, shards' Q_G and grad norm over model")
    if kind == "prefill":
        return (f"prefill: build_prefill_step on ({dims}) under "
                f"data_rules: the batch of {B} over {rows_on} ({B // rows} "
                f"a rank); {weights}")
    with shard_ctx(mesh, rules):
        blocks = axis_shards("kv_seq")
    seq = SHAPES[shape].seq_len
    pos_on = _axes(rules["kv_seq"], mesh)
    return (f"decode: decode_rules on ({dims}), split-KV decode: the batch "
            f"of {B} over {rows_on} ({B // rows} a rank); each dense KV "
            f"and MLA latent cache split by position over {pos_on} "
            f"({seq // blocks} of {seq} positions a rank, every KV head; "
            f"partials merged by a MAX and a SUM "
            f"reduce a layer); rings and recurrent state as serving holds "
            f"them (ring slots whole, heads over model); {weights}")


def cell_step(cfg, spec, mesh, rules, *, device="meta", accum_steps: int = 1,
              remat: bool = True):
    """``(args, run)``: a cell's state and batch on ``device`` (each
    rank's shard on ``meta`` through :class:`MetaShard`; drawn, then
    sliced, elsewhere; whole with no ``mesh``) and ``run()`` its step,
    under ``mesh`` and ``rules`` as the caller holds them (``shard_ctx``).
    A batch on a real device is the stand-ins' zeros there."""
    kind = spec.kind
    qcfg = QuantConfig.lns_madam()
    batch = input_specs(cfg, spec)
    if device != "meta":
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in batch.items()}
    shard = (None if mesh is None or _flattened(cfg, kind) else
             (MetaShard if device == "meta" else LocalShard)(mesh, rules))
    if kind == "train":
        mcfg = MadamConfig(factored=(cfg.family == "moe"))
        state = init_train_state(cfg, mcfg, device=device, shard=shard)
        step = build_train_step(cfg, qcfg, mcfg, accum_steps=accum_steps,
                                remat=remat)
        return (state, batch), lambda: step(state, batch)
    mcfg = MadamConfig(update_format=SERVE_FMT)
    params = init_params(cfg, device=device, leaf_fn=lns_leaf_encoder(mcfg),
                         shard=shard)
    if kind == "prefill":
        step = build_prefill_step(cfg, qcfg, mcfg, mesh=mesh, rules=rules)
        return (params, batch), lambda: step(params, batch)
    caches = init_caches(spec.global_batch, spec.seq_len, cfg, device=device)
    step = build_decode_step(cfg, qcfg, mcfg, mesh=mesh, rules=rules)
    pos = spec.seq_len - 1
    return ((params, caches, batch),
            lambda: step(params, caches, batch, pos))


def measure(args, run) -> Dict:
    """``run()`` once under the cost mode, the collective counters reset
    first: the mode's report, with the collectives' ``byte_counts`` and
    call ``counts``."""
    collectives.reset_counts()
    with CostMode(args) as mode:
        out = run()
        mode.outputs(out)
    del out
    rep = mode.report()
    rep["collectives"] = collectives.byte_counts()
    rep["collective_calls"] = collectives.counts()
    return rep


@contextlib.contextmanager
def meta_mesh(shape: Dict[str, int], cards: int):
    """Rank 0's mesh of ``shape`` over the fake backend, ``cards`` a
    host; the fake world is taken down after the block if it started
    here."""
    import torch.distributed as dist
    owned = not dist.is_initialized()
    try:
        yield make_mesh(shape, "meta", cards_per_host=cards, what="dryrun")
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             hosts: int = 32, cards: int = 8,
             rules_extra: Optional[Dict] = None, accum_steps: int = 1,
             cfg_overrides: Optional[Dict] = None, remat: bool = True,
             tag: str = "") -> Dict:
    """One cell: the step run once on ``meta`` at full depth under the
    cost mode; the row carries the JAX dry run's keys, with ``trace_s``
    for ``lower_s``/``compile_s`` and ``placement`` added."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    spec = SHAPES[shape]
    kind = spec.kind
    flat = _flattened(cfg, kind)
    B = spec.global_batch
    with meta_mesh(_mesh_shape(multi_pod, hosts, cards, flat),
                   cards) as mesh:
        if flat and B % batch_divisor(mesh):
            raise ValueError(
                f"{arch} {shape}: the global batch of {B} does not split "
                f"over {mesh.size} data-parallel ranks (the {cfg.family} "
                f"family trains on the flattened mesh, one rank a card)")
        rules = dict(cell_rules(arch, cfg, kind, mesh, B))
        if rules_extra:
            rules.update(rules_extra)
        t0 = time.monotonic()
        with shard_ctx(mesh, rules):
            cost = measure(*cell_step(cfg, spec, mesh, rules,
                                      accum_steps=accum_steps, remat=remat))
        trace_s = time.monotonic() - t0
        coll = cost["collectives"]
        within = {axes: mesh.within_host(tuple(axes.split("+")))
                  for axes in coll["by_axis"]}
        mesh_name = "x".join(str(n) for n in mesh.shape.values())
        chips = mesh.size
        placement = _placement(kind, shape, mesh, B, rules, flat)
    rep = roofline.analyze(arch, shape, mesh_name, chips, cost, coll, within,
                           roofline.model_flops(cfg, spec, kind),
                           cost["memory"]["peak_bytes"])
    row = rep.row()
    row.update({
        "kind": kind,
        "memory": cost["memory"],
        "trace_s": round(trace_s, 1),
        "hlo_bytes": None,
        "cost_extrapolated": False,
        "params_total": cfg.params_count(),
        "params_active": cfg.active_params_count(),
        "tag": tag,
        "placement": placement,
        "collective_calls": cost["collective_calls"],
        "collectives_by_axis": coll["by_axis"],
        "kernels": cost["kernels"],
        "kernel_flops": cost["kernel_flops"],
        "kernel_bytes": cost["kernel_bytes"],
    })
    return row


def _print_row(row: Dict):
    mem_gb = (row["memory"].get("peak_bytes") or 0) / 2**30
    print(f"{row['arch']:>18s} {row['shape']:>11s} mesh={row['mesh']:>8s} "
          f"T_comp={row['t_compute_s']:.4f}s T_mem={row['t_memory_s']:.4f}s "
          f"T_coll={row['t_collective_s']:.4f}s dom={row['dominant']:<10s} "
          f"useful={row['useful_fraction']:.2f} "
          f"roofline={row['roofline_fraction']:.3f} peak={mem_gb:.1f}GiB "
          f"(trace {row['trace_s']:.1f}s)", flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--timeout", type=int, default=3000,
                    help="seconds a cell under --all")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once under --all")
    ap.add_argument("--rules", default=None,
                    help="JSON dict of logical-rule overrides")
    ap.add_argument("--cfg", default=None,
                    help="JSON dict of ArchConfig field overrides")
    ap.add_argument("--tag", default="", help="label recorded in the row")
    ap.add_argument("--no-remat", action="store_true")
    return ap


def _run_all(args) -> int:
    """Every cell in a subprocess of its own, ``--jobs`` at a time, each
    with ``--timeout`` seconds."""
    from concurrent.futures import ThreadPoolExecutor

    def one(cell):
        arch, shape = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape]
        if args.multi_pod:
            cmd.append("--multi-pod")
        if args.out:
            cmd += ["--out", args.out]
        try:
            return subprocess.run(cmd, timeout=args.timeout).returncode
        except subprocess.TimeoutExpired:
            print(f"TIMEOUT {arch} {shape} after {args.timeout} s",
                  flush=True)
            return -1

    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        rcs = list(pool.map(one, cells()))
    ok = sum(rc == 0 for rc in rcs)
    print(f"dry-run complete: {ok} ok, {len(rcs) - ok} failed")
    return 1 if ok < len(rcs) else 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.all:
        return _run_all(args)
    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape (or --all)")
    torch.set_num_threads(1)
    rules_extra = json.loads(args.rules) if args.rules else None
    if rules_extra:
        rules_extra = {k: tuple(v) if isinstance(v, list) else v
                       for k, v in rules_extra.items()}
    t0 = time.monotonic()
    try:
        row = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       accum_steps=args.accum_steps,
                       rules_extra=rules_extra,
                       cfg_overrides=json.loads(args.cfg) if args.cfg
                       else None,
                       remat=not args.no_remat, tag=args.tag)
    except Exception as e:  # the cell's own reason, then a failing exit
        print(f"FAILED {args.arch} {args.shape} after "
              f"{time.monotonic() - t0:.1f} s: {type(e).__name__}: {e}",
              flush=True)
        return 1
    _print_row(row)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
