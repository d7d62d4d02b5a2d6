"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device: the
port's counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table

The reference lowers and compiles each cell's step against shape
stand-ins on the production mesh and reads the compiler's memory and
cost analyses.  The port has no compiler: a record here has three parts.

1. Layout fields, at full depth and without running a step: parameter
   counts (all and active), the policy's layout, the microbatch count,
   the optimizer's moment dtype (bf16 above 100e9 parameters, the
   reference's rule) and the cell's shape.
2. ``memory``: the bytes each mesh position holds of what the step takes
   as input, as the policy lays it out at full depth (train: parameters,
   both moments, the step and the batch; prefill: parameters and batch;
   decode: parameters, the ``cache_spec``-laid cache and the token) --
   ``place.device_bytes``, the maximum and the mean over positions.  A
   layout fact, not a compiler's.
3. ``dynamic``: the counts of :func:`repro_torch.launch.op_stats.analyze`
   over the cell's real train, prefill or decode step (``launch.steps``
   under the policy's activation rules), run through the port's sharded
   code on the production mesh of ``meta`` positions.  Running every
   position's eager step at full depth would take hours a cell, so the
   step runs reduced along three variables and each count is extended
   to the full step exactly (``sharding.sampling``):

   * depth: every cycle of the layer pattern runs the same ops on the same
     shapes, so the step runs at 1, 2 and 3 stacked cycles (remainder
     layers, as gemma3-27b's 2 past 10 cycles of 6, run once each in
     every run) and each count is taken as a polynomial of degree 2 in
     the cycles: training's backward of a stacked leaf's per-cycle slice
     writes a gradient of the whole stack, a term in cycles squared;
   * batch groups: every batch shard (``parallel.MeshRun``'s groups) runs
     the same ops on equal shapes, so the step runs with 1 and 2 groups
     live (the others get stand-ins; the code across groups runs in
     full) and each count is affine in them;
   * sLSTM timesteps: every step of the recurrence runs the same ops on
     the same shapes, so a train or prefill step of a config with sLSTM
     blocks runs 1 and 2 of them, the count affine in them.

   The runs cover every combination of those points (6, or 12 with
   sLSTM), and the counts at the full step are their tensor-product
   interpolation, in integers.
   ``test_torch_dryrun.py`` holds the extrapolated counts equal to a plain
   full run of the same cell at small widths.  Totals are over the mesh;
   ``per_position`` divides them by its positions.

Artifacts: ``build/dryrun_torch/<arch>__<shape>__<mesh>.json`` (a failed
cell writes ``.error.json``; computed cells are skipped unless
``--force``).  Cells run in a process each, as many at once as the host
has cores.  The reference's ``XLA_FLAGS`` preamble and its HLO parser
(``parse_collectives``) have no counterpart: nothing is lowered.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import itertools
import json
import math
import os
import pathlib
import time
import traceback
from fractions import Fraction

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.registry import cells, skipped_cells
from repro_torch.launch import op_stats
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import checked_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import parallel, place, policy, sampling
from repro_torch.sharding.place import Sharded

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
               / "dryrun_torch")

# the points each reduced variable runs at: stacked cycles, live batch
# groups, live sLSTM timesteps
CYCLE_POINTS = (1, 2, 3)
GROUP_POINTS = (1, 2)
STEP_POINTS = (1, 2)


def meta_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A mesh of ``meta`` positions (no memory, shapes only)."""
    return checked_mesh(shape, axes, ["meta"] * math.prod(shape))


def production_mesh(multi_pod: bool = False):
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def mesh_label(mesh) -> str:
    n = math.prod(mesh.shape.values())
    if n in (256, 512):
        return "pod2x16x16" if "pod" in mesh.shape else "pod16x16"
    return "mesh" + "x".join(str(v) for v in mesh.shape.values())


def opt_config(n_params: int) -> adamw.AdamWConfig:
    """>100B: bf16 moments (fp32 AdamW state would exceed pod HBM)."""
    return adamw.AdamWConfig(
        moment_dtype="bfloat16" if n_params > 100e9 else "float32")


def batch_shards(mesh, layout: str) -> int:
    model_ax = mesh.shape.get("model", 1)
    n = math.prod(mesh.shape.values())
    return n if layout == "dp" else n // model_ax


# ------------------------------------------------------------- inputs
def step_inputs(cfg, shape, mesh, layout: str, opt_cfg, model) -> tuple:
    """(step, stand-ins of its inputs as a tree, their specs): the cell's
    step function with its arguments as ``meta`` tensors and the specs
    the policy lays them out by."""
    params = model.init(torch.Generator(), device="meta")
    pspecs = policy.param_specs(params, mesh, layout=layout)
    if shape.kind == "train":
        state = {"params": params, "opt": adamw.init(params, opt_cfg)}
        batch = steps_mod.input_specs(cfg, shape)
        n_micro = steps_mod.pick_microbatches(shape,
                                              batch_shards(mesh, layout))
        fn = steps_mod.make_train_step(model, opt_cfg, n_micro)
        return fn, (state, batch), (
            {"params": pspecs, "opt": policy.opt_specs(pspecs)},
            policy.batch_spec(batch, mesh, global_batch=shape.global_batch,
                              layout=layout))
    if shape.kind == "prefill":
        batch = steps_mod.input_specs(cfg, shape, labels=False)
        fn = steps_mod.make_prefill_step(model, max_len=shape.seq_len)
        return fn, (params, batch), (
            pspecs, policy.batch_spec(batch, mesh,
                                      global_batch=shape.global_batch))
    cache, tok, _ = steps_mod.decode_input_specs(cfg, shape, model)
    cspecs = policy.cache_spec(cache, mesh, batch=shape.global_batch,
                               seq_shard=shape.global_batch == 1)
    tspec = policy.batch_spec({"tokens": tok}, mesh,
                              global_batch=shape.global_batch)["tokens"]
    step = steps_mod.make_decode_step(model, max_len=shape.seq_len)
    pos = shape.seq_len - 1           # the last slot; no shape depends on it

    def fn(params, cache, tokens):
        return step(params, cache, tokens, pos)
    return fn, (params, cache, tok), (pspecs, cspecs, tspec)


def _laid_out(tree, specs, mesh):
    """``tree``'s leaves as Sharded records of their layout, holding no
    blocks (enough for ``place.device_bytes``)."""
    def one(x, ns):
        out = Sharded(mesh, ns.spec, x.shape, x.dtype, {})
        out.check()
        return out
    return place._map_pairs(one, tree, policy.named(specs, mesh))


def argument_bytes(args, specs, mesh) -> dict:
    """Bytes per position of the step's inputs as the specs lay them out:
    the maximum and the mean over positions."""
    per = place.device_bytes(_laid_out(args, specs, mesh))
    vals = [per.get(p, 0) for p in place.positions(mesh)]
    return {"argument_bytes": max(vals),
            "argument_bytes_mean": sum(vals) / len(vals)}


# -------------------------------------------------------------- counts
def _at_depth(cfg, cycles: int):
    """``cfg`` with ``cycles`` full cycles of its pattern (its remainder
    layers kept); an encoder-decoder's encoder cut alike."""
    n_cycles, rem = cfg.cycles()
    out = dataclasses.replace(
        cfg, n_layers=cycles * len(cfg.layer_pattern) + rem)
    if cfg.is_encoder_decoder:
        out = dataclasses.replace(out, encoder_layers=cycles)
    return out


def count_step(cfg, shape, mesh, layout: str, opt_cfg, *,
               groups=None, steps=None) -> dict:
    """op_stats counts of one run of the cell's step at ``cfg``'s depth,
    with ``groups`` batch groups and ``steps`` sLSTM timesteps running
    (None: all)."""
    model = Model(cfg)
    fn, args, specs = step_inputs(cfg, shape, mesh, layout, opt_cfg, model)
    args = place.place(args, policy.named(specs, mesh))
    rules = policy.activation_rules(cfg, mesh, shape.kind, layout=layout)
    with shctx.rules(mesh, rules), sampling.sample(groups, steps):
        res = op_stats.analyze(fn, *args)
    res.pop("result")
    return res


def n_groups(cfg, shape, mesh, layout: str) -> int:
    """The batch shards a step of this cell runs (``MeshRun.groups``)."""
    if shape.kind == "decode":
        tok = steps_mod.f((shape.global_batch, 1), torch.int32)
        spec = policy.batch_spec({"tokens": tok}, mesh,
                                 global_batch=shape.global_batch)["tokens"]
    else:
        batch = steps_mod.input_specs(cfg, shape, labels=False)
        lead = "inputs_embeds" if "inputs_embeds" in batch else "tokens"
        spec = policy.batch_spec(
            batch, mesh, global_batch=shape.global_batch,
            layout=layout if shape.kind == "train" else "hybrid")[lead]
    return len(parallel.MeshRun(mesh, spec[0] if spec else None).groups)


def _lagrange(points: tuple, target: int) -> list:
    """Weights of the values at ``points`` that give a polynomial's value
    at ``target`` (degree below the number of points)."""
    out = []
    for i, p in enumerate(points):
        w = Fraction(1)
        for j, q in enumerate(points):
            if j != i:
                w *= Fraction(target - q, p - q)
        out.append(w)
    return out


def extrapolate(runs: dict, axes: list) -> dict:
    """Counts at the targets of ``axes`` ([(points, target)] per
    variable) from ``runs`` (a tuple of one point per variable -> the
    counts of that run): the tensor-product interpolation, exact for
    counts of degree below each variable's number of points.  Integer
    counts come out as integers (a fractional result raises)."""
    weights = [_lagrange(pts, tgt) for pts, tgt in axes]

    def at(path):
        total = Fraction(0)
        for idx in itertools.product(*(range(len(p)) for p, _ in axes)):
            w = math.prod(weights[v][i] for v, i in enumerate(idx))
            leaf = runs[tuple(axes[v][0][i] for v, i in enumerate(idx))]
            for k in path:
                leaf = leaf[k]
            total += w * leaf
        if total.denominator != 1:
            raise ArithmeticError(f"count {path} extrapolates to {total}")
        return int(total)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, int) and not isinstance(node, bool):
            return at(path)
        return node
    first = runs[next(iter(runs))]
    return walk(first, ())


def step_counts(cfg, shape, mesh, layout: str, opt_cfg, *,
                reduce: bool = True) -> dict:
    """The step's op_stats counts at ``cfg``'s full depth over every
    batch group and timestep: from the reduced runs extrapolated
    (``reduce``), or from one plain run."""
    n_cycles, rem = cfg.cycles()
    if cfg.is_encoder_decoder and cfg.encoder_layers != n_cycles:
        raise ValueError("the encoder's depth must equal the decoder's "
                         "cycles to be cut with them")
    keep = ("flops", "hbm_bytes", "collectives")
    if not reduce:
        res = count_step(cfg, shape, mesh, layout, opt_cfg)
        return {k: res[k] for k in keep}
    n_grp = n_groups(cfg, shape, mesh, layout)
    n_stp = (shape.seq_len if "sl" in cfg.layer_pattern
             and shape.kind != "decode" else 1)
    axes = []      # (name, points run, target)
    for name, pts, target in (("depth", CYCLE_POINTS, n_cycles),
                              ("groups", GROUP_POINTS, n_grp),
                              ("steps", STEP_POINTS, n_stp)):
        axes.append((name, pts if target > pts[-1] else (target,), target))
    runs = {}
    for point in itertools.product(*(pts for _, pts, _ in axes)):
        c, g, t = point
        res = count_step(_at_depth(cfg, c), shape, mesh, layout, opt_cfg,
                         groups=g if g < n_grp else None,
                         steps=t if t < n_stp else None)
        runs[point] = {k: res[k] for k in keep}
    out = extrapolate(runs, [(pts, target) for _, pts, target in axes])
    for name, pts, target in axes:
        out[f"{name}_run"] = {"run": list(pts), "of": target}
    out["depth_run"].update(period=len(cfg.layer_pattern),
                            remainder_layers=rem)
    return out


# ---------------------------------------------------------------- cells
def layout_fields(cfg, shape, mesh) -> dict:
    """The record's fields that need no step run: parameter counts at full
    depth (``count_params`` / ``count_active_params`` on the ``meta``
    tree), the policy's layout, the microbatch count (train), the
    optimizer's moment dtype and the cell's shape."""
    params = Model(cfg).init(torch.Generator(), device="meta")
    n_params = steps_mod.count_params(params)
    layout = policy.choose_layout(cfg, mesh, shape)
    return {
        "n_devices": math.prod(mesh.shape.values()),
        "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "n_params": n_params,
        "n_active_params": steps_mod.count_active_params(cfg, params),
        "tokens_per_step": shape.global_batch * (
            shape.seq_len if shape.kind != "decode" else 1),
        "layout": layout,
        "n_microbatches": (steps_mod.pick_microbatches(
            shape, batch_shards(mesh, layout)) if shape.kind == "train"
            else None),
        "moment_dtype": opt_config(n_params).moment_dtype,
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               cfg=None, shape=None, mesh=None, mesh_name=None,
               reduce: bool = True) -> dict:
    """One (arch x shape x mesh) record.  The cfg/shape/mesh overrides
    let a test dry-run a reduced config on a small meta mesh (same
    schema, same invariants); ``reduce=False`` runs the step once at full
    depth with every group (what the reductions are held to)."""
    t0 = time.time()
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_name or mesh_label(mesh),
           **layout_fields(cfg, shape, mesh)}
    layout, n = rec["layout"], rec["n_devices"]
    opt_cfg = adamw.AdamWConfig(moment_dtype=rec["moment_dtype"])
    _, args, specs = step_inputs(cfg, shape, mesh, layout, opt_cfg,
                                 Model(cfg))
    rec["memory"] = argument_bytes(args, specs, mesh)
    rec["layout_s"] = round(time.time() - t0, 2)
    dyn = step_counts(cfg, shape, mesh, layout, opt_cfg, reduce=reduce)
    rec["dynamic"] = dyn
    rec["per_position"] = {
        "flops": dyn["flops"] / n, "hbm_bytes": dyn["hbm_bytes"] / n,
        "collective_bytes": dyn["collectives"]["total_bytes"] / n}
    rec["run_s"] = round(time.time() - t0, 2)
    return rec


def cell_path(arch: str, shape_name: str, multi_pod: bool) -> pathlib.Path:
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    return RESULTS_DIR / f"{arch}__{shape_name}__{mesh}.json"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             force: bool = False, verbose: bool = True) -> dict | None:
    out = cell_path(arch, shape_name, multi_pod)
    if out.exists() and not force:
        if verbose:
            print(f"[skip] {out.name} (cached)", flush=True)
        return json.loads(out.read_text())
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    try:
        res = lower_cell(arch, shape_name, multi_pod=multi_pod)
    except Exception as e:  # noqa: BLE001 -- record the failure artifact
        res = {"arch": arch, "shape": shape_name,
               "mesh": "pod2x16x16" if multi_pod else "pod16x16",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        out.with_suffix(".error.json").write_text(json.dumps(res, indent=2))
        print(f"[FAIL] {arch} x {shape_name}: {res['error']}", flush=True)
        return None
    out.with_suffix(".error.json").unlink(missing_ok=True)
    out.write_text(json.dumps(res, indent=2))
    if verbose:
        gb = res["memory"]["argument_bytes"] / 2**30
        per = res["per_position"]
        print(f"[ok] {arch} x {shape_name} x {res['mesh']}: "
              f"flops/pos={per['flops']:.3e} args/pos={gb:.2f}GiB "
              f"coll/pos={per['collective_bytes'] / 2**30:.3f}GiB "
              f"run={res['run_s']}s", flush=True)
    return res


def table(records: list) -> str:
    """The records as a markdown table, one row a cell with its meshes
    side by side (``a / b``): layout, microbatches, the largest argument
    bytes of a position (GB), flops per position, the bytes gathered and
    reduced between positions a step (GB, over the mesh) and run_s."""
    by_cell: dict = {}
    for r in records:
        by_cell.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    meshes = sorted({r["mesh"] for r in records})
    rows = [f"Each entry: {' / '.join(meshes)}.", "",
            "| arch | shape | layout | micro | args GB/pos | flops/pos | "
            "gather GB | reduce GB | run_s |",
            "|---|---|---|---|---|---|---|---|---|"]

    def both(cell, fn):
        return " / ".join(fn(cell[m]) if m in cell else "-" for m in meshes)
    for (arch, shape), cell in sorted(by_cell.items()):
        rows.append("| " + " | ".join([
            arch, shape, both(cell, lambda r: r["layout"]),
            both(cell, lambda r: str(r["n_microbatches"] or "-")),
            both(cell, lambda r: f"{r['memory']['argument_bytes'] / 1e9:.2f}"),
            both(cell, lambda r: f"{r['per_position']['flops']:.3e}"),
            both(cell, lambda r: f"{r['dynamic']['collectives']['all-gather']['bytes'] / 1e9:.0f}"),
            both(cell, lambda r: f"{r['dynamic']['collectives']['all-reduce']['bytes'] / 1e9:.0f}"),
            both(cell, lambda r: f"{r['run_s']:.0f}")]) + " |")
    return "\n".join(rows)


def _run_one(job) -> bool:
    arch, shape_name, mp, force = job
    return run_cell(arch, shape_name, multi_pod=mp, force=force) is not None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the records in RESULTS_DIR as a markdown "
                         "table and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table([json.loads(f.read_text())
                     for f in sorted(RESULTS_DIR.glob("*.json"))
                     if not f.name.endswith(".error.json")]))
        return

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    todo = cells() if args.all else [(args.arch, args.shape)]
    jobs = [(arch, shape_name, mp, args.force)
            for mp in meshes for arch, shape_name in todo]
    t0 = time.time()
    workers = min(len(jobs), os.cpu_count() or 1)
    if workers > 1:             # one process a cell, a cell a core
        with concurrent.futures.ProcessPoolExecutor(workers) as pool:
            results = list(pool.map(_run_one, jobs))
    else:
        results = [_run_one(j) for j in jobs]
    ok = sum(results)
    fail = len(results) - ok
    for arch, shape_name, why in skipped_cells():
        print(f"[skipped-by-design] {arch} x {shape_name}: {why}")
    print(f"done: {ok} ok, {fail} failed in {time.time() - t0:.1f}s")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
