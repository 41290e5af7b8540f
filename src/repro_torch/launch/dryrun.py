"""Multi-device dry run: one step of every (arch x shape x mesh) cell on
the ``meta`` device, with its op analysis.

The port's counterpart of the reference's ``launch/dryrun.py``.  The
reference lowers and compiles each cell on 512 fake host devices and
reads memory, FLOPs and collective bytes from the compiled HLO.  PyTorch
has no HLO, so for each cell this module:

  1. makes this process rank 0 of a fake process group of the mesh's
     size (``torch.distributed``'s "fake" backend over a ``FakeStore``:
     no other process exists, no collective sends anything) and the
     production mesh on it (16x16 single-pod or 2x16x16 multi-pod; any
     shape for the tests, or none: the meshless one-device step);
  2. draws the parameters and optimizer state on ``meta`` (shapes, no
     data) and lays them out under ``param_specs`` / ``opt_state_specs``
     as the Trainer's mesh path does (``launch/train.py``); a serve cell
     takes the caches of ``init_caches`` cut to the layout its layers
     read (``cache_specs``' batch split, and its kv-head split where the
     layers split the heads over "model") and the batch cut to
     ``batch_specs``;
  3. runs the cell's real step once -- one train step
     (``build_mesh_train_step`` / ``build_train_step``), or one prefill or
     one decode step under ``meshctx.use_mesh`` with the parameters
     gathered as the train step gathers them -- inside
     ``op_analysis.analyze``: every aten op, every collective and every
     kernel op (through its meta route, ``kernels/_meta.py``) is counted,
     and the live bytes tracked; a sharding mismatch or a shape the
     layers refuse surfaces here as a failure of the cell;
  4. writes the reference's JSON keys into experiments/dryrun/<cell>.json
     (so ``tools/make_experiments.py`` renders the port's cells as it
     does the reference's): ``memory`` (``argument_size_in_bytes``: the
     rank's parameter, optimizer, batch and cache shards, with the
     reference's int32 step, count and position scalars;
     ``temp_size_in_bytes``; ``total_bytes_per_device``: the peak of live
     bytes), ``hlo`` (the op analysis), ``roofline`` (the reference's
     fields and formulas, over an H100's datasheet peaks), ``n_params``
     and ``n_active_params``; ``trace_seconds`` replaces the reference's
     lower and compile seconds.

This is the port's one entry point that runs without a card: nothing is
computed and nothing is allocated on any device, as the reference's dry
run compiles on host devices.  Where the reference's cache layout splits
a KV cache's sequence over "model" (kv heads that "model" does not
divide), the port holds the positions whole: its layers split heads,
never positions.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_arch, input_specs, list_archs
from repro_torch.configs.base import ArchSpec, ShapeSpec, for_shape
from repro_torch.distributed import meshctx
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              heads_split,
                                              model_split_leaves,
                                              named_shardings,
                                              opt_state_specs, param_specs)
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import data_axes_of, make_mesh
from repro_torch.launch.train import (_distribute, _from_local, _gather,
                                      _rows, _split_mesh_dims,
                                      build_mesh_train_step,
                                      build_train_step)
from repro_torch.models import transformer as T
from repro_torch.models.config import ShardingConfig
from repro_torch.models.quantized import quantized_param_shapes
from repro_torch.optim import make_optimizer
from repro_torch.tree import flatten, map_tree, requires_grad_, unflatten

# The roofline's denominators: datasheet values of one H100 SXM5 80GB
# HBM3 at its 700 W power limit (NVIDIA's, dense rates)
PEAK_FLOPS = 989.4e12    # bf16 tensor-core FLOP/s, H100 SXM5 80GB HBM3, 700 W
HBM_BW = 3.35e12         # HBM3 bytes/s, H100 SXM5 80GB HBM3, 700 W
NVLINK_BW = 450e9        # NVLink bytes/s a direction, within a node of 8
NET_BW = 50e9            # one 400 Gb/s NIC a GPU: groups that span nodes
HBM_BYTES = 80e9         # device memory of an H100 SXM5 80GB HBM3
NODE_GPUS = 8            # GPUs a node (NVLink joins them all to all)
#: bytes of a host scalar the reference passes as an int32 array (the
#: step, the optimizer's count, the decode position)
SCALAR_BYTES = 4


def _sharding_config(mesh, dp_over_model: bool = False) -> ShardingConfig:
    data = data_axes_of(mesh)
    if dp_over_model:
        data = data + ("model",)
    return ShardingConfig(enabled=True, data_axes=data, model_axis="model",
                          fsdp_axes=data)


def fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of `world` ranks
    (a group of another size, or of another backend, is destroyed first).
    Nothing is sent: every collective completes at once."""
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_shape(multi_pod: bool) -> Tuple[int, ...]:
    return (2, 16, 16) if multi_pod else (16, 16)


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size()
               for t in op_analysis._tensors(tree))


def _link_bw(group) -> float:
    """The per-direction link rate of a process group: NVLink where its
    ranks share one node of NODE_GPUS consecutive ranks, else the NIC's."""
    ranks = dist.get_process_group_ranks(group)
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) <= 1 \
        else NET_BW


def _axis_bw(mesh) -> Dict[str, float]:
    """{axis: link bytes/s} of the mesh's axes (rank 0's groups)."""
    if mesh is None:
        return {}
    return {name: _link_bw(mesh.get_group(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def _cache_layout(caches: Any, cfg, mesh, b_dims: Tuple[int, ...]) -> Any:
    """This rank's caches as the layers read them: the batch dim cut as
    the batch is (``batch_specs``), a KV cache's kv heads cut over "model"
    where ``cache_specs`` puts them there and the layers split the heads;
    every other dim whole."""
    specs = flatten(cache_specs(caches, cfg, mesh))
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    model = cfg.sharding.model_axis
    tp = mesh.size(names.index(model)) \
        if model in names and model not in cfg.sharding.data_axes else 1

    def leaf(path, t):
        spec = specs[path]
        if t.dim() >= 2:
            for i in b_dims:
                t = t.chunk(mesh.size(i), dim=1)[coord[i]]
        if t.dim() == 5 and tp > 1 and len(spec) > 3 \
                and spec[3] == model and heads_split(cfg, tp):
            i = names.index(model)
            t = t.chunk(tp, dim=3)[coord[i]]
        return t.clone()
    flat = flatten(caches)
    return unflatten(caches, {k: leaf(k, v) for k, v in flat.items()})


def _serve_step(cfg, kind: str, mesh, params: Any, model_split, batch,
                caches, pos: int, b_axes):
    """One prefill or decode step of `params` (DTensors under a mesh, each
    gathered as the train step gathers it; plain tensors without one)."""
    if mesh is None:
        if kind == "prefill":
            return T.prefill(params, cfg, batch, caches)
        return T.decode_step(params, cfg, caches, batch["token"], pos)
    model_dim = mesh.mesh_dim_names.index("model") \
        if "model" in mesh.mesh_dim_names else None
    flat = flatten(params)
    full = {k: _gather(v, (model_dim,) if model_split.get(k) else ())
            for k, v in flat.items()}
    with meshctx.use_mesh(mesh, batch_axes=b_axes):
        p = unflatten(params, full)
        if kind == "prefill":
            return T.prefill(p, cfg, batch, caches)
        return T.decode_step(p, cfg, caches, batch["token"], pos)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             quantized: bool = False,
             overrides: Optional[Dict[str, Any]] = None,
             verbose: bool = True,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             shape_overrides: Optional[Dict[str, Any]] = None,
             fsdp: Optional[bool] = None) -> Dict[str, Any]:
    """One cell's step on ``meta`` with its analysis (module docstring).
    `mesh_shape` None takes the production mesh of `multi_pod`; a tuple
    a mesh of that shape over ("data", "model") or ("pod", "data",
    "model"); () the meshless one-device step.  `shape_overrides`
    replaces fields of the shape (a global batch cut to fit one card);
    `fsdp` None takes the arch's."""
    spec: ArchSpec = get_arch(arch)
    fsdp = spec.fsdp if fsdp is None else fsdp
    shape: ShapeSpec = SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    if mesh_shape is None:
        mesh_shape = production_shape(multi_pod)
        mesh_name = "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"
    else:
        mesh_shape = tuple(mesh_shape)
        mesh_name = ("mesh_" + "x".join(map(str, mesh_shape))
                     if mesh_shape else "meshless")
    mesh = sc = None
    if mesh_shape:
        fake_group(math.prod(mesh_shape))
        axes = ("pod", "data", "model")[-len(mesh_shape):]
        mesh = make_mesh(mesh_shape, axes, device="cpu")
        sc = _sharding_config(mesh, dp_over_model=spec.dp_over_model)
    n_dev = math.prod(mesh_shape) if mesh_shape else 1
    cfg = for_shape(spec, shape, sharding=sc, quantized=quantized)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": shape.kind, "quantized": quantized,
            "n_devices": n_dev, "optimizer": spec.optimizer,
            "fsdp": fsdp, "overrides": {k: str(v) if k == "sharding"
                                         else v
                                         for k, v in (overrides or {})
                                         .items()},
            "global_batch": shape.global_batch, "seq_len": shape.seq_len,
            "device": "meta"}
    t0 = time.time()
    full = T.init_params(cfg, 0, "meta").tree()
    batch = input_specs(cfg, shape)
    pos = shape.seq_len - 1
    args: Dict[str, Any] = {}
    scalars = 0
    b_dims: Tuple[int, ...] = ()
    if mesh is not None:
        b_specs = batch_specs(batch, cfg, mesh)
        lead = "targets" if "targets" in batch else next(
            k for k in batch if k != "pos")
        b_dims = _split_mesh_dims(mesh, b_specs[lead])
    b_axes = [mesh.mesh_dim_names[i] for i in b_dims] if mesh else []

    if shape.kind == "train":
        if mesh is None:
            opt_init, step_fn = build_train_step(cfg, spec.optimizer)
            params = requires_grad_(full)
            opt_state = opt_init(params)
            local_batch = batch
        else:
            p_specs = param_specs(full, cfg, mesh, fsdp=fsdp)
            p_shard = named_shardings(p_specs, mesh)
            split = model_split_leaves(p_specs, cfg, mesh)
            params = map_tree(_distribute, full, p_shard)
            opt_init, _ = make_optimizer(spec.optimizer)
            with torch.no_grad():
                local = opt_init(map_tree(lambda v: v.to_local(), params))
            o_specs = opt_state_specs(local, p_specs, params)
            o_shard = dict(named_shardings(o_specs, mesh), count=None)
            opt_state = {k: v if k == "count" else map_tree(
                _from_local, v, o_shard[k]) for k, v in local.items()}
            step_fn = build_mesh_train_step(cfg, spec.optimizer, mesh,
                                            p_shard, split)
            local_batch = {k: _rows(v, mesh, _split_mesh_dims(
                mesh, b_specs[k])) for k, v in batch.items()}
        del full
        args = {"params": params, "opt_state": opt_state, "batch": batch}
        part = {"param_bytes": _nbytes(params),
                "opt_state_bytes": _nbytes(opt_state)}
        arg_bytes = part["param_bytes"] + part["opt_state_bytes"] \
            + _nbytes(local_batch)
        scalars = 1                                     # the step

        def run():
            step_fn(params, opt_state, batch, 0)
    else:
        if quantized:
            full = quantized_param_shapes(full).tree()
        caches = T.init_caches(cfg, shape.global_batch, shape.seq_len,
                               torch.bfloat16, "meta")
        split: Dict[str, bool] = {}
        if mesh is None:
            params, local_batch = full, dict(batch)
        else:
            p_specs = param_specs(full, cfg, mesh, fsdp=fsdp)
            split = model_split_leaves(p_specs, cfg, mesh)
            params = map_tree(_distribute, full,
                              named_shardings(p_specs, mesh))
            caches = _cache_layout(caches, cfg, mesh, b_dims)
            local_batch = {k: v if k == "pos" else _rows(
                v, mesh, _split_mesh_dims(mesh, b_specs[k]))
                for k, v in batch.items()}
        del full
        local_batch.pop("pos", None)
        if shape.kind == "decode":
            scalars = 1                                 # the position
        args = {"params": params, "caches": caches, "batch": local_batch}
        part = {"param_bytes": _nbytes(params),
                "cache_bytes": _nbytes(caches)}
        arg_bytes = part["param_bytes"] + part["cache_bytes"] \
            + _nbytes(local_batch)

        def run():
            with torch.no_grad():
                _serve_step(cfg, shape.kind, mesh, params, split,
                            local_batch, caches, pos, b_axes)
    arg_bytes += scalars * SCALAR_BYTES
    with op_analysis.analyze(op_analysis.mesh_axes(mesh), args) as stats:
        run()
    cell["trace_seconds"] = time.time() - t0
    del args, run

    peak = stats.peak_bytes
    cell["memory"] = {
        "argument_size_in_bytes": float(arg_bytes),
        **{k: float(v) for k, v in part.items()},
        "temp_size_in_bytes": float(peak - stats.argument_bytes),
        "total_bytes_per_device": float(peak),
        "fits_device": bool(peak <= HBM_BYTES),
        "device_bytes": HBM_BYTES,
        "peak_tensors": stats.peak_tensors,
        "peak_by_site": stats.peak_by_site,
    }
    cell["hlo"] = {
        "dot_flops_per_device": stats.dot_flops,
        "memory_bytes_per_device": stats.memory_bytes,
        "collective_bytes_per_device": stats.collective_bytes,
        "collective_counts": stats.collective_counts,
        "collective_bytes_by_axis": stats.collective_bytes_by_axis,
        "collective_counts_by_axis": stats.collective_counts_by_axis,
        "kernels": {k: dict(calls=int(c), flops=f, bytes=b)
                    for k, (c, f, b) in stats.kernels.items()},
        "top_ops_by_flops": stats.top_ops("flops", 10),
        "top_ops_by_bytes": stats.top_ops("bytes", 10),
        "n_ops": stats.n_ops,
    }

    # ---- roofline terms (seconds) ----
    bw = _axis_bw(mesh)
    comp_t = stats.dot_flops / PEAK_FLOPS
    mem_t = stats.memory_bytes / HBM_BW
    coll_t = sum(sum(by.values()) / bw.get(axis, NET_BW)
                 for axis, by in stats.collective_bytes_by_axis.items())
    dominant = max((("compute", comp_t), ("memory", mem_t),
                    ("collective", coll_t)), key=lambda kv: kv[1])[0]
    m = cfg
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * m.n_active_params * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * m.n_active_params * tokens
    else:
        tokens = shape.global_batch * 1
        model_flops = 2.0 * m.n_active_params * tokens
    hlo_total = stats.dot_flops * n_dev
    cell["roofline"] = {
        "compute_term_s": comp_t,
        "memory_term_s": mem_t,
        "collective_term_s": coll_t,
        "dominant": dominant,
        "model_flops_total": model_flops,
        "hlo_flops_total": hlo_total,
        "useful_flops_ratio": model_flops / hlo_total if hlo_total else 0.0,
        "roofline_fraction": (
            max(comp_t, 0.0) / max(comp_t, mem_t, coll_t)
            if max(comp_t, mem_t, coll_t) > 0 else 0.0),
        "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                  "link_bytes_per_s": bw,
                  "card": "H100 SXM5 80GB HBM3, 700 W (datasheet)"},
    }
    cell["n_params"] = m.n_params
    cell["n_active_params"] = m.n_active_params
    if verbose:
        r = cell["roofline"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}"
              f"{' int8' if quantized else ''}: "
              f"trace={cell['trace_seconds']:.1f}s "
              f"compute={r['compute_term_s']*1e3:.2f}ms "
              f"memory={r['memory_term_s']*1e3:.2f}ms "
              f"collective={r['collective_term_s']*1e3:.2f}ms "
              f"dominant={r['dominant']} "
              f"useful={r['useful_flops_ratio']:.2f} "
              f"mem/dev={peak / 2**30:.2f}GiB "
              f"{'fits' if cell['memory']['fits_device'] else 'exceeds'} "
              f"{HBM_BYTES / 1e9:.0f} GB", flush=True)
    return cell


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi_pod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 PTQ weights on serve cells (VTA path)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf loop)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi_pod": [True],
              "both": [False, True]}[args.mesh]
    overrides = json.loads(args.override) if args.override else None

    if args.all:
        todo = []
        for a in list_archs():
            for s in get_arch(a).shapes:
                todo.append((a, s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]

    failures = []
    over = []
    for arch, shape in todo:
        for mp in meshes:
            try:
                cell = run_cell(arch, shape, mp, quantized=args.quantized,
                                overrides=overrides)
                tag = ("__int8" if args.quantized else "") + \
                    (f"__{args.tag}" if args.tag else "")
                name = (f"{arch}__{shape}__"
                        f"{'multi' if mp else 'single'}{tag}.json")
                with open(os.path.join(args.out, name), "w") as f:
                    json.dump(cell, f, indent=1)
                if not cell["memory"]["fits_device"]:
                    over.append((arch, shape, mp, cell["memory"][
                        "total_bytes_per_device"] / 1e9))
            except Exception as e:
                traceback.print_exc()
                failures.append((arch, shape, mp, str(e)))
    if over:
        print(f"\n{len(over)} cells above {HBM_BYTES / 1e9:.0f} GB a device:")
        for o in over:
            print("  ", o)
    if failures:
        print(f"\n{len(failures)} FAILED CELLS:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(todo) * len(meshes)} cells traced OK")


if __name__ == "__main__":
    main()
