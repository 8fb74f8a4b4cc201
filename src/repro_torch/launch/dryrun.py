"""Dry-run: trace every (arch x shape x mesh) cell's step on meta tensors.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for 256 or 512 placeholder TPU devices. The port has no
compiler to ask for a sharded program, so this describes the program the
port runs on that mesh, traced once on one rank:

- the mesh is a ``DeviceMesh`` over a fake process group of the mesh's
  size (``fake_world``): this process is rank 0, and the c10d operations
  the step dispatches are counted (``launch/step_analysis.py``) but move
  no data;
- the train cells of the transformer, dense or with experts (olmoe-1b-7b,
  arctic-480b), of Zamba2 and of xLSTM run the sharded step
  (``"param_placement": "sharded"``, ``train/train_step.py``'s
  ``sharded=True``): parameters, gradients, AdamW state and the batch are
  rank 0's shards, placed by ``build_cell``'s placements, each layer's
  weights gathered over "data" inside its remat body, its tensor parallel
  parts reduced over "model", its experts rank 0's block over "model"
  with the router gathered whole, Mamba2's SSD over rank 0's heads and
  the recurrent blocks split as ``models/ssm.py`` and ``models/xlstm.py``
  say (``distributed/collectives.py``, ``models/moe.py``). Rank 0 is
  representative: the placements are symmetric;
- the transformer's prefill, encode and decode cells (dense, MoE and the
  two frontends) run the sharded serve steps the same way, without
  autograd: rank 0's parameter shards in ``cfg.dtype``, its batch rows
  and, at decode, its block of the cache split by sequence over "model"
  (B >= 8) or "data" (B 1), each step gathering every layer's weights
  over "data" (their wire bytes are in the record); on such a block a
  decode step's owner-only write is traced as rank 0 owning every row;
- every other cell (ring attention, Zamba2's and xLSTM's prefill and
  decode) holds its tensors whole on every rank (``"param_placement":
  "replicated"``, and ``"replicated_because"`` says why): the train step
  computes on this
  rank's data-parallel rows and all-reduces the gradients; prefill, encode
  and decode run whole;
- the memory figures are the traced step's (``StepAnalysis.finish``), and
  the roofline terms divide its counts by ``core.cost.H100_SXM``'s peaks;
- the record is rank 0's: where ranks' work differs (under
  ``attn_impl="ring"`` a causal ring's rank 0 attends to its diagonal
  block alone), it is that rank's.

``--mesh card`` is the (1, 1) ("data", "model") mesh of one H100: a cell
the card can hold is traced exactly as it runs there (on one device the
replicated step).

The ``hlo`` section keeps the reference's key for the counts that
``step_analysis`` fills; ``trace_s`` takes the place of ``lower_s`` and
``compile_s``. Nothing runs at import.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from contextlib import contextmanager

from ..configs import ARCH_NAMES, SHAPES, get_config, get_shape, runnable
from ..core.cost import H100_SXM
from ..distributed.sharding import ShardingRules, activate_rules
from .input_specs import build_cell, cell_placement, shape_rule_overrides
from .mesh import PRODUCTION_MESHES
from .step_analysis import analyze_step

#: mesh kind -> (shape, dimension names)
MESHES = {"single": PRODUCTION_MESHES[False],
          "multi": PRODUCTION_MESHES[True],
          "card": ((1, 1), ("data", "model"))}


@contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, for the
    CPU, meta and CUDA devices: collectives dispatch and move nothing.
    Raises if a process group is already initialised."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; "
                           "one is already initialised")
    dist.init_process_group("cpu:fake,meta:fake,cuda:fake",
                            store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextmanager
def fake_mesh(mesh_kind):
    """Rank 0's ``DeviceMesh`` of ``mesh_kind`` (a key of ``MESHES``, or
    (shape, dimension names)) over a ``fake_world`` of its size."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh_shape, names = (MESHES[mesh_kind] if isinstance(mesh_kind, str)
                         else mesh_kind)
    with fake_world(math.prod(mesh_shape)):
        yield init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, microbatches: int = 1,
             rule_overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = get_shape(shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "config_overrides": overrides or {},
              "microbatches": microbatches,
              "rule_overrides": rule_overrides or {}}
    ok, why = runnable(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    result.update(analyze_cell(cfg, shape, mesh_kind,
                               microbatches=microbatches,
                               rule_overrides=rule_overrides))
    return result


def _placement(cfg, shape, n_dev: int):
    """(placement, why it is replicated) of a cell's traced step."""
    default, why = cell_placement(cfg, shape)
    if default == "replicated":
        return default, why
    if n_dev == 1:
        return "replicated", ("one device holds the cell whole: the "
                              "replicated step")
    return "sharded", ""


def cell_rules(cfg, shape, mesh, rule_overrides: dict | None = None):
    """The cell's ``ShardingRules`` over ``mesh``: the arch's overrides, the
    shape's and ``rule_overrides``."""
    return ShardingRules(mesh, {**cfg.sharding_overrides,
                                **shape_rule_overrides(cfg, shape),
                                **(rule_overrides or {})})


def analyze_cell(cfg, shape, mesh_kind, *, opt_cfg=None,
                 microbatches: int = 1,
                 rule_overrides: dict | None = None) -> dict:
    """Trace ``cfg``'s step at ``shape`` on rank 0 of the ``mesh_kind`` mesh
    (``fake_mesh``'s argument) -> the record's status, placement, memory,
    step counts and roofline. A cell that ``cell_placement`` calls sharded
    traces the sharded step on a mesh of more than one device, the
    replicated step on one (as a card runs it)."""
    with fake_mesh(mesh_kind) as mesh:
        n_dev = mesh.size()
        placement, why = _placement(cfg, shape, n_dev)
        rules = cell_rules(cfg, shape, mesh, rule_overrides)
        step, args, _ = build_cell(cfg, shape, rules, opt_cfg=opt_cfg,
                                   microbatches=microbatches,
                                   placement=placement)
        t0 = time.perf_counter()
        with activate_rules(rules):
            _, rep, mem = analyze_step(step, args)
        t_trace = time.perf_counter() - t0

    chip = H100_SXM
    model_flops = _model_flops(cfg, shape)
    t_compute = rep.dot_flops / chip.peak_bf16_flops
    t_memory = rep.bytes_accessed / chip.hbm_bandwidth
    t_memory_fused = rep.bytes_accessed_fused / chip.hbm_bandwidth
    t_collective = rep.collective_wire_bytes / chip.nvlink_bandwidth
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    bottleneck = max(terms, key=terms.get)
    model_time = model_flops / (n_dev * chip.peak_bf16_flops)
    placed = {"param_placement": placement}
    if why:
        placed["replicated_because"] = why
    return {
        "status": "ok", "devices": n_dev, "chip": chip.name, **placed,
        "trace_s": round(t_trace, 2),
        "memory": {**mem,
                   "peak_live_bytes": rep.peak_live_bytes,
                   "fits_hbm": bool(mem["per_device_total"]
                                    <= chip.hbm_bytes)},
        "hlo": {"dot_flops": rep.dot_flops, "dot_count": rep.dot_count,
                "kernel_region_flops": rep.kernel_region_flops,
                "bytes_accessed": rep.bytes_accessed,
                "bytes_accessed_fused": rep.bytes_accessed_fused,
                "kernel_region_bytes": rep.kernel_region_bytes,
                "collective_wire_bytes": rep.collective_wire_bytes,
                "collective_by_op": rep.collective_by_op,
                "collective_count": rep.collective_count,
                "kernel_regions": rep.kernel_regions,
                "ops": rep.ops, "devices_seen": sorted(rep.devices)},
        "roofline": {**terms, "memory_fused_s": t_memory_fused,
                     "bottleneck": bottleneck,
                     "model_flops": model_flops,
                     "hlo_flops_global": rep.dot_flops * n_dev,
                     "useful_flops_ratio":
                         model_flops / max(rep.dot_flops * n_dev, 1e-30),
                     "model_time_s": model_time,
                     "roofline_fraction":
                         model_time / max(max(terms.values()), 1e-30)},
    }


def _model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS per step: 6·N_active·D train, 2·N_active·D fwd."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def cell_path(out_dir: str, arch: str, shape: str, mesh: str,
              tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{suffix}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both", "card"],
                    default="single")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="", help="artifact suffix (perf variants)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding rule logical=mesh_axis (repeatable)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = _coerce(v)
    rule_overrides = {}
    for kv in args.rule:
        k, v = kv.split("=", 1)
        rule_overrides[k] = None if v in ("none", "None") else (
            tuple(v.split(",")) if "," in v else v)

    cells = []
    if args.all:
        for arch in ARCH_NAMES:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape required unless --all")
        cells.append((args.arch, args.shape))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for mesh_kind in meshes:
            path = cell_path(args.out, arch, shape, mesh_kind, args.tag)
            if args.skip_existing and os.path.exists(path):
                continue
            try:
                res = run_cell(arch, shape, mesh_kind, overrides,
                               args.microbatches, rule_overrides)
            except Exception as e:  # noqa: BLE001 - record and continue
                res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-2000:]}
                failures += 1
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            _print_summary(res)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    return v


def _print_summary(res: dict) -> None:
    if res["status"] == "ok":
        r = res["roofline"]
        m = res["memory"]
        print(f"[ok]   {res['arch']:<18} {res['shape']:<12} {res['mesh']:<6} "
              f"{res['param_placement']:<10} trace={res['trace_s']:6.1f}s "
              f"mem/dev={m['per_device_total']/2**30:8.2f}GiB "
              f"fits={m['fits_hbm']} "
              f"terms(c/m/x)={r['compute_s']:.2e}/{r['memory_s']:.2e}/"
              f"{r['collective_s']:.2e}s bottleneck={r['bottleneck']} "
              f"frac={r['roofline_fraction']:.3f}", flush=True)
    elif res["status"] == "skipped":
        print(f"[skip] {res['arch']:<18} {res['shape']:<12} {res['mesh']:<6} "
              f"{res['reason']}", flush=True)
    else:
        print(f"[ERR]  {res['arch']:<18} {res['shape']:<12} {res['mesh']:<6} "
              f"{res['error'][:140]}", flush=True)


if __name__ == "__main__":
    main()
