"""Multi-pod dry run, host only.

Ported from ``src/repro/launch/dryrun.py``.  For every (architecture x
input-shape x mesh) cell: start a ``fake`` process group of 256 or 512
ranks in this one process (it stands for rank 0; collectives move
nothing), build the production mesh, and run the REAL step function (the
launcher's ``train_step``, ``prefill`` or ``serve_step``) once on sharded
inputs under ``FakeTensorMode`` (shapes, no storage, no arithmetic), with
``FlopCounterMode``, ``CommDebugMode``, ``analysis.op_analysis.OpCostLog``
(product FLOPs, HBM bytes at the eager op boundary, every collective's
bytes, wire bytes and group size) and ``MemTracker`` around it.  Nothing
runs on a card: the record says ``"device": "none (host-only fake
tensors)"``.

The record (``<stem>.json``) keeps the reference's keys where they mean
something here:

* ``memory.argument_bytes_per_device``: the inputs' local shard shapes
  under the sharding rules (parameters, AdamW moments and step, batch; or
  parameters, cache and tokens);
* ``memory.temp_peak_bytes_per_device``: ``MemTracker``'s peak over the
  step, of what the step allocates (the inputs exist before it starts);
  ``memory.peak_estimate_per_device``: the two added, as the reference adds
  XLA's argument and temp sizes;
* ``cost_analysis.flops``: the FLOPs ``FlopCounterMode`` counts.  Every
  product of the mesh paths runs on local shards under ``local_map``, so
  the count is one device's (rank 0's); ``model_flops`` (6·N·T for train,
  2·N·T otherwise, over all devices) and ``useful_ratio`` (model FLOPs per
  device over the counted ones) beside it;
* ``collectives``: ``CommDebugMode``'s counts by op, and bytes (each
  collective's input on this rank) by op and by group size;
* ``analysis``: ``OpCostLog``'s summary (the reference's
  ``analyze_hlo_text`` keys, one device's), with ``roofline``, its
  ``roofline_terms`` on ``H100_SXM``; ``analysis/roofline.py``'s
  ``analyze_report_dir`` makes the table of a directory of records.

No HLO is written (there is none).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.analysis.op_analysis import OpCostLog
from repro_torch.analysis.roofline import H100_SXM, model_flops, roofline_terms


def _cell(cfg, shape, mesh, *, microbatches, compress, fsdp, remat, tp):
    """The step function and its sharded fake arguments, and the inputs'
    bytes on one device (from the local shard shapes)."""
    from repro_torch.distributed.sharding import (
        batch_specs, cache_specs, distribute, local_bytes, param_specs, shard_cache,
        shard_params)
    from repro_torch.distributed import spmd
    from repro_torch.launch.specs import input_specs
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step

    specs = input_specs(cfg, shape)
    model = specs["params"]
    p_specs = param_specs(model, cfg, mesh, fsdp=fsdp, tp=tp)
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    arg_bytes = local_bytes(shapes, p_specs, mesh)
    shard_params(model, p_specs, mesh)
    if shape.kind == "train":
        moments = {n: (s, torch.float32) for n, (s, _) in shapes.items()}
        arg_bytes += 2 * local_bytes(moments, p_specs, mesh) + 4      # mu, nu, step
        b_specs = batch_specs(cfg, mesh, shape.global_batch, include_model=not tp)
        batch = {k: distribute(v, b_specs[k], mesh) for k, v in specs["batch"].items()}
        arg_bytes += local_bytes({k: (tuple(v.shape), v.dtype) for k, v in batch.items()},
                                 b_specs, mesh)
        # the moments input_specs made beside the whole parameters, laid out
        # as their parameters
        opt_state = specs["opt_state"]
        for key in ("mu", "nu"):
            opt_state[key] = {n: distribute(m, p_specs[n], mesh)
                              for n, m in opt_state[key].items()}
        step = make_train_step(cfg, AdamWConfig(), mesh, microbatches=microbatches,
                               compress_pod_grads=compress, remat=remat)
        model.requires_grad_(True)
        return (lambda: step(model, opt_state, batch)), arg_bytes
    if shape.kind == "prefill":
        b_specs = batch_specs(cfg, mesh, shape.global_batch)
        batch = {k: distribute(v, b_specs[k], mesh) for k, v in specs["batch"].items()}
        arg_bytes += local_bytes({k: (tuple(v.shape), v.dtype) for k, v in batch.items()},
                                 b_specs, mesh)
        step = make_prefill_step(cfg, mesh)
        return (lambda: step(model, batch)), arg_bytes
    c_specs = cache_specs(cfg, mesh, shape.global_batch)
    cache = specs["cache"]
    arg_bytes += local_bytes({k: (tuple(v.shape), v.dtype) for k, v in cache.items()
                              if k != "len"}, c_specs, mesh) + 4             # len
    cache = shard_cache(cache, cfg, mesh)
    tok_spec = (spmd.bspec(mesh, shape.global_batch),)
    tokens = distribute(specs["tokens"], tok_spec, mesh)
    arg_bytes += local_bytes({"tokens": (tuple(tokens.shape), tokens.dtype)},
                             {"tokens": tok_spec}, mesh)
    step = make_serve_step(cfg, mesh)

    def serve():
        with torch.inference_mode():
            return step(model, cache, tokens)
    return serve, arg_bytes


def _process_group(world: int) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_process_group

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    fake_process_group(world)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Optional[str], *,
             microbatches: int = 1, compress: bool = False, fsdp: bool = True,
             remat: bool = True, tp: bool = True, tag: str = "", reduced: bool = False
             ) -> Dict:
    """One cell: its record (written to ``out_dir/<stem>.json`` when given).
    ``reduced`` takes the arch's reduced config (the shapes stay the
    cell's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.distributed.sharding import mesh_axes
    from repro_torch.launch.mesh import PRODUCTION, make_production_mesh
    from repro_torch.models.config import SHAPES

    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    shape = SHAPES[shape_name]
    world = int(np.prod(PRODUCTION[multi_pod][0]))
    _process_group(world)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    with FakeTensorMode():
        run, arg_bytes = _cell(cfg, shape, mesh, microbatches=microbatches,
                               compress=compress, fsdp=fsdp, remat=remat, tp=tp)
        flops = FlopCounterMode(display=False)
        comm = CommDebugMode()
        log = OpCostLog(world)
        mem = MemTracker()
        with mem:
            with flops, comm, log:
                run()
        peak = mem.get_tracker_snapshot("peak")
    elapsed = time.time() - t0
    temp_bytes = max((int(v.get("Total", 0)) for v in peak.values()), default=0)
    counted = float(flops.get_total_flops())
    mf = model_flops(cfg, shape)
    analysis = log.summary()
    analysis["roofline"] = roofline_terms(analysis, world, cfg, shape, H100_SXM)
    result = {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": "x".join(f"{k}={v}" for k, v in mesh_axes(mesh).items()),
        "devices": world,
        "kind": shape.kind,
        "device": "none (host-only fake tensors)",
        "trace_s": round(elapsed, 1),
        "memory": {
            "argument_bytes_per_device": int(arg_bytes),
            "temp_peak_bytes_per_device": temp_bytes,
            "peak_estimate_per_device": int(arg_bytes) + temp_bytes,
        },
        "cost_analysis": {"flops": counted},
        "model_flops": mf,
        "useful_ratio": (mf / world) / max(counted, 1.0),
        "collectives": {
            "counts": {str(k): int(v) for k, v in comm.get_comm_counts().items()},
            "count_by_op": dict(log.count_by_op),
            "bytes_by_op": dict(log.bytes_by_op),
            "bytes_by_group_size": {str(k): v for k, v in sorted(log.bytes_by_group.items())},
        },
        "analysis": analysis,
        "flags": {"microbatches": microbatches, "compress": compress,
                  "fsdp": fsdp, "remat": remat, "tp": tp, "reduced": reduced},
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        stem = (f"{arch.replace('.', '_')}_{shape_name}_{'pod2' if multi_pod else 'pod1'}"
                f"{'_reduced' if reduced else ''}{tag}")
        with open(os.path.join(out_dir, stem + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="both")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-tp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs at the cells' shapes")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS, all_cells, shape_cells

    if args.all:
        cells = [(a, s.name) for a, s in all_cells()]
    else:
        archs = [args.arch] if args.arch else ARCH_IDS
        cells = [(a, n) for a in archs
                 for n in ([args.shape] if args.shape else [s.name for s in shape_cells(a)])]
    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    failures = []
    for arch, shape_name in cells:
        for mp in pods:
            label = f"{arch} x {shape_name} x {'2-pod(512)' if mp else '1-pod(256)'}"
            try:
                res = run_cell(arch, shape_name, mp, args.out,
                               microbatches=args.microbatches, compress=args.compress,
                               fsdp=not args.no_fsdp, remat=not args.no_remat,
                               tp=not args.no_tp, tag=args.tag, reduced=args.reduced)
                print(f"OK   {label}: args/dev={res['memory']['argument_bytes_per_device'] / 1e9:.3f}GB "
                      f"peak/dev={res['memory']['peak_estimate_per_device'] / 1e9:.2f}GB "
                      f"flops/dev={res['cost_analysis']['flops']:.3e} "
                      f"useful={res['useful_ratio']:.2f} trace={res['trace_s']}s", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((label, repr(e)))
                print(f"FAIL {label}: {e}", flush=True)
                traceback.print_exc()
    print(f"\n{len(cells) * len(pods) - len(failures)} passed, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
