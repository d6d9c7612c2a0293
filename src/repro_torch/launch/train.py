"""Fault-tolerant training launcher.

Ported from ``src/repro/launch/train.py``, with its survival story on one
device:
  * resume: on start, restore the newest valid checkpoint in --ckpt-dir
    (atomic commits mean a SIGKILL mid-write never corrupts; the preemption
    test kills -9 and resumes bitwise-identically);
  * deterministic data: the stream is counter-keyed by (seed, step, host),
    so resuming at step k replays exactly batch k without reading history;
  * straggler mitigation: an input prefetch thread and a per-step deadline
    watchdog (steps slower than --straggler-factor x the median are logged
    and counted);
  * SIGTERM (preemption notice): checkpoint at once, exit 0.

``--device`` is new (``cuda`` by default, which raises where there is no
card).  Exits with code 2 where the reference differs: a ``--model-parallel``
below 1, and an encdec arch,
whose audio frontend is stubbed in both packages so no encoder inputs exist
(the reference's launcher ends in an ``AttributeError`` there).  Like the
reference's, it passes no vision patches: a vlm trains as its LM.

Meshes: under ``torchrun --nproc-per-node W``, or with ``--model-parallel
N`` other than 1, the ranks join one process group on ``--backend``
(``nccl`` on cuda, ``gloo`` on cpu unless given; printed), build
``launch/mesh.py::make_host_mesh(N)``, i.e. (data=W // N, model=N), shard
the parameters (``distributed.sharding``: FSDP over data, tensor and
expert parallel over model) and train on DTensors; each rank holds the
same seeded weights and reads the same token stream, and keeps its
shards.  Rank 0 prints and writes the checkpoints, which are gathered
whole, so a run restores onto any mesh.  With neither, no process group is
made and the step is the single-device one.  Ranks on one card share it
(``cuda:LOCAL_RANK`` modulo the card count); NCCL refuses that, so give
``--backend gloo``, for which ``launch/mesh.py::init_ranks`` routes the
functional all-gather of CUDA tensors through the c10d call (PyTorch
2.11's crashes on them) and says so on stderr.

Usage (reduced config, CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --reduced --device cpu --steps 20 --ckpt-dir /tmp/ckpt --ckpt-every 5
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch llama3_2_1b \\
      --reduced --device cpu --model-parallel 2 --steps 4
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import Optional


def state_tree(model, opt_state):
    """The checkpoint's tree of ``model`` and its AdamW state, in the
    reference launcher's layout: ``params`` and ``opt`` (``mu``, ``nu``,
    ``step``), the layers stacked (``models/weights.py::tensor_tree``)."""
    from repro_torch.models.weights import tensor_tree

    return {"params": tensor_tree(model),
            "opt": {"mu": tensor_tree(model, opt_state["mu"]),
                    "nu": tensor_tree(model, opt_state["nu"]),
                    "step": opt_state["step"]}}


def restore_state(ckpt_dir: str, model, opt_state) -> Optional[int]:
    """Load the newest checkpoint in ``ckpt_dir`` (``state_tree``'s layout)
    into ``model`` and its AdamW state, in place; returns its step, or
    ``None`` where there is none."""
    from repro_torch.models.weights import load_tree
    from repro_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

    newest = latest_checkpoint(ckpt_dir)
    if newest is None:
        return None
    _, state = restore_checkpoint(ckpt_dir, newest, state_tree(model, opt_state))
    load_tree(model, state["params"])
    load_tree(model, state["opt"]["mu"], values=opt_state["mu"])
    load_tree(model, state["opt"]["nu"], values=opt_state["nu"])
    opt_state["step"] = state["opt"]["step"].to(opt_state["step"].device)
    return newest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--sleep-per-step", type=float, default=0.0)  # test hook
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="process-group backend of a mesh run: nccl, gloo (default: "
                         "nccl on cuda, gloo on cpu)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core.device import resolve_device
    from repro_torch.distributed.sharding import (
        batch_specs, distribute, mesh_axes, param_specs, shard_params)
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.data import DataConfig, PrefetchIterator, TokenStream

    try:
        cfg = (get_reduced_config(args.arch) if args.reduced
               else get_config(args.arch))
    except KeyError as e:
        print(f"repro_torch.launch.train: {e}", file=sys.stderr)
        return 2
    if args.model_parallel < 1:
        print(f"--model-parallel {args.model_parallel}: the model axis needs at least one "
              f"rank", file=sys.stderr)
        return 2
    if cfg.encdec:
        print(f"{cfg.name}: encdec trains on encoder inputs from its audio frontend, "
              f"which is stubbed; this launcher has none to give it", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    mesh, rank = None, 0
    sharded = args.model_parallel != 1 or "WORLD_SIZE" in os.environ
    if sharded:
        backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
        world = init_ranks(backend, dev.type)
        rank = torch.distributed.get_rank()
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                               % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        mesh = make_host_mesh(args.model_parallel, device_type=dev.type)
        if rank == 0 and not args.quiet:
            print(f"mesh {dict(mesh_axes(mesh))} over {world} ranks, backend {backend}, "
                  f"device {dev.type}", flush=True)
    args.quiet = args.quiet or rank != 0
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps)

    model = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    if mesh is not None:
        shard_params(model, param_specs(model, cfg, mesh), mesh)
        bspecs = batch_specs(cfg, mesh, args.batch)
    opt_state = adamw_init(dict(model.named_parameters()))
    start_step = 0

    if args.ckpt_dir:
        newest = restore_state(args.ckpt_dir, model, opt_state)
        if newest is not None:
            start_step = newest
            if not args.quiet:
                print(f"resumed from step {newest}", flush=True)

    train_step = make_train_step(cfg, opt_cfg, mesh, microbatches=args.microbatches)
    data = TokenStream(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed))
    it = PrefetchIterator(data, start_step=start_step)

    stop = {"now": False}

    def on_sigterm(signum, frame):
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, on_sigterm)

    step_times = []
    stragglers = 0
    step = start_step
    try:
        while step < args.steps:
            t0 = time.perf_counter()
            step, batch = next(it)
            if step >= args.steps:
                break
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            if mesh is not None:
                tb = {k: distribute(v, bspecs[k], mesh) for k, v in tb.items()}
            model, opt_state, metrics = train_step(model, opt_state, tb)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if args.sleep_per_step:
                time.sleep(args.sleep_per_step)
            step_times.append(dt)
            med = float(np.median(step_times[-20:]))
            if len(step_times) > 3 and dt > args.straggler_factor * med:
                stragglers += 1
                if not args.quiet:
                    print(f"straggler: step {step} took {dt:.2f}s "
                          f"(median {med:.2f}s)", flush=True)
            if not args.quiet:
                print(f"step {step + 1}/{args.steps} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s",
                      flush=True)
            step += 1
            if args.ckpt_dir and (step % args.ckpt_every == 0 or step == args.steps
                                  or stop["now"]):
                tree = state_tree(model, opt_state)     # every rank gathers
                if rank == 0:
                    save_checkpoint(args.ckpt_dir, step, tree, keep=args.keep)
            if stop["now"]:
                if not args.quiet:
                    print("SIGTERM: checkpointed, exiting", flush=True)
                break
    finally:
        it.close()
        signal.signal(signal.SIGTERM, previous)
    if sharded:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    if not args.quiet:
        print(f"done at step {step}; stragglers flagged: {stragglers}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
