"""End-to-end training on the PyTorch/CUDA port — the port of
``examples/train_lm.py``: train a llama-style model through the full
production path (the sharded train step on a host mesh, AdamW + cosine
schedule, deterministic data pipeline, periodic checkpointing and resume),
with the same presets, steps and prints, through ``repro_torch``.

The mesh is ``launch/mesh.py::make_host_mesh`` over a process group of this
one rank (``nccl`` on the card, ``gloo`` on the CPU), so the (1, 1) mesh of
(data, model): the parameters and each batch are DTensors on it, as on the
launcher's larger meshes.  Default ("tiny") trains a small model for 40
steps and verifies the loss dropped; ``--preset 100m`` runs a ~100M-param
model (300 steps by default; the intended config on a card).  The step
lines print the loss in full (a float32 round-trips in 9 digits), so two
runs can be compared bit for bit.

  PYTHONPATH=src python examples/train_lm_torch.py [--preset 100m] [--steps N]
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 15
"""
import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import (
    batch_specs, distribute, param_specs, shard_params)
from repro_torch.launch.mesh import init_ranks, make_host_mesh
from repro_torch.launch.train import restore_state, state_tree
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.data import DataConfig, PrefetchIterator, TokenStream


def build_config(preset: str):
    base = get_reduced_config("llama3_2_1b")
    if preset == "tiny":
        return base.with_(num_layers=4, d_model=256, num_heads=8,
                          num_kv_heads=4, head_dim=32, d_ff=512,
                          vocab_size=2048), 8, 128
    # ~100M params
    return base.with_(num_layers=12, d_model=768, num_heads=12,
                      num_kv_heads=4, head_dim=64, d_ff=2048,
                      vocab_size=32000), 8, 512


def init_state(cfg, mesh, dev: torch.device, seed: int = 0):
    """The model drawn from ``seed`` on ``dev``, its parameters sharded on
    ``mesh``, and its AdamW state."""
    model = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    shard_params(model, param_specs(model, cfg, mesh), mesh)
    return model, adamw_init(dict(model.named_parameters()))


def train(cfg, batch: int, seq: int, steps: int, ckpt_dir: str, dev: torch.device) -> dict:
    """Train to ``steps`` on the host mesh of the process group, resuming
    from the newest checkpoint in ``ckpt_dir`` and saving one every 10 steps
    and at the last; returns the metrics of each step run (``loss``,
    ``grad_norm``, ``lr``), by step number."""
    mesh = make_host_mesh(device_type=dev.type)
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=max(5, steps // 10),
                          total_steps=steps)
    model, opt_state = init_state(cfg, mesh, dev)
    start = restore_state(ckpt_dir, model, opt_state) or 0
    if start:
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg, mesh)
    bspecs = batch_specs(cfg, mesh, batch)
    stream = TokenStream(DataConfig(cfg.vocab_size, seq, batch))
    it = PrefetchIterator(stream, start_step=start)
    history = {}
    try:
        while True:
            s, batch_np = next(it)
            if s >= steps:
                break
            t0 = time.perf_counter()
            tb = {k: distribute(torch.from_numpy(v).to(dev), bspecs[k], mesh)
                  for k, v in batch_np.items()}
            model, opt_state, m = step_fn(model, opt_state, tb)
            h = history[s + 1] = {k: float(v) for k, v in m.items()}
            if (s + 1) % 5 == 0 or s == 0:
                print(f"step {s + 1:4d}/{steps} loss={h['loss']:.9g} "
                      f"lr={h['lr']:.2e} ({time.perf_counter() - t0:.2f}s)")
            if (s + 1) % 10 == 0 or s + 1 == steps:
                save_checkpoint(ckpt_dir, s + 1, state_tree(model, opt_state))
    finally:
        it.close()
    return history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, batch, seq = build_config(args.preset)
    steps = args.steps or (40 if args.preset == "tiny" else 300)
    n_params = cfg.param_count()
    print(f"model: {cfg.name}-{args.preset} ({n_params / 1e6:.1f}M params) "
          f"| {steps} steps x batch {batch} x seq {seq}")

    init_ranks("nccl" if dev.type == "cuda" else "gloo", dev.type)
    try:
        history = train(cfg, batch, seq, steps, args.ckpt_dir, dev)
    finally:
        dist.destroy_process_group()
    if not history:
        raise SystemExit(f"{args.ckpt_dir} is already at step {steps}: nothing to train")
    first_loss, loss = history[min(history)]["loss"], history[max(history)]["loss"]
    print(f"loss: {first_loss:.4f} -> {loss:.4f} "
          f"({'improved' if loss < first_loss else 'NO IMPROVEMENT'})")
    if not loss < first_loss:
        raise AssertionError("training failed to reduce loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
