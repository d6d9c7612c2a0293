"""The rank side of tests/test_torch_mesh.py: ``run`` is the target of
``torch.multiprocessing`` spawn, one process a rank of a gloo group on the
CPU.  It imports torch and the port only (no JAX), reads the test's inputs
from ``inputs.npz`` in the work directory, runs the named cases in order,
and writes what each rank produced to ``out<rank>.npz`` there.  The test
holds those against the JAX package."""
from __future__ import annotations

import datetime
import os
import sys
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _tree(inputs, prefix):
    """The nested dict stored under ``prefix/`` (keys joined by ``/``)."""
    out = {}
    for key in inputs.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = inputs[key]
    return out


def _model(arch, inputs, prefix):
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.weights import params_from_numpy

    return params_from_numpy(get_reduced_config(arch), _tree(inputs, prefix), device="cpu")


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _sharded(model, mesh):
    from repro_torch.distributed.sharding import param_specs, shard_params

    return shard_params(model, param_specs(model, model.cfg, mesh), mesh)


def case_shards(rank, inputs, out, work):
    """Every local shard of the reduced Llama on (data=2, model=2)."""
    mesh = _mesh((2, 2), ("data", "model"))
    model = _sharded(_model("llama3_2_1b", inputs, "llama"), mesh)
    for name, p in model.named_parameters():
        out[f"shard/{name}"] = p.to_local().numpy()


def case_forward22(rank, inputs, out, work):
    _forward(rank, inputs, out, (2, 2), "forward22")


def case_forward24(rank, inputs, out, work):
    _forward(rank, inputs, out, (2, 4), "forward24")


def case_forward18(rank, inputs, out, work):
    _forward(rank, inputs, out, (1, 8), "forward18")


def _forward(rank, inputs, out, shape, key):
    import torch

    from repro_torch.distributed.sharding import batch_specs, distribute
    from repro_torch.models import forward

    mesh = _mesh(shape, ("data", "model"))
    model = _sharded(_model("llama3_2_1b", inputs, "llama"), mesh)
    tokens = torch.from_numpy(inputs["tokens"])
    spec = batch_specs(model.cfg, mesh, tokens.shape[0])["tokens"]
    with torch.no_grad():
        logits = forward(model, distribute(tokens, spec, mesh), mesh=mesh).full_tensor()
    out[key] = logits.numpy()


def case_train22(rank, inputs, out, work):
    """Loss and gradients, then one make_train_step step, on (2, 2); and a
    checkpoint of the stepped model written by rank 0 (gathered whole)."""
    import torch

    from repro_torch.distributed.sharding import batch_specs, distribute
    from repro_torch.launch.train import state_tree
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.step import loss_and_grads

    mesh = _mesh((2, 2), ("data", "model"))
    model = _sharded(_model("llama3_2_1b", inputs, "llama"), mesh).requires_grad_(True)
    specs = batch_specs(model.cfg, mesh, inputs["tokens"].shape[0])
    batch = {k: distribute(torch.from_numpy(inputs[k]), specs[k], mesh)
             for k in ("tokens", "labels")}
    loss, grads = loss_and_grads(model, batch, mesh=mesh)
    out["train22/loss"] = loss.numpy()
    for name, g in grads.items():
        out[f"train22/grad/{name}"] = g.full_tensor().numpy()
    state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(model.cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1), mesh)
    _, state, metrics = step(model, state, batch)
    out["train22/step_loss"] = metrics["loss"].numpy()
    out["train22/grad_norm"] = metrics["grad_norm"].numpy()
    for name, p in model.named_parameters():
        out[f"train22/param/{name}"] = p.detach().full_tensor().numpy()
    tree = state_tree(model, state)
    if rank == 0:
        save_checkpoint(str(work / "ckpt"), 1, tree)


def case_adamw22(rank, inputs, out, work):
    """``adamw_update`` on the sharded reduced Llama fed the JAX package's
    gradients (``jgrad/``, stacked over the layers), each rank its shards."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import local_shard
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update

    mesh = _mesh((2, 2), ("data", "model"))
    model = _sharded(_model("llama3_2_1b", inputs, "llama"), mesh)
    tree = _tree(inputs, "jgrad")
    params = dict(model.named_parameters())
    grads = {}
    for name, p in params.items():
        parts = name.split(".")
        node = tree[parts[0]]
        for k in (parts[2:] if parts[0] == "blocks" else parts[1:]):
            node = node[k]
        full = torch.from_numpy(np.array(node[int(parts[1])] if parts[0] == "blocks" else node))
        grads[name] = DTensor.from_local(local_shard(full, p), mesh, p.placements,
                                         run_check=False, shape=p.shape, stride=p.stride())
    state = adamw_init(params)
    adamw_update(params, grads, state, AdamWConfig(peak_lr=1e-3, warmup_steps=1))
    for name, p in params.items():
        out[f"adamw22/param/{name}"] = p.detach().full_tensor().numpy()
        out[f"adamw22/mu/{name}"] = state["mu"][name].full_tensor().numpy()
        out[f"adamw22/nu/{name}"] = state["nu"][name].full_tensor().numpy()


def case_trainpod(rank, inputs, out, work):
    """One make_train_step step with the int8 pod all-reduce on (pod=2,
    data=1, model=2)."""
    import torch

    from repro_torch.distributed.sharding import batch_specs, distribute
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    mesh = _mesh((2, 1, 2), ("pod", "data", "model"))
    model = _sharded(_model("llama3_2_1b", inputs, "llama"), mesh).requires_grad_(True)
    specs = batch_specs(model.cfg, mesh, inputs["tokens"].shape[0])
    batch = {k: distribute(torch.from_numpy(inputs[k]), specs[k], mesh)
             for k in ("tokens", "labels")}
    step = make_train_step(model.cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1), mesh,
                           compress_pod_grads=True)
    _, _, metrics = step(model, adamw_init(dict(model.named_parameters())), batch)
    out["trainpod/loss"] = metrics["loss"].numpy()
    out["trainpod/grad_norm"] = metrics["grad_norm"].numpy()


def case_serve22(rank, inputs, out, work):
    """make_prefill_step and three make_serve_step steps on (2, 2)."""
    import torch

    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import batch_specs, distribute, shard_cache
    from repro_torch.models import init_cache
    from repro_torch.train.step import make_prefill_step, make_serve_step

    mesh = _mesh((2, 2), ("data", "model"))
    model = _sharded(_model("llama3_2_1b", inputs, "llama"), mesh)
    tokens = torch.from_numpy(inputs["tokens"])
    spec = batch_specs(model.cfg, mesh, tokens.shape[0])["tokens"]
    with torch.inference_mode():
        last = make_prefill_step(model.cfg, mesh)(model, {"tokens": distribute(tokens, spec,
                                                                                mesh)})
        out["serve22/prefill"] = last.full_tensor().numpy()
        cache = shard_cache(init_cache(model.cfg, tokens.shape[0], 8, device="cpu"),
                            model.cfg, mesh)
        step = make_serve_step(model.cfg, mesh)
        for t in range(3):
            tok = distribute(tokens[:, t], (spmd.bspec(mesh, tokens.shape[0]),), mesh)
            logits, cache = step(model, cache, tok)
            out[f"serve22/logits{t}"] = logits.full_tensor().numpy()


# the reduced archs of the other families and their prefix in inputs.npz
FAMILIES = (("deepseek_v2_lite_16b", "deepseek"), ("qwen3_moe_30b_a3b", "qwen"),
            ("mamba2_1_3b", "mamba"), ("zamba2_1_2b", "zamba"),
            ("whisper_medium", "whisper"), ("internvl2_76b", "internvl"))
MAX_LEN = 8


def _decode(model, inputs, out, mesh, key, batch, steps):
    """``steps`` make_serve_step steps of the first ``batch`` sequences
    against a ``MAX_LEN`` cache laid out by ``cache_specs`` (encdec's
    ``enc_k``/``enc_v`` filled from the inputs first)."""
    import torch

    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import distribute, shard_cache
    from repro_torch.models import init_cache
    from repro_torch.train.step import make_serve_step

    cfg = model.cfg
    tokens = torch.from_numpy(inputs["tokens"][:batch])
    enc_len = inputs["enc_k"].shape[2] if cfg.encdec else 0
    cache = init_cache(cfg, batch, MAX_LEN, enc_len=enc_len, device="cpu")
    if cfg.encdec:
        for k in ("enc_k", "enc_v"):
            cache[k].copy_(torch.from_numpy(inputs[k][:, :batch]))
    cache = shard_cache(cache, cfg, mesh)
    step = make_serve_step(cfg, mesh)
    with torch.inference_mode():
        for t in range(steps):
            tok = distribute(tokens[:, t], (spmd.bspec(mesh, batch),), mesh)
            logits, cache = step(model, cache, tok)
            out[f"{key}/logits{t}"] = logits.full_tensor().numpy()


def case_families(rank, inputs, out, work):
    """``forward`` of each reduced arch of ``FAMILIES`` on (data=2,
    model=2), with its vision patches or encoder inputs, then three decode
    steps (not the vlm: its decode is the dense one)."""
    import torch

    from repro_torch.distributed.sharding import batch_specs, distribute
    from repro_torch.models import forward

    mesh = _mesh((2, 2), ("data", "model"))
    tokens = torch.from_numpy(inputs["tokens"])
    for arch, prefix in FAMILIES:
        model = _sharded(_model(arch, inputs, prefix), mesh)
        cfg = model.cfg
        specs = batch_specs(cfg, mesh, tokens.shape[0])
        extra = {k: distribute(torch.from_numpy(inputs[k]), specs[k], mesh)
                 for k in ("patches", "enc_inputs") if k in specs}
        with torch.inference_mode():
            logits = forward(model, distribute(tokens, specs["tokens"], mesh), mesh=mesh,
                             **extra)
        out[f"{prefix}/forward"] = logits.full_tensor().numpy()
        if cfg.family != "vlm":
            _decode(model, inputs, out, mesh, f"{prefix}/decode", tokens.shape[0], 3)


def _llama_decode(inputs, out, shape, batch, key):
    mesh = _mesh(shape, ("data", "model"))
    model = _sharded(_model("llama3_2_1b", inputs, "llama"), mesh)
    _decode(model, inputs, out, mesh, key, batch, 6)


def case_decode22b1(rank, inputs, out, work):
    """One sequence on (2, 2): the cache's positions over data, its K/V
    heads over model."""
    _llama_decode(inputs, out, (2, 2), 1, "decode22b1")


def case_decode24(rank, inputs, out, work):
    """Four sequences on (2, 4): 2 K/V heads do not divide model, so the
    cache's positions split over it."""
    _llama_decode(inputs, out, (2, 4), 4, "decode24")


def case_decode24b1(rank, inputs, out, work):
    """One sequence on (2, 4): the positions over data and model."""
    _llama_decode(inputs, out, (2, 4), 1, "decode24b1")


def case_trainmoe(rank, inputs, out, work):
    """One make_train_step step of two microbatches of the reduced
    Qwen3-MoE on (2, 2), the gradients AdamW is given caught on their way
    in, and the rows of each microbatch."""
    import torch

    from repro_torch.distributed.sharding import batch_specs, distribute
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train import step as step_mod

    mesh = _mesh((2, 2), ("data", "model"))
    model = _sharded(_model("qwen3_moe_30b_a3b", inputs, "qwen"), mesh).requires_grad_(True)
    specs = batch_specs(model.cfg, mesh, inputs["tokens"].shape[0])
    batch = {k: distribute(torch.from_numpy(inputs[k]), specs[k], mesh)
             for k in ("tokens", "labels")}
    for i, mb in enumerate(step_mod._microbatches(batch, 2, mesh)):
        out[f"trainmoe/rows{i}"] = mb["tokens"].full_tensor().numpy()
    caught = {}
    original = step_mod.adamw_update

    def catch(params, grads, state, cfg):
        caught.update(grads)
        return original(params, grads, state, cfg)
    step_mod.adamw_update = catch
    try:
        step = make_train_step(model.cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1), mesh,
                               microbatches=2)
        _, _, metrics = step(model, adamw_init(dict(model.named_parameters())), batch)
    finally:
        step_mod.adamw_update = original
    out["trainmoe/loss"] = metrics["loss"].numpy()
    out["trainmoe/grad_norm"] = metrics["grad_norm"].numpy()
    for name, g in caught.items():
        out[f"trainmoe/grad/{name}"] = g.full_tensor().numpy()


def case_compress(rank, inputs, out, work):
    """The int8 pod all-reduce of each rank's row of ``pod_x`` over a
    (pod=4) mesh, its payloads traced; and ``make_pod_grad_allreduce``."""
    import torch

    from repro_torch.distributed.compression import (
        compressed_allreduce_mean, make_pod_grad_allreduce)

    mesh = _mesh((4,), ("pod",))
    x = torch.from_numpy(inputs["pod_x"][rank])
    trace = {}
    out["compress/mean"] = compressed_allreduce_mean(x, mesh.get_group("pod"),
                                                     trace=trace).numpy()
    for k, v in trace.items():
        out[f"compress/{k}"] = v.numpy()
    out["compress/tree"] = make_pod_grad_allreduce(mesh)({"g": x})["g"].numpy()


def case_moe24(rank, inputs, out, work):
    """Layer 0's expert-parallel FFN sublayer of the reduced Qwen3-MoE on
    (data=2, model=4), and each rank's routing of its tokens."""
    import torch

    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import route
    from repro_torch.models.transformer import _ffn_sublayer

    mesh = _mesh((2, 4), ("data", "model"))
    model = _sharded(_model("qwen3_moe_30b_a3b", inputs, "qwen"), mesh)
    cfg = model.cfg
    blk = model.blocks[0]
    h = torch.from_numpy(inputs["moe_h"])
    act = (spmd.bspec(mesh, h.shape[0]), None, None)
    with torch.no_grad():
        y = _ffn_sublayer(blk, distribute(h, act, mesh), cfg, mesh).full_tensor()
        local = distribute(h, act, mesh).to_local()
        x = rms_norm(local, blk.ln2.full_tensor(), cfg.rms_eps)
        r = route(blk.moe.router.full_tensor(), x.reshape(-1, cfg.d_model), cfg)
    out["moe24/out"] = y.numpy()
    out["moe24/topk_idx"] = r.topk_idx.numpy()
    out["moe24/tok_idx"] = r.tok_idx.numpy()
    # the gradients of sum(out * moe_r): the experts' and the tokens' through
    # the two all_to_alls, the replicated weights' summed over model
    blk.requires_grad_(True)
    hd = distribute(h, act, mesh).requires_grad_(True)
    y = _ffn_sublayer(blk, hd, cfg, mesh)
    names, params = zip(*[(n, p) for n, p in blk.named_parameters()
                          if n == "ln2" or n.startswith("moe.")])
    r_ = distribute(torch.from_numpy(inputs["moe_r"]), act, mesh)
    grads = torch.autograd.grad((y * r_).sum().full_tensor(), (hd,) + params)
    out["moe24/grad/h"] = grads[0].full_tensor().numpy()
    for name, g in zip(names, grads[1:]):
        out[f"moe24/grad/{name}"] = g.full_tensor().numpy()


def case_launcher(rank, inputs, out, work):
    """The training launcher's main on these ranks (it ends the group)."""
    from repro_torch.launch import train as launch_train

    out["launcher/rc"] = np.array(launch_train.main(
        ["--arch", "llama3_2_1b", "--reduced", "--device", "cpu", "--model-parallel", "2",
         "--steps", "2", "--seq", "16", "--quiet"]))


def run(rank: int, world: int, port: int, cases, work: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    work = Path(work)
    out = {}
    try:
        with np.load(work / "inputs.npz") as inputs:
            for case in cases:
                globals()[f"case_{case}"](rank, inputs, out, work)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        np.savez(work / f"out{rank}.npz", **out)
    if dist.is_initialized():
        dist.destroy_process_group()
