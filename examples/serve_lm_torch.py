"""Serve a small model with batched requests on the PyTorch/CUDA port — the
port of ``examples/serve_lm.py``: the same model, the same steps and the
same prints, through ``repro_torch``.  Out-of-core mode streams the weights
layer by layer from host memory through the 3-slot schedule, the device's
weight footprint bounded by the window, validated against fully-resident
decoding.

Resident decode runs on the card through ``repro_torch.models.DecodeGraph``
(one CUDA graph a step, as ``python -m repro_torch.launch.serve`` serves),
on the CPU eagerly; the streamed decode runs eagerly on both.  The
modelled step is the streamer's ``hw`` ledger model, not a measurement.

  PYTHONPATH=src python examples/serve_lm_torch.py               # on the GPU
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.models import DecodeGraph, decode_step, init_cache, init_params
from repro_torch.models.offload import StreamedDecoder


def greedy(step, cache, prompts: torch.Tensor, gen: int):
    """``gen`` greedy tokens a row from ``prompts`` (B,) through ``step``
    (``decode_step``'s signature) and the wall seconds they took."""
    tok = prompts
    out = []
    t0 = time.perf_counter()
    for _ in range(gen):
        logits, cache = step(cache, tok)
        tok = torch.argmax(logits, -1)
        out.append(tok)
    if tok.is_cuda:
        torch.cuda.synchronize(tok.device)
    return out, time.perf_counter() - t0


@torch.inference_mode()
def serve(model, prompts: torch.Tensor, gen: int, window: int = 3) -> dict:
    """Greedy decode of ``prompts`` resident (a ``DecodeGraph`` on a card,
    eager ``decode_step`` on the CPU) and streamed through a
    ``StreamedDecoder`` of ``window`` slots, each from a fresh cache."""
    cfg, B = model.cfg, prompts.shape[0]
    dev = model.embed.device
    cache = init_cache(cfg, B, gen + 1, device=dev)
    if dev.type == "cuda":
        step = DecodeGraph(model, cache)
    else:
        def step(c, t):
            return decode_step(model, c, t)
    resident, t_res = greedy(step, cache, prompts, gen)

    # out-of-core serving: weights live in HOST memory, a `window`-slice ring
    streamer = StreamedDecoder(model, window=window)
    cache = init_cache(cfg, B, gen + 1, device=dev)
    streamed, t_str = greedy(streamer.decode, cache, prompts, gen)
    return {"resident": resident, "streamed": streamed, "t_res": t_res,
            "t_str": t_str, "streamer": streamer}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced_config("llama3_2_1b").with_(num_layers=8)
    g = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, generator=g, device=dev)
    B, gen = 4, 16
    prompts = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev)

    run = serve(model, prompts, gen)
    streamer = run["streamer"]
    same = all(bool((a == b).all()) for a, b in zip(run["resident"], run["streamed"]))
    total_w = sum(streamer.layer_nbytes)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"batch={B} gen={gen} tokens")
    print(f"resident : {run['t_res']:.2f}s   (all {cfg.num_layers} layers on device; "
          f"{where})")
    print(f"streamed : {run['t_str']:.2f}s   (window=3 of {cfg.num_layers} layers; "
          f"device weights {streamer.device_resident_bytes() / 1e6:.1f} MB "
          f"of {total_w / 1e6:.1f} MB total; {where})")
    print(f"greedy outputs identical: {same}")
    print(f"modelled step on {streamer.hw.name} (PCIe streaming, overlapped): "
          f"{streamer.stats.modelled_step_s * 1e3:.2f} ms/token")
    if not same:
        raise AssertionError("streamed greedy outputs differ from resident ones")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
