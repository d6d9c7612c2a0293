"""Serving launchers.

Model decode (the default) runs batched decode with a KV cache: a
teacher-forced prefill over the prompt batch, then greedy decode steps; it
reports tokens/s and the per-step latency.  With ``--offload`` the layer
weights stream from host memory through the out-of-core windowed schedule
(:class:`repro_torch.models.offload.StreamedDecoder`), at most ``--window``
layer slices on the device at any point::

    python -m repro_torch.launch.serve --arch llama3_2_1b            # on the card
    python -m repro_torch.launch.serve --arch llama3_2_1b --reduced --device cpu \\
        --offload

Every family runs resident: on a card through a
:class:`repro_torch.models.DecodeGraph`, one CUDA graph of the step
captured after one warm-up step and replayed every token, as the
reference serves through its jitted step (the line's ``graph_capture`` is
the capture's seconds); on the CPU (``--device cpu``) eagerly.
``--offload`` streams the dense and vlm families, eagerly as the
reference's streamer runs, and exits 2 on the others (moe, ssm, hybrid,
encdec), as the reference's launcher does.  Encdec keeps the reference's
stubbed frontend: its cross-attention caches ``enc_k``/``enc_v``
(``--prompt-len`` positions) are filled with 0.01, not computed by an
encoder pass.  The printed ``modelled`` step time is the ledger's model of
the H100 (``hw`` ``h100-sxm``, the port's default), not a measurement.

The ``stencil`` subcommand runs the multi-tenant
:class:`repro_torch.serve.StencilServer`: N CloverLeaf 2D tenants submitted
from threads onto a shared lane pool with ledger-oracle admission control::

    python -m repro_torch.launch.serve stencil --tenants 4 --mesh sim:2 \\
        --policy sjf --steps 3                   # on the card
    python -m repro_torch.launch.serve stencil --device cpu --tenants 2

Ported from ``src/repro/launch/serve.py``; ``--device`` is new in both
(``cuda`` by default, which raises where there is no card).
"""
from __future__ import annotations

import argparse
import sys
import time


def stencil_main(argv=None) -> int:
    """Serve N stencil tenants through a shared StencilServer."""
    ap = argparse.ArgumentParser(prog="serve stencil")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--mesh", default="sim:2",
                    help="lane pool, e.g. sim:4 or cuda:2 (default sim:2)")
    ap.add_argument("--device", default="cuda",
                    help="where sim lanes run: cuda (default) or cpu")
    ap.add_argument("--policy", default="fifo",
                    help="scheduling policy: fifo | sjf")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--ny", type=int, default=48)
    ap.add_argument("--capacity-mb", type=float, default=4.0,
                    help="per-lane fast-memory capacity (forces tiling)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    import threading

    from repro_torch.apps import CloverLeaf2D
    from repro_torch.serve import StencilServer

    t0 = time.perf_counter()
    with StencilServer(args.mesh, device=args.device, policy=args.policy,
                       capacity_bytes=args.capacity_mb * 1e6) as server:
        errs = []

        def tenant_work(i: int) -> None:
            try:
                app = CloverLeaf2D(nx=args.nx, ny=args.ny,
                                   summary_every=args.steps)
                rt = server.session(f"tenant-{i}", priority=i % 2)
                try:
                    app.run(rt, steps=args.steps)
                finally:
                    rt.close()
            except Exception as e:  # reported after the join, exits 1
                errs.append((i, e))

        threads = [threading.Thread(target=tenant_work, args=(i,))
                   for i in range(args.tenants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = server.stats()
    if errs:
        print(f"tenant failures: {errs}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(stats.summary())
        print(f"wall {time.perf_counter() - t0:.2f}s for "
              f"{stats.jobs_completed} chains across {args.tenants} tenants")
    return 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "stencil":
        return stencil_main(argv[1:])

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--offload", action="store_true",
                    help="stream layer weights from host memory through the "
                         "out-of-core windowed schedule (dense/vlm families)")
    ap.add_argument("--window", type=int, default=3,
                    help="device-resident layer slices with --offload")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core.device import resolve_device
    from repro_torch.models import DecodeGraph, decode_step, init_cache, init_params
    from repro_torch.models.offload import STREAMED_FAMILIES, StreamedDecoder

    try:
        cfg = (get_reduced_config(args.arch) if args.reduced
               else get_config(args.arch))
    except KeyError as e:
        print(f"repro_torch.launch.serve: {e}", file=sys.stderr)
        return 2
    if args.offload and cfg.family not in STREAMED_FAMILIES:
        print(f"--offload supports dense/vlm families, not {cfg.family}",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_params(cfg, generator=gen, device=dev)
    B = args.batch
    max_len = args.prompt_len + args.gen_tokens
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=gen, device=dev)
    cache = init_cache(cfg, B, max_len, enc_len=args.prompt_len, device=dev)
    if cfg.encdec:
        # the stubbed frontend, as the reference's: constant encoder K/V
        cache["enc_k"].fill_(0.01)
        cache["enc_v"].fill_(0.01)

    streamer = graph = None
    if args.offload:
        streamer = StreamedDecoder(model, window=args.window)
        del model.blocks        # the layers now live in host memory only
        step = streamer.decode
    elif dev.type == "cuda":
        step = graph = DecodeGraph(model, cache)
    else:
        def step(c, t):
            return decode_step(model, c, t)

    with torch.inference_mode():
        # prefill = teacher-forced decode over the prompt (exercises the
        # cache write path; a production server would batch-prefill)
        t0 = time.perf_counter()
        for i in range(args.prompt_len):
            logits, cache = step(cache, prompts[:, i])
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits, -1)
        lat = []
        generated = [tok]
        for i in range(args.gen_tokens - 1):
            t0 = time.perf_counter()
            logits, cache = step(cache, tok)
            tok = torch.argmax(logits, -1)
            _sync(dev)
            lat.append(time.perf_counter() - t0)
            generated.append(tok)
        out = torch.stack(generated, 1)
        if not bool(torch.isfinite(logits).all()):
            print("non-finite logits", file=sys.stderr)
            return 1
    if not args.quiet:
        lat_ms = 1e3 * sum(lat) / len(lat) if lat else 0.0
        line = (f"arch={cfg.name} batch={B} device={dev} prefill={t_prefill:.2f}s "
                f"decode={lat_ms:.1f}ms/tok "
                f"({B * 1e3 / max(lat_ms, 1e-9):.0f} tok/s) "
                f"sample={out[0, :8].tolist()}")
        if graph is not None:
            cap = graph.capture_s
            line += f" graph_capture={'none' if cap is None else f'{cap:.3f}s'}"
        if streamer is not None:
            line += (f" offload[window={streamer.window} "
                     f"resident={streamer.device_resident_bytes() / 1e6:.1f}MB "
                     f"modelled, {streamer.hw.name}="
                     f"{streamer.stats.modelled_step_s * 1e3:.2f}ms/step]")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
