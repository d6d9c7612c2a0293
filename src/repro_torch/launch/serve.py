"""Serving launcher.

The ``stencil`` subcommand runs the multi-tenant
:class:`repro_torch.serve.StencilServer`: N CloverLeaf 2D tenants submitted
from threads onto a shared lane pool with ledger-oracle admission control::

    python -m repro_torch.launch.serve stencil --tenants 4 --mesh sim:2 \\
        --policy sjf --steps 3                   # on the card
    python -m repro_torch.launch.serve stencil --device cpu --tenants 2

Ported from ``src/repro/launch/serve.py``; ``--device`` is new (``cuda`` by
default, which raises where there is no card).  The reference's other
entry point, model decode, waits for the port of the model substrate
(ROADMAP A14): without ``stencil`` this exits non-zero and says so.
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "stencil":
        return stencil_main(argv[1:])
    print("repro_torch.launch.serve: only the 'stencil' subcommand is ported; "
          "model decode waits for the model substrate (ROADMAP A14)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
