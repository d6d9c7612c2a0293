"""Quickstart on the PyTorch/CUDA port — the port of ``examples/quickstart.py``:
the same 2-D heat solver, the same StencilProgram/Session API and the same
prints, through ``repro_torch``.

The working set is larger than the configured "fast memory".  Loops are
registered *declaratively*: pass the datasets a kernel touches and the
runtime traces the kernel's accessor calls to infer every READ stencil and
access mode.  Backends are selected by name ("reference", "resident",
"ooc", "ooc-cyclic", "sim", "cuda"); chain plans are memoised, so repeated
identical chains replay a cached plan.  The fast-memory model is the port's
default ``hw`` with its capacity cut to a quarter of the problem.

  PYTHONPATH=src python examples/quickstart_torch.py               # on the GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import Block, ExecutionConfig, Session, make_dataset
from repro_torch.kernels import star2d_kernel


def heat(sess: Session, n=512, m=256, steps=8):
    blk = Block("grid", (n, m))
    rng = np.random.RandomState(0)
    u = make_dataset(blk, "u", halo=1, init=rng.rand(n, m).astype(np.float32))
    tmp = make_dataset(blk, "tmp", halo=1)
    interior = ((1, n - 1), (1, m - 1))
    # A declared star sweep (the "cuda" backend fast-paths this one) ...
    diffuse = star2d_kernel("u", "tmp", (0.0, 0.25, 0.25))
    # ... and a plain accessor kernel — stencils/modes inferred by tracing.
    commit = lambda acc: {"u": acc("tmp")}  # noqa: E731
    for s in range(steps):
        sess.par_loop(f"diffuse{s}", blk, interior, [u, tmp], diffuse)
        sess.par_loop(f"commit{s}", blk, interior, [tmp, u], commit)
    return sess.fetch(u)  # <- chain breaker: analysis + tiling + execution


def record_preview(sess: Session, n=512, m=256) -> None:
    """Queue one step of the heat program on its own block, for
    ``Session.explain()`` to plan; nothing runs."""
    blk = Block("preview", (n, m))
    rng = np.random.RandomState(0)
    pu = make_dataset(blk, "u", halo=1, init=rng.rand(n, m).astype(np.float32))
    pt = make_dataset(blk, "tmp", halo=1)
    box = ((1, n - 1), (1, m - 1))
    sess.par_loop("p_diffuse", blk, box, [pu, pt],
                  star2d_kernel("u", "tmp", (0.0, 0.25, 0.25)))
    sess.par_loop("p_commit", blk, box, [pt, pu], lambda acc: {"u": acc("tmp")})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where slots and kernels run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    ref = heat(Session("reference", device=args.device))

    # fast memory holds only ~1/4 of the problem: out-of-core streaming
    problem_bytes = 2 * 514 * 258 * 4
    hw = ExecutionConfig.hw.with_(fast_capacity=problem_bytes // 4)   # the port's default
    sess = Session("ooc", hw=hw, cyclic=True, prefetch=True, device=args.device)

    # Inspect the Plan IR before anything executes: record one step, ask the
    # planner for the typed instruction stream and its modelled makespan.
    record_preview(sess)
    print("--- Session.explain(): the chain's instruction stream ---")
    print("\n".join(sess.explain().splitlines()[:10]))
    print("    ...\n")
    sess.queue.clear()          # preview only — nothing ran

    got = heat(sess)

    if not np.allclose(ref, got, atol=1e-5):
        raise AssertionError("out-of-core result mismatch!")
    st = sess.history[-1]
    plan = sess.plan_stats()
    print(f"problem        : {problem_bytes / 1e6:.1f} MB")
    print(f"fast memory    : {hw.fast_capacity / 1e6:.1f} MB  "
          f"(3 slots x {st.slot_bytes / 1e6:.2f} MB used)")
    print(f"tiles          : {st.num_tiles}")
    print(f"uploaded       : {st.uploaded / 1e6:.1f} MB   "
          f"downloaded: {st.downloaded / 1e6:.1f} MB")
    print(f"modelled step  : {st.modelled_s * 1e3:.2f} ms  "
          f"-> {st.achieved_bw_model / 1e9:.0f} GB/s achieved (model: {hw.name})")
    print(f"chain planning : {plan['plan_misses']} analysed, "
          f"{plan['plan_hits']} cache hits "
          f"({plan['plan_time_s'] * 1e3:.1f} ms total)")
    print("out-of-core result == reference  [OK]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
