"""CloverLeaf 2D at 3x the fast-memory capacity on the PyTorch/CUDA port —
the port of ``examples/cloverleaf_outofcore.py``: the same problem, the same
Session API and the same prints, through ``repro_torch``.  Lazy recording
with inferred stencils, dt-reduction chain breakers, skewed tiling, 3-slot
streaming with the Cyclic + Prefetch optimisations, memoised chain plans, and
the modelled achieved-bandwidth metric vs. the resident baseline.  The
fields are asserted against ``Session("reference")`` on the same device.

  PYTHONPATH=src python examples/cloverleaf_outofcore_torch.py               # on the GPU
  PYTHONPATH=src python examples/cloverleaf_outofcore_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.apps import CloverLeaf2D
from repro_torch.core import P100_NVLINK, Session


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where slots and kernels run: cuda (default) or cpu")
    args = ap.parse_args()

    capacity = 4 << 20               # scaled-down "16 GB"
    nx = 450                         # ~3x capacity with 25 fp32 datasets
    app_probe = CloverLeaf2D(nx, nx)
    ratio = app_probe.total_bytes() / capacity
    print(f"problem: {app_probe.total_bytes() / 1e6:.1f} MB "
          f"= {ratio:.1f}x fast memory ({capacity / 1e6:.0f} MB)")

    hw = P100_NVLINK.with_(fast_capacity=capacity, fast_bw=470e9, dd_bw=509.7e9)
    steps = 3

    ref_app = CloverLeaf2D(nx, nx, summary_every=steps)
    ref_summary = ref_app.run(Session("reference", device=args.device), steps=steps)

    app = CloverLeaf2D(nx, nx, summary_every=steps)
    sess = Session("ooc", hw=hw, prefetch=True, device=args.device)
    summary = app.run(sess, steps=steps)   # enables cyclic after init
    sess.close()

    errs = {n: float(np.abs(ref_app.d(n).interior() - app.d(n).interior()).max())
            for n in ("density0", "energy0", "xvel0", "yvel0")}
    print(f"correctness vs in-core reference: max|drho| = {errs['density0']:.2e}")
    for n in errs:
        np.testing.assert_allclose(app.d(n).interior(), ref_app.d(n).interior(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    for k in ref_summary:
        np.testing.assert_allclose(summary[k], ref_summary[k], rtol=1e-3, err_msg=k)

    hist = sess.history[1:]
    bw = sum(c.loop_bytes for c in hist) / sum(c.modelled_s for c in hist)
    print(f"chains: {len(sess.history)}  tiles/chain: {hist[0].num_tiles}  "
          f"slot: {hist[0].slot_bytes / 1e6:.2f} MB")
    up = sum(c.uploaded for c in hist) / 1e6
    dn = sum(c.downloaded for c in hist) / 1e6
    print(f"link traffic: {up:.0f} MB up / {dn:.0f} MB down "
          f"(write-first+cyclic elision on)")
    plan = sess.plan_stats()
    print(f"chain plans: {plan['plan_misses']} analysed once, "
          f"{plan['plan_hits']} replayed from cache "
          f"(hit rate {plan['plan_hit_rate']:.0%})")
    print(f"achieved bandwidth (modelled {hw.name}): {bw / 1e9:.0f} GB/s "
          f"= {bw / 470e9 * 100:.0f}% of the in-core baseline")
    for k, v in summary.items():
        print(f"  summary {k}: {v:.6g} (ref {ref_summary[k]:.6g})")


if __name__ == "__main__":
    main()
