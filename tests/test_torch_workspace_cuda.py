"""An out-of-core run held to its planned device capacity on a card.

CloverLeaf 2D at 512^2 runs on ``Session("ooc")`` with a third of its homes
(8.9 MB) as the capacity, under a hard cap on the process's device memory
(``torch.cuda.set_per_process_memory_fraction``; an allocation past it
raises): what the caching allocator holds before the run, plus that
capacity, plus ``SLACK`` for the allocator's segments beyond the blocks it
hands out (at this size the slot blocks and the tile function's tensors sit
in shared 20 MiB and 2 MiB segments; ``chip_smoke.py`` phases 6 and 7, whose
blocks are tens of MiB, cap at the capacity itself).  The run must
complete, its peak allocated bytes stay within the capacity, and its fields
equal ``Session("cuda")``'s at the reference's tolerances.  It needs a card
and skips without one; it imports no JAX::

    python -m pytest -q -m cuda tests/test_torch_workspace_cuda.py

``chip_smoke.py`` phases 6 and 7 run heat and CloverLeaf 2D the same way at
full size; ``tests/test_torch_workspace.py`` holds the charge on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.apps import CloverLeaf2D  # noqa: E402

N, STEPS = 512, 3
FIELDS = ("density0", "energy0", "xvel0", "yvel0")
FIELD = dict(rtol=1e-4, atol=1e-5)
SLACK = 64 << 20


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(backend, **kw):
    app = CloverLeaf2D(N, N, summary_every=STEPS)
    for d in app.dats.values():
        d.pin()
    sess = T.Session(backend, device="cuda", **kw)
    summary = app.run(sess, steps=STEPS)
    torch.cuda.synchronize()
    fields = {n: app.d(n).interior().copy() for n in FIELDS}
    hist = list(sess.history)
    sess.close()
    return fields, summary, hist


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ooc", "ooc-async"])
def test_ooc_run_completes_within_its_capacity_under_a_hard_cap(backend):
    _needs_card()
    cap = CloverLeaf2D(N, N).total_bytes() / 3
    want, want_summary, _ = _run("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    total = torch.cuda.mem_get_info()[1]
    torch.cuda.set_per_process_memory_fraction(
        (torch.cuda.memory_reserved() + cap + SLACK) / total)
    try:
        got, summary, hist = _run(backend, capacity_bytes=cap, prefetch=True)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    peak = torch.cuda.max_memory_allocated() - base
    assert any(h.num_tiles > 1 for h in hist)          # out of core
    assert all(h.workspace_bytes > 0 for h in hist)
    assert peak <= cap, f"peak {peak} B over the capacity {cap} B"
    for n in FIELDS:
        np.testing.assert_allclose(got[n], want[n], **FIELD, err_msg=n)
    for k in want_summary:
        np.testing.assert_allclose(summary[k], want_summary[k], rtol=1e-3, err_msg=k)
