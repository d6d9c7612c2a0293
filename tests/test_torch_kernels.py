"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels in interpret mode and its oracles, on the
shapes and tolerances of tests/test_kernels.py."""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

from repro.kernels import chain2d as jax_chain2d  # noqa: E402
from repro.kernels import stencil2d as jax_stencil2d  # noqa: E402
from repro.kernels import stencil3d as jax_stencil3d  # noqa: E402
from repro.kernels import star2d_kernel as jax_star2d  # noqa: E402
from repro.kernels import star3d_kernel as jax_star3d  # noqa: E402
from repro.kernels.ref import chain2d_ref as jax_chain_ref  # noqa: E402
from repro.kernels.ref import stencil2d_ref as jax_ref2d  # noqa: E402
from repro.kernels.ref import stencil3d_ref as jax_ref3d  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as torch_ref  # noqa: E402

C2 = np.array([0.5, 0.125, 0.125], np.float32)
C3 = np.array([0.4, 0.1, 0.1, 0.1], np.float32)
ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(arr, dtype):
    """The same seeded numpy input as a jax array and a torch CPU tensor."""
    jdt, tdt, tol = DTYPES[dtype]
    return (jnp.asarray(arr, dtype=jdt),
            torch.from_numpy(arr.astype(np.float32)).to(tdt), tol)


@pytest.fixture
def launches():
    ops.stencil2d.launches = 0
    ops.stencil3d.launches = 0
    ops.chain2d.launches = 0
    yield
    assert (ops.stencil2d.launches == 0 and ops.stencil3d.launches == 0
            and ops.chain2d.launches == 0), \
        "a CPU tensor must never launch a CUDA kernel"


@pytest.mark.parametrize("shape", [(8, 8), (33, 47), (128, 128), (65, 130), (7, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil2d_matches_jax(shape, dtype, launches):
    H, W = shape
    rng = np.random.RandomState(H * 1000 + W)
    xj, xt, tol = _pair(rng.rand(H + 2, W + 2), dtype)
    got = ops.stencil2d(xt, C2)
    assert got.shape == (H, W) and got.dtype == xt.dtype
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stencil2d(xj, C2), np.float32),
                               atol=tol)
    np.testing.assert_allclose(got, np.asarray(jax_ref2d(xj, C2), np.float32),
                               atol=tol)


# The edges of csrc/stencil2d.cu's tiling: 1-row, 1-column and 1x1
# interiors; widths one below, at and one above a strip of 128 (fp32) and
# 256 (bf16) columns; W + 2 at every residue mod 8, so that rows start at
# every alignment; and heights around an 8-, a 16- and a 64-row segment.
STENCIL2D_EDGES = ([(1, 300), (300, 1), (1, 1)]
                   + [(3, w) for w in (127, 128, 129, 255, 256, 257)]
                   + [(5, w) for w in range(6, 14)]
                   + [(h, 5) for h in (7, 9, 15, 17, 63, 65)])


@pytest.mark.parametrize("shape", STENCIL2D_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil2d_edges_match_jax(shape, dtype, launches):
    H, W = shape
    rng = np.random.RandomState(H * 1000 + W + 1)
    xj, xt, tol = _pair(rng.rand(H + 2, W + 2), dtype)
    got = ops.stencil2d(xt, C2)
    assert got.shape == (H, W) and got.dtype == xt.dtype
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stencil2d(xj, C2), np.float32),
                               atol=tol)
    np.testing.assert_allclose(got, np.asarray(jax_ref2d(xj, C2), np.float32),
                               atol=tol)


@pytest.mark.parametrize("shape", [(4, 8, 8), (9, 17, 21), (16, 32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil3d_matches_jax(shape, dtype, launches):
    D, H, W = shape
    rng = np.random.RandomState(D * 10000 + H * 100 + W)
    xj, xt, tol = _pair(rng.rand(D + 2, H + 2, W + 2), dtype)
    got = ops.stencil3d(xt, C3)
    assert got.shape == (D, H, W) and got.dtype == xt.dtype
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stencil3d(xj, C3), np.float32),
                               atol=tol)
    np.testing.assert_allclose(got, np.asarray(jax_ref3d(xj, C3), np.float32),
                               atol=tol)


# The edges of csrc/stencil3d.cu's tilings (ops.stencil3d_tiling; the same
# cases as chip_smoke.stencil3d_edge_cases): fp32 tiles of 16 x 64 points
# and 64-plane segments, bf16 tiles of 16 x 128 and 32-plane segments.
# Widths one below, at and one above a tile's columns and a multiple of
# them plus one; heights around a tile's rows and past three tiles; depths
# around one segment; W + 2 at every residue mod 8; one-plane, one-row,
# one-column and 1x1x1 interiors; then a ragged input of each tiling at
# storage offsets 1 to 7 (the wrapper takes any contiguous view).
STENCIL3D_EDGES = ([((3, 5, w), 0) for w in (63, 64, 65, 257, 127, 128, 129, 513)]
                   + [((3, h, 37), 0) for h in (15, 16, 17, 49)]
                   + [((d, 5, 37), 0) for d in (31, 32, 33, 63, 64, 65)]
                   + [((3, 4, w), 0) for w in range(6, 14)]
                   + [((1, 9, 70), 0), ((5, 1, 70), 0), ((5, 9, 1), 0), ((1, 1, 1), 0)]
                   + [(s, off) for s in ((65, 17, 67), (33, 17, 131))
                      for off in range(1, 8)])


@pytest.mark.parametrize("shape, offset", STENCIL3D_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil3d_edges_match_jax(shape, offset, dtype, launches):
    D, H, W = shape
    rng = np.random.RandomState(D * 10000 + H * 100 + W + offset)
    xj, xt, tol = _pair(rng.rand(D + 2, H + 2, W + 2), dtype)
    xt = torch.cat([torch.zeros(offset, dtype=xt.dtype), xt.flatten()])[offset:]
    xt = xt.view(D + 2, H + 2, W + 2)
    assert xt.storage_offset() == offset
    got = ops.stencil3d(xt, C3)
    assert got.shape == (D, H, W) and got.dtype == xt.dtype
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stencil3d(xj, C3), np.float32),
                               atol=tol)
    np.testing.assert_allclose(got, np.asarray(jax_ref3d(xj, C3), np.float32),
                               atol=tol)


def _stencil3d_tilings():
    """{dtype: (rows, cols, planes)} of the tilings csrc/stencil3d.cu
    builds: fp32's constants, then those of its ``namespace bf16``."""
    text = (ROOT / "src/repro_torch/kernels/csrc/stencil3d.cu").read_text()
    fp32, bf16 = text.split("\nnamespace bf16 {\n")
    tilings = {}
    for dtype, part in ((torch.float32, fp32), (torch.bfloat16, bf16)):
        const = dict(re.findall(r"^constexpr int (k\w+) = (\d+);", part, re.M))
        tilings[dtype] = (int(const["kTy"]), int(const["kTx"]), int(const["kSeg"]))
    return tilings


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil3d_edges_follow_the_kernel_tiling(dtype, monkeypatch):
    """STENCIL3D_EDGES holds every edge case chip_smoke derives from the
    kernel's tiling for ``dtype``, so the CPU tests stay at the edges of the
    tiles the card runs."""
    rows, cols, planes = _stencil3d_tilings()[dtype]
    cs = _load("chip_smoke.py", "_chip_smoke")
    monkeypatch.setattr(cs.ops, "stencil3d_tiling",
                        lambda d: {"rows": rows, "cols": cols, "planes": planes})
    assert set(cs.stencil3d_edge_cases(dtype)) <= set(STENCIL3D_EDGES)


def test_wrapper_is_its_plain_version_on_cpu(launches):
    rng = np.random.RandomState(7)
    x2 = torch.from_numpy(rng.rand(20, 30).astype(np.float32))
    x3 = torch.from_numpy(rng.rand(6, 9, 11).astype(np.float32))
    assert torch.equal(ops.stencil2d(x2, C2), torch_ref.stencil2d_ref(x2, C2))
    assert torch.equal(ops.stencil3d(x3, C3), torch_ref.stencil3d_ref(x3, C3))
    assert torch.equal(ops.chain2d(x2, C2, 3), torch_ref.chain2d_ref(x2, C2, 3))


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(4, 4, dtype=torch.float64), TypeError),
    (torch.zeros(4, 4, 4), ValueError),
    (torch.zeros(1, 4), ValueError),
])
def test_stencil2d_rejects_bad_inputs(bad, err, launches):
    with pytest.raises(err):
        ops.stencil2d(bad, C2)


def test_coefficient_count_checked(launches):
    with pytest.raises(ValueError, match="coefficients"):
        ops.stencil3d(torch.zeros(4, 4, 4), C2)


def test_star_kernels_tag_like_jax():
    for port, ref, coeffs in ((ops.star2d_kernel, jax_star2d, C2),
                              (ops.star3d_kernel, jax_star3d, C3)):
        assert port("u", "t", coeffs).pallas_op == ref("u", "t", coeffs).pallas_op


@pytest.mark.parametrize("steps", [1, 2, 4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain2d_matches_jax(steps, dtype, launches):
    H, W = 40, 56
    rng = np.random.RandomState(100 + steps)
    xj, xt, tol = _pair(rng.rand(H + 2 * steps, W + 2 * steps), dtype)
    got = ops.chain2d(xt, C2, steps)
    assert got.shape == (H, W) and got.dtype == xt.dtype
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(jax_chain2d(xj, C2, steps), np.float32),
                               atol=tol)
    np.testing.assert_allclose(got, np.asarray(jax_chain_ref(xj, C2, steps), np.float32),
                               atol=tol)


def test_chain2d_ref_equals_repeated_stencil2d_ref():
    """Fused K sweeps == K single sweeps, bit for bit in fp32."""
    K, H, W = 3, 24, 32
    x = torch.from_numpy(np.random.RandomState(3).rand(H + 2 * K, W + 2 * K)
                         .astype(np.float32))
    seq = x
    for _ in range(K):
        seq = torch_ref.stencil2d_ref(seq, C2)
    assert torch.equal(torch_ref.chain2d_ref(x, C2, K), seq)


def _chain2d_case(h, w, steps, seed):
    rng = np.random.RandomState(seed)
    xj, xt, tol = _pair(rng.rand(h + 2 * steps, w + 2 * steps), "float32")
    np.testing.assert_allclose(ops.chain2d(xt, C2, steps).numpy(),
                               np.asarray(jax_chain_ref(xj, C2, steps)), atol=tol)


if HAVE_HYPOTHESIS:
    @given(h=st.integers(4, 40), w=st.integers(4, 40), steps=st.integers(1, 4),
           seed=st.integers(0, 999))
    @settings(max_examples=10, deadline=None)
    def test_chain2d_property(h, w, steps, seed):
        _chain2d_case(h, w, steps, seed)
else:  # pragma: no cover
    @pytest.mark.parametrize("h,w,steps,seed", [
        (4, 4, 1, 0), (17, 9, 2, 3), (40, 23, 4, 42),
    ])
    def test_chain2d_property(h, w, steps, seed):
        """Fixed-seed fallback when hypothesis is not installed."""
        _chain2d_case(h, w, steps, seed)


@pytest.mark.parametrize("bad, steps, err", [
    (torch.zeros(7, 7, 7), 1, ValueError),                   # rank 3
    (torch.zeros(7, 7, dtype=torch.float64), 1, TypeError),
    (torch.zeros(7, 7), 0, ValueError),
    (torch.zeros(7, 7), -2, ValueError),
    (torch.zeros(6, 9), 3, ValueError),                      # no interior left
    (torch.zeros(9, 6), 3, ValueError),
    (torch.zeros(7, 7), 1.5, TypeError),
    (torch.zeros(7, 7), True, TypeError),
])
def test_chain2d_rejects_bad_inputs(bad, steps, err, launches):
    with pytest.raises(err):
        ops.chain2d(bad, C2, steps)


# The per-launch limit of csrc/chain2d.cu (kMaxSteps): 16 before the
# wavefront kernel, 12 since.
@pytest.mark.parametrize("steps, parts, limit", [
    pytest.param(1, [1], 16, id="1-parts0"),
    pytest.param(16, [16], 16, id="16-parts1"),
    pytest.param(17, [9, 8], 16, id="17-parts2"),
    pytest.param(24, [12, 12], 16, id="24-parts3"),
    pytest.param(40, [14, 13, 13], 16, id="40-parts4"),
    pytest.param(12, [12], 12, id="12-limit12"),
    pytest.param(13, [7, 6], 12, id="13-limit12"),
    pytest.param(16, [8, 8], 12, id="16-limit12"),
    pytest.param(24, [12, 12], 12, id="24-limit12"),
    pytest.param(25, [9, 8, 8], 12, id="25-limit12"),
    pytest.param(40, [10, 10, 10, 10], 12, id="40-limit12"),
])
def test_chain2d_split_steps(steps, parts, limit):
    assert ops.split_steps(steps, limit) == parts
    assert max(parts) <= limit and sum(parts) == steps


@pytest.mark.parametrize("dtype, limit", [
    pytest.param("float32", 16, id="float32"),
    pytest.param("bfloat16", 16, id="bfloat16"),
    pytest.param("float32", 12, id="float32-limit12"),
    pytest.param("bfloat16", 12, id="bfloat16-limit12"),
])
def test_chain2d_passes_through_fp32_equal_one_pass(dtype, limit):
    """A chain deeper than one launch runs in passes with fp32 intermediates
    (the CUDA wrapper's split): the result is that of one pass, bit for bit."""
    K, H, W = 20, 9, 13
    _, x, _ = _pair(np.random.RandomState(5).rand(H + 2 * K, W + 2 * K), dtype)
    u = x
    for k in ops.split_steps(K, limit):
        u = torch_ref.chain2d_ref(u.float(), C2, k)
    assert torch.equal(u.to(x.dtype), torch_ref.chain2d_ref(x, C2, K))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("H, W, K, bm", [
    (4096, 4096, 2, 256), (4096, 4096, 8, 256), (1000, 333, 5, 64),
])
def test_chain_traffic_model_matches_jax(H, W, K, bm):
    """chip_smoke's 2-D traffic model with full-width tiles gives the bytes of
    benchmarks/kernel_bench.py's row-slab model."""
    jax_m = _load("benchmarks/kernel_bench.py", "_kernel_bench").chain_traffic_model(
        H, W, K, block_rows=bm)
    port_m = _load("chip_smoke.py", "_chip_smoke").chain_traffic_model(H, W, K, bm, W)
    for key in ("unfused_bytes", "fused_bytes", "traffic_reduction"):
        assert port_m[key] == jax_m[key], key
    assert port_m["redundant_compute_frac"] > 0


def _chain2d_note():
    """The tiling table in the note at the head of csrc/chain2d.cu:
    {K: (TM, S, reads = computed)} for single launches, and the K that the
    note says run as two launches."""
    text = (ROOT / "src/repro_torch/kernels/csrc/chain2d.cu").read_text()
    rows = re.findall(r"^//\s+(\d+)\s+(\d+)\s+(\d+)\s+([\d.]+)\s+[\d.]+$",
                      text, re.M)
    two = re.findall(r"^//\s+(\d+)\s+two launches of (\d+)", text, re.M)
    limit = int(re.search(r"constexpr int kMaxSteps = (\d+);", text).group(1))
    return ({int(k): (int(tm), int(s), float(r)) for k, tm, s, r in rows},
            {int(k): int(p) for k, p in two}, limit)


@pytest.mark.parametrize("K", [1, 4, 8, 16])
def test_chain_traffic_model_gives_the_kernel_note(K):
    """chip_smoke's traffic model, given the wavefront kernel's tiling (TM
    rows and S columns a warp, a 128-column window), gives the read and
    compute overhead that the note in csrc/chain2d.cu states; a K beyond one
    launch runs as the balanced passes the note names, and one sweep as the
    output tile of csrc/stencil2d.cuh, its window read the stated times per
    output point."""
    note, two, limit = _chain2d_note()
    cs = _load("chip_smoke.py", "_chip_smoke")
    if K == 1:
        text = (ROOT / "src/repro_torch/kernels/csrc/chain2d.cu").read_text()
        tm, tn, ratio = re.search(
            r"(\d+) x (\d+) output tile\s+// a warp \(fp32 input\), its \d+ x \d+ "
            r"window read ([\d.]+) times", text).groups()
        tm, tn, ratio = int(tm), int(tn), float(ratio)
        sweep = (ROOT / "src/repro_torch/kernels/csrc/stencil2d.cuh").read_text()
        points = int(re.search(r"constexpr int kPoints = (\d+);", sweep).group(1))
        assert tn == 32 * 4 and tm == points // tn
        m = cs.chain_traffic_model(3 * tm, 5 * tn, 1, tm, tn)
        useful = 3 * tm * 5 * tn * 4
        assert round((m["fused_bytes"] - useful) / useful, 3) == ratio
        assert m["redundant_compute_frac"] == 0
        return
    parts = ops.split_steps(K, limit)
    if K in two:
        assert parts == [two[K]] * 2
    else:
        assert parts == [K]
    for k in parts:
        tm, s, ratio = note[k]
        assert s == (cs.CHAIN_STRIP - 2 * k) // 8 * 8
        m = cs.chain_traffic_model(3 * tm, 5 * s, k, tm, s,
                                   window_cols=cs.CHAIN_STRIP)
        reads = (m["fused_bytes"] - 3 * tm * 5 * s * 4) / (3 * tm * 5 * s * 4)
        assert round(reads, 3) == ratio
        assert round(1 + m["redundant_compute_frac"], 3) == ratio
