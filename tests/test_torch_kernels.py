"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels in interpret mode and its oracles, on the
shapes and tolerances of tests/test_kernels.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import stencil2d as jax_stencil2d  # noqa: E402
from repro.kernels import stencil3d as jax_stencil3d  # noqa: E402
from repro.kernels import star2d_kernel as jax_star2d  # noqa: E402
from repro.kernels import star3d_kernel as jax_star3d  # noqa: E402
from repro.kernels.ref import stencil2d_ref as jax_ref2d  # noqa: E402
from repro.kernels.ref import stencil3d_ref as jax_ref3d  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as torch_ref  # noqa: E402

C2 = np.array([0.5, 0.125, 0.125], np.float32)
C3 = np.array([0.4, 0.1, 0.1, 0.1], np.float32)
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
    yield
    assert ops.stencil2d.launches == 0 and ops.stencil3d.launches == 0, \
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


def test_wrapper_is_its_plain_version_on_cpu(launches):
    rng = np.random.RandomState(7)
    x2 = torch.from_numpy(rng.rand(20, 30).astype(np.float32))
    x3 = torch.from_numpy(rng.rand(6, 9, 11).astype(np.float32))
    assert torch.equal(ops.stencil2d(x2, C2), torch_ref.stencil2d_ref(x2, C2))
    assert torch.equal(ops.stencil3d(x3, C3), torch_ref.stencil3d_ref(x3, C3))


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
