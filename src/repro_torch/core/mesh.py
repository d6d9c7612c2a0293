"""Device meshes: the decomposition axis of sharded out-of-core execution.

Ported from ``src/repro/core/mesh.py``.  The paper's evaluation (§5.2) runs
tiled chains across 4 KNL processes, decomposing the grid along the
*non*-tiled dimension so out-of-core slab tiling (dim 0) composes with
MPI-style decomposition (dim 1).  This module makes that device dimension a
first-class API object:

* :class:`DeviceMesh` — ``sim:N`` *virtual* devices (the decomposition is
  exact, exchanges are host-side copies, any N works on a 1-device machine)
  or ``cuda:N`` *real* CUDA devices (halo exchanges run as peer copies
  through :func:`repro_torch.core.distributed.exchange_halos`).  The
  reference's ``jax:N`` kind has no counterpart here and raises.
* :class:`ShardGeometry` — one device's slice of the global grid: the owned
  interval along the shard dimension plus the redundant-compute *skirt*
  (accumulated halo depth) on each interior side.
* :class:`HaloSpec` — the per-device annotation
  :func:`repro_torch.core.plan.build_plan` lowers into
  ``HaloPack``/``HaloExchange``/``HaloUnpack`` ops: exchange depth, message
  count and byte totals, so the ledger model and the real runtime account
  halo traffic identically.

``ExecutionConfig(mesh=...)`` accepts a :class:`DeviceMesh`, an int
(``sim`` mesh of that size) or a string spec (``"sim:4"``, ``"cuda:2"``);
any ``ooc``-family backend given a multi-device mesh runs the sharded
executor (:mod:`repro_torch.core.sharded`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union


class MeshError(ValueError):
    """Bad mesh spec, or a grid that cannot be decomposed as requested."""


@dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh of execution devices for grid decomposition.

    ``kind="sim"`` — virtual devices: shards execute sequentially in this
    process (each through its own out-of-core executor, on the session's
    device) and halo exchanges are host-side copies between shard home
    arrays.  Correctness and cost modelling are exact on any machine.

    ``kind="cuda"`` — real CUDA devices: halo exchanges additionally run as
    peer copies between the first ``num_devices`` cards
    (:meth:`torch_devices`), through
    :func:`~repro_torch.core.distributed.exchange_halos`.
    """

    num_devices: int
    kind: str = "sim"
    axis_name: str = "shard"

    def __post_init__(self) -> None:
        if self.num_devices < 1:
            raise MeshError(f"mesh needs >= 1 device, got {self.num_devices}")
        if self.kind not in ("sim", "cuda"):
            raise MeshError(f"unknown mesh kind {self.kind!r} "
                            f"(expected 'sim' or 'cuda'; the reference's "
                            f"'jax' meshes are 'cuda:N' here)")

    @classmethod
    def sim(cls, n: int, axis_name: str = "shard") -> "DeviceMesh":
        return cls(num_devices=n, kind="sim", axis_name=axis_name)

    @classmethod
    def devices(cls, n: Optional[int] = None,
                axis_name: str = "shard") -> "DeviceMesh":
        """A mesh over real CUDA devices (all of them if ``n`` is None)."""
        if n is None:
            import torch

            n = torch.cuda.device_count()
        return cls(num_devices=n, kind="cuda", axis_name=axis_name)

    @property
    def spec(self) -> str:
        return f"{self.kind}:{self.num_devices}"

    def torch_devices(self) -> List["torch.device"]:  # noqa: F821
        """The first ``num_devices`` CUDA devices (``kind="cuda"`` only)."""
        if self.kind != "cuda":
            raise MeshError(f"{self.spec!r} is a virtual mesh; only "
                            f"kind='cuda' meshes have CUDA devices")
        import torch

        count = torch.cuda.device_count()
        if count < self.num_devices:
            raise MeshError(
                f"mesh {self.spec!r} needs {self.num_devices} CUDA devices, "
                f"only {count} available")
        return [torch.device("cuda", i) for i in range(self.num_devices)]


def parse_mesh(spec: Union[None, int, str, DeviceMesh]) -> Optional[DeviceMesh]:
    """Normalise a user-facing mesh spec: None, int (=> sim:N), "sim:N" /
    "cuda:N", or a ready :class:`DeviceMesh`.  The reference's ``"jax:N"``
    raises :class:`MeshError` naming ``cuda:N``."""
    if spec is None or isinstance(spec, DeviceMesh):
        return spec
    if isinstance(spec, int):
        return DeviceMesh.sim(spec)
    if isinstance(spec, str):
        kind, _, n = spec.partition(":")
        if not n and kind.isdigit():
            return DeviceMesh.sim(int(kind))
        if kind in ("sim", "cuda", "jax") and n.isdigit():
            return DeviceMesh(num_devices=int(n), kind=kind)
        raise MeshError(f"bad mesh spec {spec!r} (expected 'sim:N' or 'cuda:N')")
    raise MeshError(f"bad mesh spec {spec!r} of type {type(spec).__name__}")


# -- per-shard geometry -----------------------------------------------------------


@dataclass(frozen=True)
class ShardGeometry:
    """One device's slice of the global extent along the shard dimension.

    ``[lo, hi)`` is the *owned* interval; ``skirt_lo``/``skirt_hi`` are the
    redundant-compute skirts toward interior neighbours (0 at the global
    edges)."""

    index: int
    lo: int
    hi: int
    skirt_lo: int
    skirt_hi: int

    @property
    def width(self) -> int:
        return self.hi - self.lo

    @property
    def ext_lo(self) -> int:
        """Global coordinate of the shard's extended-region start."""
        return self.lo - self.skirt_lo

    @property
    def ext_hi(self) -> int:
        return self.hi + self.skirt_hi

    @property
    def ext_size(self) -> int:
        return self.ext_hi - self.ext_lo

    def to_local(self, g: int) -> int:
        """Global grid coordinate -> this shard's local grid coordinate."""
        return g - self.ext_lo


def shard_geometries(extent: int, num_devices: int,
                     skirt: int) -> List[ShardGeometry]:
    """Contiguous partition of ``[0, extent)`` over ``num_devices`` shards
    (remainder spread over the first shards), with ``skirt`` redundant rows
    on every *interior* side."""
    n = num_devices
    if extent < n:
        raise MeshError(f"cannot shard extent {extent} over {n} devices")
    base, rem = divmod(extent, n)
    geos: List[ShardGeometry] = []
    lo = 0
    for s in range(n):
        hi = lo + base + (1 if s < rem else 0)
        geos.append(ShardGeometry(
            index=s, lo=lo, hi=hi,
            skirt_lo=skirt if s > 0 else 0,
            skirt_hi=skirt if s < n - 1 else 0))
        lo = hi
    return geos


# -- plan-level halo annotation ---------------------------------------------------


@dataclass(frozen=True)
class HaloSpec:
    """What one device's chain plan needs to know about its halo exchange:
    lowered by ``build_plan`` into ``HaloPack``/``HaloExchange``/
    ``HaloUnpack`` ops.  Hashable (part of the executor's plan-cache key).

    ``depth`` is the exchange depth in rows per interior side (skirt +
    dataset halo); ``messages``/``nbytes`` count what *this* device receives;
    ``names`` are the datasets exchanged (the segment's read set)."""

    device: int
    num_devices: int
    shard_dim: int
    depth: int
    messages: int
    nbytes: int
    names: Tuple[str, ...]
