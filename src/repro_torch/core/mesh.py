"""Device meshes: the decomposition axis of sharded out-of-core execution.

Ported from ``src/repro/core/mesh.py``, keeping only what the planner needs
(:class:`HaloSpec`, which ``plan.py`` stamps onto device plans) and the
``sim:N`` half of :func:`parse_mesh` with its :class:`ShardGeometry`.

* :class:`DeviceMesh` — ``sim:N`` virtual devices.  The reference's
  ``jax:N`` kind runs collectives on JAX devices; the port has none, and its
  real multi-GPU mesh (``cuda:N``) is ROADMAP item A10, so both raise.
* :class:`ShardGeometry` — one device's slice of the global grid: the owned
  interval along the shard dimension plus the redundant-compute *skirt*
  (accumulated halo depth) on each interior side.
* :class:`HaloSpec` — the per-device annotation
  :func:`repro_torch.core.plan.build_plan` lowers into
  ``HaloPack``/``HaloExchange``/``HaloUnpack`` ops.

The port has no sharded executor yet: a backend given a multi-device mesh
raises ``NotImplementedError`` (ROADMAP A10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union


class MeshError(ValueError):
    """Bad mesh spec, or a grid that cannot be decomposed as requested."""


@dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh of virtual (``sim``) devices for grid decomposition."""

    num_devices: int
    kind: str = "sim"
    axis_name: str = "shard"

    def __post_init__(self) -> None:
        if self.num_devices < 1:
            raise MeshError(f"mesh needs >= 1 device, got {self.num_devices}")
        if self.kind != "sim":
            raise MeshError(
                f"mesh kind {self.kind!r} is not supported by repro_torch: "
                f"only 'sim' meshes exist until ROADMAP A10 adds cuda:N")

    @classmethod
    def sim(cls, n: int, axis_name: str = "shard") -> "DeviceMesh":
        return cls(num_devices=n, kind="sim", axis_name=axis_name)

    @property
    def spec(self) -> str:
        return f"{self.kind}:{self.num_devices}"


def parse_mesh(spec: Union[None, int, str, DeviceMesh]) -> Optional[DeviceMesh]:
    """Normalise a user-facing mesh spec: None, int (=> sim:N), "sim:N", or a
    ready :class:`DeviceMesh`.  ``"jax:N"`` raises :class:`MeshError`."""
    if spec is None or isinstance(spec, DeviceMesh):
        return spec
    if isinstance(spec, int):
        return DeviceMesh.sim(spec)
    if isinstance(spec, str):
        kind, _, n = spec.partition(":")
        if not n and kind.isdigit():
            return DeviceMesh.sim(int(kind))
        if kind in ("sim", "jax") and n.isdigit():
            return DeviceMesh(num_devices=int(n), kind=kind)
        raise MeshError(f"bad mesh spec {spec!r} (expected 'sim:N')")
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
