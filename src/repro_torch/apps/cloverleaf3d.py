"""CloverLeaf 3D on the repro_torch.core DSL.

Ported from ``src/repro/apps/cloverleaf3d.py``: the same 30 datasets, loop
names, ranges, stencils and recording order, with the kernels in torch ops.

Same structure as :mod:`cloverleaf2d` extended to three dimensions and a
third velocity pair + z-fluxes: 30 datasets (§5.1), three directionally-split
advection sweeps per step (x/y/z rotated each step), deeper chains
(~40 loops/step), dt MIN-reduction chain breaker each step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..core import (
    Block,
    ReductionSpec,
    Session,
    make_dataset,
    offset_stencil,
    point_stencil,
)
from ._session import make_session

_GAMMA = 1.4
_AXES = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}


@dataclass
class CloverLeaf3D:
    nx: int
    ny: int
    nz: int
    dtype: type = np.float32
    summary_every: int = 10
    # Home-copy tier for every dataset: None/"ram" (default), "mmap",
    # "chunked", or a repro_torch.core.StoreConfig (see repro_torch.core.store).
    store: object = None
    # Device mesh for make_session(): None (unsharded) or anything
    # repro_torch.core.parse_mesh accepts — an int, "sim:N"/"cuda:N", a
    # DeviceMesh; a mesh runs the ooc-sharded backend.
    mesh: object = None

    def make_session(self, backend: str = None, **overrides) -> Session:
        """A Session for this app: ``backend`` (default ``ooc``) with
        ``overrides`` as ExecutionConfig fields; ``ooc-sharded`` over
        the app's ``mesh`` when it has one."""
        return make_session(self.mesh, backend, overrides)

    def __post_init__(self):
        nx, ny, nz = self.nx, self.ny, self.nz
        self.block = Block("clover3d", (nx, ny, nz))
        mk = lambda name: make_dataset(self.block, name, halo=2,
                                       dtype=self.dtype, store=self.store)
        names = [
            "density0", "density1", "energy0", "energy1", "pressure",
            "viscosity", "soundspeed", "volume",
            "vol_flux_x", "vol_flux_y", "vol_flux_z",
            "mass_flux_x", "mass_flux_y", "mass_flux_z",
            "pre_vol", "post_vol", "pre_mass", "post_mass", "advec_vol",
            "post_ener", "ener_flux", "xarea", "yarea", "zarea",
            "xvel0", "xvel1", "yvel0", "yvel1", "zvel0", "zvel1",
        ]
        self.dats = {n: mk(n) for n in names}
        assert len(self.dats) == 30
        self.S0 = point_stencil(3)
        self.S_p = {a: offset_stencil((0, 0, 0), _AXES[a]) for a in "xyz"}
        self.S_node = offset_stencil(
            (0, 0, 0), (-1, 0, 0), (0, -1, 0), (0, 0, -1),
            (-1, -1, 0), (-1, 0, -1), (0, -1, -1), (-1, -1, -1),
        )
        self.S_adv = {
            a: offset_stencil(
                tuple(-2 * o for o in _AXES[a]), tuple(-1 * o for o in _AXES[a]),
                (0, 0, 0), _AXES[a], tuple(2 * o for o in _AXES[a]),
            )
            for a in "xyz"
        }
        self.step_count = 0
        self.dt = 1e-4

    def d(self, name):
        return self.dats[name]

    def _interior(self):
        return ((0, self.nx), (0, self.ny), (0, self.nz))

    def _adv_range(self):
        return ((2, self.nx - 2), (2, self.ny - 2), (2, self.nz - 2))

    # -- init -----------------------------------------------------------------
    def record_init(self, rt: Session) -> None:
        nx, ny, nz = self.nx, self.ny, self.nz
        hx, hy, hz = 2 * np.pi / nx, 2 * np.pi / ny, 2 * np.pi / nz

        def k_init(acc):
            ix, iy, iz = acc.coords()
            x = ix.to(torch.float32) * hx
            y = iy.to(torch.float32) * hy
            z = iz.to(torch.float32) * hz
            one = torch.ones(acc.shape, dtype=torch.float32, device=acc.device)
            return {
                "density0": 1.0 + 0.2 * torch.sin(x) * torch.cos(y) * torch.cos(z),
                "energy0": 2.5 + 0.5 * torch.cos(x),
                "volume": one, "xarea": one, "yarea": one, "zarea": one,
                "xvel0": 0.1 * torch.sin(x),
                "yvel0": -0.1 * torch.cos(y),
                "zvel0": 0.05 * torch.sin(z),
            }

        rt.par_loop(
            "initialise3d", self.block, self._interior(),
            [self.d(n) for n in ("density0", "energy0", "volume", "xarea",
                                  "yarea", "zarea", "xvel0", "yvel0", "zvel0")],
            k_init,
        )

        def k_zero(acc):
            zf = torch.zeros(acc.shape, dtype=torch.float32, device=acc.device)
            return {n: zf for n in ("density1", "energy1", "pressure", "viscosity",
                                     "soundspeed", "xvel1", "yvel1", "zvel1")}

        rt.par_loop(
            "zero_fields3d", self.block, self._interior(),
            [self.d(n) for n in ("density1", "energy1", "pressure",
                                  "viscosity", "soundspeed", "xvel1", "yvel1",
                                  "zvel1")],
            k_zero,
        )

    # -- physics ----------------------------------------------------------------
    def _ideal_gas(self, rt, rho_name, e_name, tag):
        def k(acc):
            rho = acc(rho_name)
            p = (_GAMMA - 1.0) * rho * acc(e_name)
            ss = torch.sqrt(torch.clamp_min(_GAMMA * p / torch.clamp_min(rho, 1e-10), 1e-10))
            return {"pressure": p, "soundspeed": ss}

        rt.par_loop(
            f"ideal_gas3d{tag}", self.block, self._interior(),
            [self.d(rho_name), self.d(e_name), self.d("pressure"),
             self.d("soundspeed")],
            k,
        )

    def _viscosity(self, rt):
        def k(acc):
            div = ((acc("xvel0", (1, 0, 0)) - acc("xvel0"))
                   + (acc("yvel0", (0, 1, 0)) - acc("yvel0"))
                   + (acc("zvel0", (0, 0, 1)) - acc("zvel0")))
            return {"viscosity": torch.where(div < 0, 2.0 * acc("density0") * div * div, 0.0)}

        rt.par_loop(
            "viscosity3d", self.block, self._interior(),
            [self.d("xvel0"), self.d("yvel0"), self.d("zvel0"),
             self.d("density0"), self.d("viscosity")],
            k,
        )

    def _calc_dt(self, rt):
        def k(acc):
            speed = (acc("soundspeed") + torch.abs(acc("xvel0"))
                     + torch.abs(acc("yvel0")) + torch.abs(acc("zvel0")))
            return {"dt": torch.min(0.5 / torch.clamp_min(speed, 1e-6) / max(self.nx, self.ny, self.nz))}

        rt.par_loop(
            "calc_dt3d", self.block, self._interior(),
            [self.d(n) for n in ("soundspeed", "xvel0", "yvel0", "zvel0")],
            k, reductions=[ReductionSpec("dt", "min")],
        )

    def _pdv(self, rt, predict, tag):
        dt = self.dt * (0.5 if predict else 1.0)

        def k(acc):
            div = ((acc("xvel0", (1, 0, 0)) - acc("xvel0"))
                   + (acc("yvel0", (0, 1, 0)) - acc("yvel0"))
                   + (acc("zvel0", (0, 0, 1)) - acc("zvel0")))
            rho = acc("density0") / torch.clamp_min(1.0 + dt * div, 0.1)
            e = acc("energy0") - dt * acc("pressure") * div / torch.clamp_min(acc("density0"), 1e-10)
            return {"density1": rho, "energy1": e}

        rt.par_loop(
            f"pdv3d_{tag}", self.block, self._interior(),
            [self.d("xvel0"), self.d("yvel0"), self.d("zvel0"),
             self.d("density0"), self.d("energy0"), self.d("pressure"),
             self.d("density1"), self.d("energy1")],
            k,
        )

    def _revert(self, rt):
        def k(acc):
            return {"density1": acc("density0"), "energy1": acc("energy0")}

        rt.par_loop(
            "revert3d", self.block, self._interior(),
            [self.d("density0"), self.d("energy0"), self.d("density1"),
             self.d("energy1")],
            k,
        )

    def _accelerate(self, rt):
        dt = self.dt
        rng = ((1, self.nx), (1, self.ny), (1, self.nz))

        def k(acc):
            nodal = 0.125 * sum(
                acc("density0", o) for o in self.S_node.points
            )
            upd = {}
            for vel, ax in (("xvel", (-1, 0, 0)), ("yvel", (0, -1, 0)), ("zvel", (0, 0, -1))):
                grad = (acc("pressure") - acc("pressure", ax)
                        + acc("viscosity") - acc("viscosity", ax))
                upd[f"{vel}1"] = acc(f"{vel}0") - dt * grad / torch.clamp_min(nodal, 1e-10)
            return upd

        rt.par_loop(
            "accelerate3d", self.block, rng,
            [self.d("density0"), self.d("pressure"), self.d("viscosity")]
            + [self.d(f"{v}0") for v in ("xvel", "yvel", "zvel")]
            + [self.d(f"{v}1") for v in ("xvel", "yvel", "zvel")],
            k,
        )

    def _flux_calc(self, rt):
        dt = self.dt

        def k(acc):
            return {
                "vol_flux_x": 0.5 * dt * (acc("xvel1") + acc("xvel1", (0, 1, 0))) * acc("xarea"),
                "vol_flux_y": 0.5 * dt * (acc("yvel1") + acc("yvel1", (0, 0, 1))) * acc("yarea"),
                "vol_flux_z": 0.5 * dt * (acc("zvel1") + acc("zvel1", (1, 0, 0))) * acc("zarea"),
            }

        rt.par_loop(
            "flux_calc3d", self.block, self._interior(),
            [self.d("xvel1"), self.d("yvel1"), self.d("zvel1")]
            + [self.d(a) for a in ("xarea", "yarea", "zarea")]
            + [self.d(f) for f in ("vol_flux_x", "vol_flux_y", "vol_flux_z")],
            k,
        )

    def _advec_cell(self, rt, sweep):
        flux = f"vol_flux_{sweep}"
        off = _AXES[sweep]
        moff = tuple(-o for o in off)
        S_don = self.S_adv[sweep]
        rng = self._adv_range()

        def k_prevol(acc):
            return {"pre_vol": acc("volume") + (acc(flux, off) - acc(flux)),
                    "post_vol": acc("volume")}

        rt.par_loop(
            f"advec_cell3d_{sweep}_vol", self.block, rng,
            [self.d("volume"), self.d(flux), self.d("pre_vol"),
             self.d("post_vol")],
            k_prevol,
        )

        def k_flux(acc):
            f = acc(flux)
            donor_rho = torch.where(f > 0, acc("density1", moff), acc("density1"))
            donor_e = torch.where(f > 0, acc("energy1", moff), acc("energy1"))
            return {"pre_mass": donor_rho * torch.abs(f),
                    "ener_flux": donor_rho * donor_e * torch.abs(f) * torch.sign(f)}

        rt.par_loop(
            f"advec_cell3d_{sweep}_flux", self.block, rng,
            [self.d(flux), self.d("density1"), self.d("energy1"),
             self.d("pre_mass"), self.d("ener_flux")],
            k_flux,
            # keep the original second-order advection footprint (see 2-D app)
            explicit_stencil={"density1": S_don, "energy1": S_don},
        )

        def k_update(acc):
            f = acc(flux)
            fp = acc(flux, off)
            m_in = torch.where(f > 0, acc("pre_mass"), -acc("pre_mass"))
            m_out = torch.where(fp > 0, acc("pre_mass", off), -acc("pre_mass", off))
            pre_mass = acc("density1") * acc("pre_vol")
            post_mass = pre_mass + m_in - m_out
            rho = post_mass / torch.clamp_min(acc("post_vol"), 1e-10)
            post_e = (pre_mass * acc("energy1") + acc("ener_flux")
                      - acc("ener_flux", off)) / torch.clamp_min(post_mass, 1e-10)
            return {"density1": rho, "energy1": post_e, "post_mass": post_mass}

        rt.par_loop(
            f"advec_cell3d_{sweep}_update", self.block, rng,
            [self.d(flux), self.d("pre_mass"), self.d("ener_flux"),
             self.d("pre_vol"), self.d("post_vol"), self.d("density1"),
             self.d("energy1"), self.d("post_mass")],
            k_update,
        )

    def _advec_mom(self, rt, sweep, vel):
        """Three loops as in the original: mass flux -> momentum flux (work
        array) -> velocity update (zero-stencil RW)."""
        flux = f"mass_flux_{sweep}"
        vflux = f"vol_flux_{sweep}"
        off = _AXES[sweep]
        moff = tuple(-o for o in off)
        rng = self._adv_range()
        v1 = f"{vel}1"
        mom = "advec_vol"

        def k_mf(acc):
            return {flux: acc(vflux) * 0.5 * (acc("density1") + acc("density1", off))}

        rt.par_loop(
            f"advec_mom3d_{sweep}_{vel}_mf", self.block, rng,
            [self.d(vflux), self.d("density1"), self.d(flux)],
            k_mf,
        )

        def k_mom(acc):
            f = acc(flux)
            donor = torch.where(f > 0, acc(v1, moff), acc(v1))
            return {mom: f * donor}

        rt.par_loop(
            f"advec_mom3d_{sweep}_{vel}_flx", self.block, rng,
            [self.d(flux), self.d(v1), self.d(mom)],
            k_mom,
        )

        def k_up(acc):
            node_mass = torch.clamp_min(acc("post_mass"), 1e-10)
            return {v1: acc(v1) + (acc(mom) - acc(mom, off)) / node_mass}

        rt.par_loop(
            f"advec_mom3d_{sweep}_{vel}_up", self.block, rng,
            [self.d(mom), self.d("post_mass"), self.d(v1)],
            k_up,
        )

    def _reset_field(self, rt):
        pairs = [("density0", "density1"), ("energy0", "energy1"),
                 ("xvel0", "xvel1"), ("yvel0", "yvel1"), ("zvel0", "zvel1")]

        def k(acc):
            return {dst: acc(src) for dst, src in pairs}

        rt.par_loop(
            "reset_field3d", self.block, self._interior(),
            [self.d(src) for _, src in pairs]
            + [self.d(dst) for dst, _ in pairs],
            k,
        )

    # -- drivers --------------------------------------------------------------
    def record_timestep(self, rt: Session) -> None:
        self._ideal_gas(rt, "density0", "energy0", "")
        self._viscosity(rt)
        self._pdv(rt, True, "predict")
        self._ideal_gas(rt, "density1", "energy1", "_pdv")
        self._revert(rt)
        self._accelerate(rt)
        self._pdv(rt, False, "correct")
        self._flux_calc(rt)
        order = ["xyz", "yzx", "zxy"][self.step_count % 3]
        for sweep in order:
            self._advec_cell(rt, sweep)
            for vel in ("xvel", "yvel", "zvel"):
                self._advec_mom(rt, sweep, vel)
        self._reset_field(rt)
        self.step_count += 1

    def record_summary(self, rt: Session) -> List[str]:
        def k(acc):
            rho = acc("density0")
            ke = 0.5 * rho * (acc("xvel0") ** 2 + acc("yvel0") ** 2 + acc("zvel0") ** 2)
            return {
                "sum_mass": torch.sum(rho * acc("volume")),
                "sum_ie": torch.sum(rho * acc("energy0") * acc("volume")),
                "sum_ke": torch.sum(ke * acc("volume")),
                "max_p": torch.max(acc("pressure")),
                "min_rho": torch.min(rho),
            }

        specs = [ReductionSpec("sum_mass", "sum"), ReductionSpec("sum_ie", "sum"),
                 ReductionSpec("sum_ke", "sum"), ReductionSpec("max_p", "max"),
                 ReductionSpec("min_rho", "min")]
        rt.par_loop(
            "field_summary3d", self.block, self._interior(),
            [self.d(n) for n in ("density0", "energy0", "xvel0", "yvel0",
                                  "zvel0", "volume", "pressure")],
            k, reductions=specs,
        )
        return [s.name for s in specs]

    def run(self, rt: Session, steps: int, dt_every: bool = True) -> Dict[str, float]:
        self.record_init(rt)
        rt.flush()
        rt.cyclic = True
        out: Dict[str, float] = {}
        for s in range(steps):
            self._ideal_gas(rt, "density0", "energy0", "_dt")
            self._viscosity(rt)
            self._calc_dt(rt)
            if dt_every:
                self.dt = float(min(1e-4, rt.reduction("dt")))
            self.record_timestep(rt)
            if self.summary_every and (s + 1) % self.summary_every == 0:
                for name in self.record_summary(rt):
                    out[name] = float(rt.reduction(name))
        rt.flush()
        return out

    def total_bytes(self) -> int:
        return sum(d.nbytes for d in self.dats.values())
