"""CloverLeaf 2D on the repro_torch.core DSL.

Ported from ``src/repro/apps/cloverleaf2d.py``: the same 25 datasets, loop
names, ranges, stencils and recording order, with the kernels in torch ops.

Explicit compressible-Euler mini-app: staggered grid (density/energy/pressure
at cell centres, velocities at nodes), one timestep =

  ideal_gas -> viscosity -> calc_dt (MIN reduction, chain breaker) ->
  PdV(predictor) -> ideal_gas -> revert -> accelerate -> PdV(corrector) ->
  flux_calc -> advec_cell(x) -> advec_mom(x) -> advec_cell(y) ->
  advec_mom(y) -> reset_field

25 datasets, 27 physics loops plus 24 halo loops per step, sweep direction
alternates per step; every ``summary_every`` steps a field-summary chain
(5 reductions over 6 datasets) reproduces the paper's "one long loop chain
reading a large number of datasets with a very poor copy/compute overlap".
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
    star_stencil,
)
from ._session import make_session

_GAMMA = 1.4


@dataclass
class CloverLeaf2D:
    nx: int
    ny: int
    dtype: type = np.float32
    summary_every: int = 10
    # Home-copy tier for every dataset: None/"ram" (default), "mmap",
    # "chunked", or a repro_torch.core.StoreConfig (see repro_torch.core.store).
    store: object = None
    # Device mesh for make_session(): None (unsharded) or anything
    # repro_torch.core.parse_mesh accepts — an int, "sim:N"/"cuda:N", a
    # DeviceMesh; a mesh runs the ooc-sharded backend.
    mesh: object = None

    def __post_init__(self):
        nx, ny = self.nx, self.ny
        self.block = Block("clover2d", (nx, ny))
        mk = lambda name, halo=2: make_dataset(self.block, name, halo=halo,
                                               dtype=self.dtype,
                                               store=self.store)
        # 25 datasets, as in the original (§5.1).
        names_cell = [
            "density0", "density1", "energy0", "energy1", "pressure",
            "viscosity", "soundspeed", "volume",
            "vol_flux_x", "vol_flux_y", "mass_flux_x", "mass_flux_y",
            "pre_vol", "post_vol", "pre_mass", "post_mass", "advec_vol",
            "post_ener", "ener_flux", "xarea", "yarea",
        ]
        names_node = ["xvel0", "xvel1", "yvel0", "yvel1"]
        self.dats: Dict[str, "Dataset"] = {}
        for n in names_cell + names_node:
            self.dats[n] = mk(n)
        assert len(self.dats) == 25
        # Stencils (a representative subset of the original's 30).
        self.S0 = point_stencil(2)
        self.S_star = star_stencil(2, 1)
        self.S_xm = offset_stencil((0, 0), (-1, 0))
        self.S_xp = offset_stencil((0, 0), (1, 0))
        self.S_ym = offset_stencil((0, 0), (0, -1))
        self.S_yp = offset_stencil((0, 0), (0, 1))
        self.S_node = offset_stencil((0, 0), (-1, 0), (0, -1), (-1, -1))
        self.S_cellx = offset_stencil((0, 0), (1, 0), (0, 1), (1, 1))
        self.S_adv_x = offset_stencil((-2, 0), (-1, 0), (0, 0), (1, 0), (2, 0))
        self.S_adv_y = offset_stencil((0, -2), (0, -1), (0, 0), (0, 1), (0, 2))
        self.step_count = 0
        self.dt = 1e-4

    # -- helpers --------------------------------------------------------------
    def _interior(self):
        return ((0, self.nx), (0, self.ny))

    def d(self, name):
        return self.dats[name]

    def make_session(self, backend: str = None, **overrides) -> Session:
        """A Session for this app: ``backend`` (default ``ooc``) with
        ``overrides`` as ExecutionConfig fields; ``ooc-sharded`` over
        the app's ``mesh`` when it has one."""
        return make_session(self.mesh, backend, overrides)

    # -- initialisation chain ---------------------------------------------------
    def record_init(self, rt: Session, seed: int = 0) -> None:
        nx, ny = self.nx, self.ny
        blk = self.block
        hx, hy = 2 * np.pi / nx, 2 * np.pi / ny

        def k_init(acc):
            ix, iy = acc.coords()
            x = ix.to(torch.float32) * hx
            y = iy.to(torch.float32) * hy
            one = torch.ones(acc.shape, dtype=torch.float32, device=acc.device)
            return {
                "density0": 1.0 + 0.2 * torch.sin(x) * torch.cos(y),
                "energy0": 2.5 + 0.5 * torch.cos(x),
                "volume": one, "xarea": one, "yarea": one,
                "xvel0": 0.1 * torch.sin(x),
                "yvel0": -0.1 * torch.cos(y),
            }

        rt.par_loop(
            "initialise", blk, self._interior(),
            [self.d(n) for n in ("density0", "energy0", "volume", "xarea",
                                  "yarea", "xvel0", "yvel0")],
            k_init,
        )

        def k_zero(acc):
            z = torch.zeros(acc.shape, dtype=torch.float32, device=acc.device)
            return {n: z for n in ("density1", "energy1", "pressure", "viscosity",
                                    "soundspeed", "xvel1", "yvel1")}

        rt.par_loop(
            "zero_fields", blk, self._interior(),
            [self.d(n) for n in ("density1", "energy1", "pressure",
                                  "viscosity", "soundspeed", "xvel1", "yvel1")],
            k_zero,
        )

    # -- physics loops ------------------------------------------------------------
    def _ideal_gas(self, rt, rho_name, e_name, tag):
        def k(acc):
            rho = acc(rho_name)
            e = acc(e_name)
            p = (_GAMMA - 1.0) * rho * e
            ss = torch.sqrt(torch.clamp_min(_GAMMA * p / torch.clamp_min(rho, 1e-10),
                                            1e-10))
            return {"pressure": p, "soundspeed": ss}

        rt.par_loop(
            f"ideal_gas{tag}", self.block, self._interior(),
            [self.d(rho_name), self.d(e_name), self.d("pressure"),
             self.d("soundspeed")],
            k,
        )

    def _viscosity(self, rt):
        def k(acc):
            du = acc("xvel0", (1, 0)) - acc("xvel0")
            dv = acc("yvel0", (0, 1)) - acc("yvel0")
            div = du + dv
            visc = torch.where(div < 0.0, 2.0 * acc("density0") * div * div, 0.0)
            return {"viscosity": visc}

        rt.par_loop(
            "viscosity", self.block, self._interior(),
            [self.d("xvel0"), self.d("yvel0"), self.d("density0"),
             self.d("viscosity")],
            k,
        )

    def _calc_dt(self, rt):
        def k(acc):
            ss = acc("soundspeed")
            u = acc("xvel0")
            v = acc("yvel0")
            speed = ss + torch.abs(u) + torch.abs(v)
            dt_local = 0.5 / torch.clamp_min(speed, 1e-6) / max(self.nx, self.ny)
            return {"dt": torch.min(dt_local)}

        rt.par_loop(
            "calc_dt", self.block, self._interior(),
            [self.d("soundspeed"), self.d("xvel0"), self.d("yvel0")],
            k, reductions=[ReductionSpec("dt", "min")],
        )

    def _pdv(self, rt, predict: bool, tag: str):
        dt = self.dt * (0.5 if predict else 1.0)
        dst_rho = "density1"
        dst_e = "energy1"

        def k(acc):
            div = (acc("xvel0", (1, 0)) - acc("xvel0")) + (acc("yvel0", (0, 1)) - acc("yvel0"))
            vol_change = 1.0 + dt * div
            rho = acc("density0") / torch.clamp_min(vol_change, 0.1)
            e = (acc("energy0") - dt * acc("pressure") * div
                 / torch.clamp_min(acc("density0"), 1e-10))
            return {dst_rho: rho, dst_e: e}

        rt.par_loop(
            f"pdv_{tag}", self.block, self._interior(),
            [self.d("xvel0"), self.d("yvel0"), self.d("density0"),
             self.d("energy0"), self.d("pressure"), self.d(dst_rho),
             self.d(dst_e)],
            k,
        )

    def _revert(self, rt):
        def k(acc):
            return {"density1": acc("density0"), "energy1": acc("energy0")}

        rt.par_loop(
            "revert", self.block, self._interior(),
            [self.d("density0"), self.d("energy0"), self.d("density1"),
             self.d("energy1")],
            k,
        )

    def _accelerate(self, rt):
        dt = self.dt
        rng = ((1, self.nx), (1, self.ny))

        def k(acc):
            # node-centred density from 4 surrounding cells
            nodal_mass = 0.25 * (acc("density0") + acc("density0", (-1, 0))
                                 + acc("density0", (0, -1)) + acc("density0", (-1, -1)))
            px = (acc("pressure") - acc("pressure", (-1, 0))
                  + acc("viscosity") - acc("viscosity", (-1, 0)))
            py = (acc("pressure") - acc("pressure", (0, -1))
                  + acc("viscosity") - acc("viscosity", (0, -1)))
            xv = acc("xvel0") - dt * px / torch.clamp_min(nodal_mass, 1e-10)
            yv = acc("yvel0") - dt * py / torch.clamp_min(nodal_mass, 1e-10)
            return {"xvel1": xv, "yvel1": yv}

        rt.par_loop(
            "accelerate", self.block, rng,
            [self.d("density0"), self.d("pressure"), self.d("viscosity"),
             self.d("xvel0"), self.d("yvel0"), self.d("xvel1"),
             self.d("yvel1")],
            k,
        )

    def _flux_calc(self, rt):
        dt = self.dt

        def k(acc):
            fx = 0.5 * dt * (acc("xvel1") + acc("xvel1", (0, 1))) * acc("xarea")
            fy = 0.5 * dt * (acc("yvel1") + acc("yvel1", (1, 0))) * acc("yarea")
            return {"vol_flux_x": fx, "vol_flux_y": fy}

        rt.par_loop(
            "flux_calc", self.block, self._interior(),
            [self.d("xvel1"), self.d("yvel1"), self.d("xarea"),
             self.d("yarea"), self.d("vol_flux_x"), self.d("vol_flux_y")],
            k,
        )

    def _advec_cell(self, rt, sweep: str):
        """Directionally-split donor-cell advection of density & energy."""
        flux = f"vol_flux_{sweep}"
        S_don = self.S_adv_x if sweep == "x" else self.S_adv_y
        off = (1, 0) if sweep == "x" else (0, 1)
        moff = (-1, 0) if sweep == "x" else (0, -1)
        rng = ((2, self.nx - 2), (2, self.ny - 2))

        def k_prevol(acc):
            pre = acc("volume") + (acc(flux, off) - acc(flux))
            post = acc("volume")
            return {"pre_vol": pre, "post_vol": post}

        rt.par_loop(
            f"advec_cell_{sweep}_vol", self.block, rng,
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

        # explicit_stencil escape hatch: the simplified donor formula only
        # reads offsets {-1, 0}, but the original CloverLeaf second-order
        # scheme reads the full 5-point advection stencil — keeping the wider
        # declared footprint preserves the paper's skew/footprint behaviour.
        rt.par_loop(
            f"advec_cell_{sweep}_flux", self.block, rng,
            [self.d(flux), self.d("density1"), self.d("energy1"),
             self.d("pre_mass"), self.d("ener_flux")],
            k_flux,
            explicit_stencil={"density1": S_don, "energy1": S_don},
        )

        def k_update(acc):
            f = acc(flux)
            fp = acc(flux, off)
            mflux_in = torch.where(f > 0, acc("pre_mass"), -acc("pre_mass"))
            mflux_out = torch.where(fp > 0, acc("pre_mass", off), -acc("pre_mass", off))
            pre_mass = acc("density1") * acc("pre_vol")
            post_mass = pre_mass + mflux_in - mflux_out
            rho = post_mass / torch.clamp_min(acc("post_vol"), 1e-10)
            e_in = acc("ener_flux")
            e_out = acc("ener_flux", off)
            post_e = ((pre_mass * acc("energy1") + e_in - e_out)
                      / torch.clamp_min(post_mass, 1e-10))
            return {"density1": rho, "energy1": post_e, "post_mass": post_mass}

        rt.par_loop(
            f"advec_cell_{sweep}_update", self.block, rng,
            [self.d(flux), self.d("pre_mass"), self.d("ener_flux"),
             self.d("pre_vol"), self.d("post_vol"), self.d("density1"),
             self.d("energy1"), self.d("post_mass")],
            k_update,
        )

    def _advec_mom(self, rt, sweep: str, vel: str):
        """Momentum advection, three loops as in the original: mass flux ->
        momentum flux (work array) -> velocity update (zero-stencil RW)."""
        flux = f"mass_flux_{sweep}"
        vflux = f"vol_flux_{sweep}"
        off = (1, 0) if sweep == "x" else (0, 1)
        moff = (-off[0], -off[1])
        rng = ((2, self.nx - 2), (2, self.ny - 2))
        v1 = f"{vel}1"
        mom = "advec_vol"  # momentum-flux work array (original: mom_flux)

        def k_mass_flux(acc):
            return {flux: acc(vflux) * 0.5 * (acc("density1") + acc("density1", off))}

        rt.par_loop(
            f"advec_mom_{sweep}_{vel}_mf", self.block, rng,
            [self.d(vflux), self.d("density1"), self.d(flux)],
            k_mass_flux,
        )

        def k_mom_flux(acc):
            f = acc(flux)
            donor = torch.where(f > 0, acc(v1, moff), acc(v1))
            return {mom: f * donor}

        rt.par_loop(
            f"advec_mom_{sweep}_{vel}_flx", self.block, rng,
            [self.d(flux), self.d(v1), self.d(mom)],
            k_mom_flux,
        )

        def k_update(acc):
            node_mass = torch.clamp_min(acc("post_mass"), 1e-10)
            return {v1: acc(v1) + (acc(mom) - acc(mom, off)) / node_mass}

        rt.par_loop(
            f"advec_mom_{sweep}_{vel}_up", self.block, rng,
            [self.d(mom), self.d("post_mass"), self.d(v1)],
            k_update,
        )

    def _update_halo(self, rt, fields, tag: str, depth: int = 2):
        """Reflective halo update, one loop per halo row/col per side (the
        original CloverLeaf's update_halo): writes halo cells from mirrored
        interior cells.  Besides fidelity (the original has ~70 such loop
        instances per step), this WARMS the halo rows so the §4.1 write-first
        elision applies to more data (cold-read uploads shrink)."""
        nx, ny = self.nx, self.ny
        sites = []
        # dim-0 (rows) first: row -k-1 mirrors row k; row nx+k mirrors nx-1-k
        for k in range(depth):
            sites.append((((-k - 1, -k), (0, ny)), (2 * k + 1, 0)))
            sites.append((((nx + k, nx + k + 1), (0, ny)), (-2 * k - 1, 0)))
        # dim-1 (cols) second, over the EXTENDED row range so the corners get
        # written too (as the original does — and the out-of-core download of
        # a halo row must not contain never-written bytes).
        for k in range(depth):
            sites.append((((-depth, nx + depth), (-k - 1, -k)), (0, 2 * k + 1)))
            sites.append((((-depth, nx + depth), (ny + k, ny + k + 1)),
                          (0, -2 * k - 1)))
        for i, (rng, off) in enumerate(sites):

            def k_halo(acc, fields=fields, off=off):
                return {f: acc(f, off) for f in fields}

            # Reads mirror cells, writes halo cells: inference splits each
            # field into READ(offset stencil) + WRITE(zero) args itself.
            rt.par_loop(
                f"update_halo_{tag}_{i}", self.block, rng,
                [self.d(f) for f in fields],
                k_halo,
            )

    def _reset_field(self, rt):
        def k(acc):
            return {"density0": acc("density1"), "energy0": acc("energy1"),
                    "xvel0": acc("xvel1"), "yvel0": acc("yvel1")}

        rt.par_loop(
            "reset_field", self.block, self._interior(),
            [self.d("density1"), self.d("energy1"), self.d("xvel1"),
             self.d("yvel1"), self.d("density0"), self.d("energy0"),
             self.d("xvel0"), self.d("yvel0")],
            k,
        )

    # -- drivers ------------------------------------------------------------------
    def record_timestep(self, rt: Session) -> None:
        """Record one timestep's loop chain (without the dt chain breaker):
        27 physics loops + 3 update_halo phases x 8 = 51 loops."""
        self._ideal_gas(rt, "density0", "energy0", "")
        self._viscosity(rt)
        self._update_halo(rt, ["pressure", "viscosity", "soundspeed"], "eos")
        self._pdv(rt, True, "predict")
        self._ideal_gas(rt, "density1", "energy1", "_pdv")
        self._revert(rt)
        self._accelerate(rt)
        self._pdv(rt, False, "correct")
        self._flux_calc(rt)
        self._update_halo(rt, ["vol_flux_x", "vol_flux_y", "xvel1", "yvel1"], "flux")
        first = "x" if self.step_count % 2 == 0 else "y"
        second = "y" if first == "x" else "x"
        for sweep in (first, second):
            self._advec_cell(rt, sweep)
            self._advec_mom(rt, sweep, "xvel")
            self._advec_mom(rt, sweep, "yvel")
            if sweep == first:
                self._update_halo(rt, ["density1", "energy1"], "advec")
        self._reset_field(rt)
        self.step_count += 1

    def record_summary(self, rt: Session) -> List[str]:
        """Field summary: the paper's every-10-steps long chain of reductions."""
        def k(acc):
            rho = acc("density0")
            e = acc("energy0")
            u = acc("xvel0")
            v = acc("yvel0")
            vol = acc("volume")
            ke = 0.5 * rho * (u * u + v * v)
            return {
                "sum_mass": torch.sum(rho * vol),
                "sum_ie": torch.sum(rho * e * vol),
                "sum_ke": torch.sum(ke * vol),
                "max_p": torch.max(acc("pressure")),
                "min_rho": torch.min(rho),
            }

        specs = [ReductionSpec("sum_mass", "sum"), ReductionSpec("sum_ie", "sum"),
                 ReductionSpec("sum_ke", "sum"), ReductionSpec("max_p", "max"),
                 ReductionSpec("min_rho", "min")]
        rt.par_loop(
            "field_summary", self.block, self._interior(),
            [self.d(n) for n in ("density0", "energy0", "xvel0", "yvel0",
                                  "volume", "pressure")],
            k, reductions=specs,
        )
        return [s.name for s in specs]

    def run(self, rt: Session, steps: int, dt_every: bool = True) -> Dict[str, float]:
        """Full driver: init, then per-step chains with the paper's breakers."""
        self.record_init(rt)
        rt.flush()
        rt.cyclic = True  # paper §4.1: set after the initialisation phase
        return self.run_steps(rt, 0, steps, dt_every)

    def run_steps(self, rt: Session, first: int, last: int,
                  dt_every: bool = True) -> Dict[str, float]:
        """Timesteps ``first`` .. ``last - 1`` of :meth:`run` (no init), with
        its breakers and summaries.  A run restored from a checkpoint taken
        after ``first`` timesteps (``Session.restore``, with ``dt``/``step_count``
        and ``rt.cyclic`` set back) continues with this exactly as the
        uninterrupted run does."""
        out: Dict[str, float] = {}
        for s in range(first, last):
            self._ideal_gas(rt, "density0", "energy0", "_dt")
            self._viscosity(rt)
            self._calc_dt(rt)
            if dt_every:
                self.dt = float(min(1e-4, rt.reduction("dt")))  # chain breaker
            self.record_timestep(rt)
            if self.summary_every and (s + 1) % self.summary_every == 0:
                for name in self.record_summary(rt):
                    out[name] = float(rt.reduction(name))
        rt.flush()
        return out

    def total_bytes(self) -> int:
        return sum(d.nbytes for d in self.dats.values())
