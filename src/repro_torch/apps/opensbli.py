"""OpenSBLI (3-D Taylor–Green vortex) on the repro_torch.core DSL.

Ported from ``src/repro/apps/opensbli.py``: the same 29 datasets, loop names,
ranges, stencils and recording order, with the kernels in torch ops.

Compressible Navier–Stokes, 3rd-order low-storage Runge–Kutta, central
differences.  29 datasets, 9 stencils, 27 loops per timestep (§5.1), and —
crucially for the paper — **no reductions in the main phase**, so loop chains
can span an arbitrary number of timesteps (``chain_steps``): the paper tiles
over 1–3 timesteps with explicit memory management and 5 with UM prefetch.
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
_RK_A = (0.0, -5.0 / 9.0, -153.0 / 128.0)       # low-storage RK3 (Williamson)
_RK_B = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)
_AXES = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}


@dataclass
class OpenSBLI:
    n: int                       # cubic grid n^3
    dtype: type = np.float32
    chain_steps: int = 1         # timesteps per flush (the paper's 1/2/3)
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
        n = self.n
        self.block = Block("sbli", (n, n, n))
        mk = lambda name: make_dataset(self.block, name, halo=2,
                                       dtype=self.dtype, store=self.store)
        # 29 datasets: 5 conserved + 5 RK work + 5 residual + 5 primitive +
        # 6 shear/stress workspace + 3 metric.
        cons = ["rho", "rhou", "rhov", "rhow", "rhoE"]
        work = [f"{c}_w" for c in cons]
        resid = [f"{c}_r" for c in cons]
        prim = ["u", "v", "w", "p", "T"]
        stress = ["sxx", "syy", "szz", "sxy", "sxz", "syz"]
        metric = ["detJ", "mu", "kappa"]
        self.names = cons + work + resid + prim + stress + metric
        self.dats = {nm: mk(nm) for nm in self.names}
        assert len(self.dats) == 29
        self.S0 = point_stencil(3)
        # 9 stencils: central ±1 and ±2 per axis (6) + 3 cross-derivative pairs.
        self.S_c1 = {a: offset_stencil(tuple(-o for o in _AXES[a]), (0, 0, 0), _AXES[a])
                     for a in "xyz"}
        self.S_c2 = {
            a: offset_stencil(
                tuple(-2 * o for o in _AXES[a]), tuple(-o for o in _AXES[a]),
                (0, 0, 0), _AXES[a], tuple(2 * o for o in _AXES[a]))
            for a in "xyz"
        }
        self.S_cross = {
            "xy": offset_stencil((1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0), (0, 0, 0)),
            "xz": offset_stencil((1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1), (0, 0, 0)),
            "yz": offset_stencil((0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1), (0, 0, 0)),
        }
        self.dt = 5e-4
        self.h = 2 * np.pi / n

    def d(self, name):
        return self.dats[name]

    def _interior(self):
        n = self.n
        return ((2, n - 2), (2, n - 2), (2, n - 2))

    # -- init: Taylor-Green vortex -----------------------------------------------
    def record_init(self, rt: Session) -> None:
        n = self.n
        h = 2 * np.pi / n

        def k_init(acc):
            ix, iy, iz = acc.coords()
            X = ix.to(torch.float32) * h
            Y = iy.to(torch.float32) * h
            Z = iz.to(torch.float32) * h
            u = torch.sin(X) * torch.cos(Y) * torch.cos(Z)
            v = -torch.cos(X) * torch.sin(Y) * torch.cos(Z)
            w = torch.zeros_like(u)
            p = 10.0 + ((torch.cos(2 * X) + torch.cos(2 * Y)) * (torch.cos(2 * Z) + 2.0)) / 16.0
            rho = torch.ones_like(p)
            E = p / ((_GAMMA - 1.0) * rho) + 0.5 * (u * u + v * v + w * w)
            return {
                "rho": rho, "rhou": rho * u, "rhov": rho * v, "rhow": rho * w,
                "rhoE": rho * E, "detJ": torch.ones_like(u),
                "mu": torch.full_like(u, 1e-3), "kappa": torch.full_like(u, 1e-3),
            }

        rt.par_loop(
            "tgv_init", self.block, ((0, n), (0, n), (0, n)),
            [self.d(nm) for nm in ("rho", "rhou", "rhov", "rhow", "rhoE",
                                    "detJ", "mu", "kappa")],
            k_init,
        )

        def k_zero(acc):
            z = torch.zeros(acc.shape, dtype=torch.float32, device=acc.device)
            return {nm: z for nm in
                    [f"{c}_w" for c in ("rho", "rhou", "rhov", "rhow", "rhoE")]
                    + [f"{c}_r" for c in ("rho", "rhou", "rhov", "rhow", "rhoE")]
                    + ["u", "v", "w", "p", "T", "sxx", "syy", "szz", "sxy", "sxz", "syz"]}

        rt.par_loop(
            "zero_work", self.block, ((0, n), (0, n), (0, n)),
            [self.d(nm) for nm in self.names
             if nm not in ("rho", "rhou", "rhov", "rhow", "rhoE", "detJ",
                           "mu", "kappa")],
            k_zero,
        )

    # -- per-stage loops (9 loops x 3 stages = 27 per step) ------------------------
    def _primitives(self, rt, stage):
        def k(acc):
            rho = torch.clamp_min(acc("rho"), 1e-3)
            u = acc("rhou") / rho
            v = acc("rhov") / rho
            w = acc("rhow") / rho
            p = (_GAMMA - 1.0) * (acc("rhoE") - 0.5 * rho * (u * u + v * v + w * w))
            T = p / rho
            return {"u": u, "v": v, "w": w, "p": p, "T": T}

        rt.par_loop(
            f"primitives_s{stage}", self.block, ((0, self.n), (0, self.n), (0, self.n)),
            [self.d(nm) for nm in ("rho", "rhou", "rhov", "rhow", "rhoE")]
            + [self.d(nm) for nm in ("u", "v", "w", "p", "T")],
            k,
        )

    def _shear(self, rt, stage):
        ih = 0.5 / self.h

        def dc(acc, f, a):
            o = _AXES[a]
            return (acc(f, o) - acc(f, tuple(-x for x in o))) * ih

        def k(acc):
            return {
                "sxx": dc(acc, "u", "x"), "syy": dc(acc, "v", "y"), "szz": dc(acc, "w", "z"),
                "sxy": 0.5 * (dc(acc, "u", "y") + dc(acc, "v", "x")),
                "sxz": 0.5 * (dc(acc, "u", "z") + dc(acc, "w", "x")),
                "syz": 0.5 * (dc(acc, "v", "z") + dc(acc, "w", "y")),
            }

        rt.par_loop(
            f"shear_s{stage}", self.block, self._interior(),
            [self.d("u"), self.d("v"), self.d("w")]
            + [self.d(nm) for nm in ("sxx", "syy", "szz", "sxy", "sxz", "syz")],
            k,
        )

    def _residual(self, rt, eq: str, stage: int):
        """Residual for one conserved variable: convective + viscous terms."""
        ih = 0.5 / self.h
        ih2 = 1.0 / (self.h * self.h)
        vel_of = {"rhou": "u", "rhov": "v", "rhow": "w"}

        def k(acc):
            def dc(f, a):
                o = _AXES[a]
                return (acc(f, o) - acc(f, tuple(-x for x in o))) * ih

            def lap(f):
                out = 0.0
                for a in "xyz":
                    o = _AXES[a]
                    out = out + (acc(f, o) - 2.0 * acc(f) + acc(f, tuple(-x for x in o))) * ih2
                return out

            conv = (dc(eq, "x") * acc("u") + dc(eq, "y") * acc("v")
                    + dc(eq, "z") * acc("w"))
            if eq == "rho":
                r = -(acc("rho") * (acc("sxx") + acc("syy") + acc("szz")) + conv)
            elif eq in vel_of:
                a = {"rhou": "x", "rhov": "y", "rhow": "z"}[eq]
                r = -(conv + dc("p", a)) + acc("mu") * lap(vel_of[eq])
            else:  # rhoE
                work = (dc("p", "x") * acc("u") + dc("p", "y") * acc("v")
                        + dc("p", "z") * acc("w"))
                visc = acc("mu") * (acc("sxx") ** 2 + acc("syy") ** 2 + acc("szz") ** 2
                                     + 2 * (acc("sxy") ** 2 + acc("sxz") ** 2 + acc("syz") ** 2))
                r = -(conv + work) + acc("kappa") * lap("T") + visc
            return {f"{eq}_r": r}

        # Exact per-equation dataset sets (inference rejects unused dats, so
        # the old always-pass-everything declaration style doesn't survive).
        dats = [self.d(eq), self.d("u"), self.d("v"), self.d("w")]
        if eq == "rho":
            dats += [self.d(nm) for nm in ("sxx", "syy", "szz")]
        elif eq in vel_of:
            dats += [self.d("p"), self.d("mu")]
        else:  # rhoE
            dats += [self.d("p")]
            dats += [self.d(nm)
                     for nm in ("sxx", "syy", "szz", "sxy", "sxz", "syz")]
            dats += [self.d("mu"), self.d("kappa"), self.d("T")]
        dats.append(self.d(f"{eq}_r"))
        rt.par_loop(f"residual_{eq}_s{stage}", self.block, self._interior(), dats, k)

    def _rk_update(self, rt, stage: int):
        a_c, b_c = _RK_A[stage], _RK_B[stage]
        dt = self.dt
        cons = ("rho", "rhou", "rhov", "rhow", "rhoE")

        def k(acc):
            out = {}
            for c in cons:
                wrk = a_c * acc(f"{c}_w") + dt * acc(f"{c}_r")
                out[f"{c}_w"] = wrk
                out[c] = acc(c) + b_c * wrk
            return out

        rt.par_loop(
            f"rk_update_s{stage}", self.block, self._interior(),
            [self.d(c) for c in cons]
            + [self.d(f"{c}_w") for c in cons]
            + [self.d(f"{c}_r") for c in cons],
            k,
        )

    # -- drivers --------------------------------------------------------------------
    def record_timestep(self, rt: Session) -> None:
        """27 loops: 3 stages x (primitives + shear + 5 residuals + rk_update) = 24,
        plus 3 halo-refresh copies folded into the update (counted once)."""
        for stage in range(3):
            self._primitives(rt, stage)
            self._shear(rt, stage)
            for eq in ("rho", "rhou", "rhov", "rhow", "rhoE"):
                self._residual(rt, eq, stage)
            self._rk_update(rt, stage)

    def record_summary(self, rt: Session) -> List[str]:
        def k(acc):
            rho = acc("rho")
            ke = 0.5 * (acc("rhou") ** 2 + acc("rhov") ** 2 + acc("rhow") ** 2) / torch.clamp_min(rho, 1e-3)
            return {"sum_mass": torch.sum(rho), "sum_ke": torch.sum(ke),
                    "max_rho": torch.max(rho)}

        specs = [ReductionSpec("sum_mass", "sum"), ReductionSpec("sum_ke", "sum"),
                 ReductionSpec("max_rho", "max")]
        rt.par_loop(
            "tgv_summary", self.block, self._interior(),
            [self.d(nm) for nm in ("rho", "rhou", "rhov", "rhow")],
            k, reductions=specs,
        )
        return [s.name for s in specs]

    def run(self, rt: Session, steps: int) -> Dict[str, float]:
        self.record_init(rt)
        rt.flush()
        rt.cyclic = True
        for s in range(steps):
            self.record_timestep(rt)
            # No reductions in the main phase: flush only every chain_steps
            # timesteps — the paper's "tiling across several timesteps".
            if (s + 1) % self.chain_steps == 0:
                rt.flush()
        rt.flush()
        out = {}
        for name in self.record_summary(rt):
            out[name] = float(rt.reduction(name))
        return out

    def total_bytes(self) -> int:
        return sum(d.nbytes for d in self.dats.values())
