"""simulateMaster: the MD run loop, fixed-cadence shape.

Counterpart of ddcmd_tpu/run/simulate.py (reference ddcMD
src/masters.c:369-559), reduced to the main path: NGLF without barostat
or constraints, MARTINI nonbond through the cell-pair kernel.

One dispatch runs k steps as n_rebuilds blocks of `updateRate` steps:
each block wraps positions and rebuilds the cell slots, then runs its
steps on that slot list.  Nothing in a dispatch reads the device; the
per-step scalars, the overflow flag and the worst displacement are
reduced on the device and copied to the host once at the end of the
dispatch (the JAX package's superchunk_fixed, simulate.py:489-537).
The host then checks them:

  * overflow (a rebuild dropped particles): the dispatch is discarded,
    the planner's density safety grows by 1.3 and the grid is replanned;
  * non-finite energy: the kill switch raises (masters.c:470-475);
  * verlet-skin staleness (2 max|dr| >= deltaR on a step that reused a
    list): the dispatch is discarded and redone from the intact
    pre-dispatch state at halved rebuild cadence.  The thermostat noise
    is keyed by global step, so the redo replays the same noise.  Eight
    clean dispatches in a row double the cadence back; a stale redo
    restarts that count.
"""

from __future__ import annotations

import time as _time
import warnings

import numpy as np
import torch

from ..core.energy import EnergyInfo
from ..core.groups import kick_noise
from ..core.system import build_system
from ..integrators.nglf import StepState, first_energy_call, make_nglf_step
from ..objects import ObjectDB
from ..objects import units as U
from ..ops.cellpair import build_cell_slots
from ..ops.cellpair_half import plan_lanes
from .forces import build_force_fn
from .printinfo import PrintInfo

# integrator types that run the plain NGLF step when no barostat is set
_NGLF_TYPES = ("NGLF", "NGLFCONSTRAINT", "NGLFCONSTRAINTGPU",
               "NGLFCONSTRAINTGPULANGEVIN", "NGLFGPU", "NGLFGPULANGEVIN",
               "NGLFNEW")
_NOISE_CALLSITE_NGLF = 0


class Simulation:
    """Owns the force and step functions and the host loop."""

    def __init__(self, db: ObjectDB, base_dir: str = ".", *,
                 run_dir: str = ".", device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.run_dir = run_dir
        self.sysdef = sd = build_system(db, base_dir, dtype=torch.float32,
                                        device=self.device)
        if sd.integrator_type not in _NGLF_TYPES:
            raise NotImplementedError(
                f"integrator {sd.integrator_type} is not ported yet "
                "(ROADMAP queue 1, item 22)")
        if sd.integrator_parms["beta"] > 0:
            raise NotImplementedError(
                "the Berendsen barostat is not ported yet (ROADMAP queue 1, "
                "item 8)")
        if sd.n_constraints:
            raise NotImplementedError(
                "constraints are slice 2 (ROADMAP queue 1, item 13)")
        if sd.box.pbc & 7 != 7:
            raise NotImplementedError(
                "non-periodic axes run on the fallback cell engine, not "
                "ported yet (ROADMAP queue 1, item 20)")
        self._density_safety = 1.3
        self.grid = plan_lanes(sd.box.lengths.cpu().numpy().astype(np.float64),
                               sd.rcut_max, sd.neighbor_deltaR,
                               sd.state.n_local)
        self.force_fn = build_force_fn(sd, self.grid)
        self.step_fn = make_nglf_step(self.force_fn, sd.cfg.dt)
        self.printinfo = PrintInfo.from_deck(db, sd.cfg.printinfo_name)
        self.coeffs = sd.group_table.coefficients(
            sd.cfg.time, 0.5 * sd.cfg.dt, device=self.device)
        # the box is static (no barostat, no box(t)): its printed volume
        # and lengths are host constants
        L = sd.box.lengths.cpu().numpy()
        self._box_host = (float(np.prod(L.astype(np.float64))),
                          L.astype(np.float64))
        self._generator = torch.Generator(device=self.device)
        self._forced_spr = None
        self._clean_disp = 0
        # (steps, seconds) of each accepted dispatch, host clock around
        # work that ends in the dispatch's one device sync
        self.dispatch_log: list[tuple[int, float]] = []
        self.ss = StepState(
            state=sd.state, box=sd.box,
            energy=EnergyInfo.zero(device=self.device),
            loop=sd.cfg.loop, time=sd.cfg.time)

    # ------------------------------------------------------------------

    def replan(self):
        """Re-plan the cell grid at the current density safety; the cap
        never shrinks (the overflow ladder only grows it)."""
        sd = self.sysdef
        prev_cap = self.grid.cap
        self.grid = plan_lanes(
            self._box_host[1], sd.rcut_max, sd.neighbor_deltaR,
            sd.state.n_local, density_safety=self._density_safety)
        if self.grid.cap < prev_cap:
            self.grid = self.grid.with_cap(prev_cap)
        self.force_fn = build_force_fn(sd, self.grid)
        self.step_fn = make_nglf_step(self.force_fn, sd.cfg.dt)

    def _build_nbr(self, ss: StepState):
        """Wrap at rebuild; steps between rebuilds leave positions
        unwrapped so the cell-block image shifts stay exact."""
        r = ss.box.back_in_box(ss.state.r)
        ss = ss.replace(state=ss.state.replace(r=r))
        perm, overflow = build_cell_slots(r, ss.state.fmask, ss.box.lengths,
                                          self.grid)
        return ss, perm, overflow

    def first_energy(self) -> StepState:
        # a silent overflow would return energies from a dropped-pair
        # list: check the flag and replan like the run loop does
        for _ in range(10):
            ss, perm, ov = self._build_nbr(self.ss)
            if not bool(ov):
                self.ss = first_energy_call(ss, self.force_fn, perm)
                return self.ss
            self._density_safety *= 1.3
            self.replan()
        raise RuntimeError(
            "neighbor overflow persists in first_energy after repeated "
            "replans")

    def _noise(self, step: int) -> torch.Tensor:
        return kick_noise(self._generator, self.sysdef.random_seed, step,
                          _NOISE_CALLSITE_NGLF,
                          (2, self.ss.state.n_pad, 3))

    def _dispatch(self, ss: StepState, n_rebuilds: int, spr: int):
        """n_rebuilds * spr steps with no host sync until the end.
        Returns (ss, rows (k, 4) [eion, rk, tr virial, tr tion] as numpy,
        overflow, worst displacement of a step whose list was reused)."""
        dev = self.device
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        worst = torch.zeros((), dtype=torch.float32, device=dev)
        rows = []
        for _ in range(n_rebuilds):
            ss, perm, ov = self._build_nbr(ss)
            overflow = overflow | ov
            r0 = ss.state.r
            fmask = ss.state.fmask
            for i in range(spr):
                noise = self._noise(ss.loop)
                ss = self.step_fn(ss, perm, self.coeffs, noise[0], noise[1])
                if i < spr - 1:
                    # staleness only matters if more steps use this list
                    dr = ss.box.min_image(ss.state.r - r0)
                    md2 = torch.max((dr * dr).sum(dim=1) * fmask)
                    worst = torch.maximum(worst, torch.sqrt(md2))
                e = ss.energy
                rows.append(torch.stack([e.eion, e.rk, torch.trace(e.virial),
                                         torch.trace(e.tion)]))
        flags = torch.stack([overflow.to(torch.float32), worst])
        host = torch.cat([torch.stack(rows).reshape(-1), flags]).cpu()
        host = host.numpy().astype(np.float64)
        return ss, host[:-2].reshape(-1, 4), bool(host[-2]), float(host[-1])

    def run(self, n_loops: int | None = None, *, print_fn=None,
            max_steps_per_dispatch: int = 400) -> StepState:
        """Run the MD loop; returns the final StepState."""
        sd = self.sysdef
        cfg = sd.cfg
        if n_loops is None:
            n_loops = (cfg.deltaloop if cfg.deltaloop
                       else cfg.maxloop - self.ss.loop)
        update_rate = max(1, cfg.ddc_update_rate)
        self.first_energy()
        done = 0
        ov_retries = 0
        while done < n_loops:
            k = min(n_loops - done, max_steps_per_dispatch)
            spr = min(update_rate, self._forced_spr or update_rate)
            if k >= spr:
                n_rebuilds = k // spr
            else:
                spr, n_rebuilds = k, 1
            k = n_rebuilds * spr
            if sd.group_table.time_dependent:
                self.coeffs = sd.group_table.coefficients(
                    self.ss.time, 0.5 * cfg.dt, device=self.device)
            t0 = _time.perf_counter()
            ss_new, rows, overflow, worst = self._dispatch(self.ss,
                                                           n_rebuilds, spr)
            seconds = _time.perf_counter() - t0
            if overflow:
                ov_retries += 1
                if ov_retries > 8:
                    raise RuntimeError(
                        "neighbor overflow persists after repeated replans "
                        f"(loop {self.ss.loop})")
                self._density_safety *= 1.3
                self.replan()
                continue
            ov_retries = 0
            bad = ~np.isfinite(rows[:, 0] + rows[:, 1])
            if bad.any():
                raise FloatingPointError(
                    f"non-finite energy at loop "
                    f"{self.ss.loop + int(np.argmax(bad)) + 1} "
                    "(reference kill switch, masters.c:470-475)")
            if 2.0 * worst >= sd.neighbor_deltaR and spr > 1:
                warnings.warn(
                    f"neighbor list went stale (2*max_disp={2 * worst:.3f} "
                    f"nm >= deltaR={sd.neighbor_deltaR}); halving rebuild "
                    "cadence and redoing the dispatch", stacklevel=2)
                self._forced_spr = max(1, spr // 2)
                self._clean_disp = 0
                continue
            if self._forced_spr is not None:
                self._clean_disp += 1
                if self._clean_disp >= 8:
                    self._clean_disp = 0
                    fs = 2 * self._forced_spr
                    self._forced_spr = None if fs >= update_rate else fs
            self.ss = ss_new
            done += k
            self.dispatch_log.append((k, seconds))
            self._emit_prints(rows, k, print_fn)
        return self.ss

    def _emit_prints(self, rows, k, print_fn):
        cfg = self.sysdef.cfg
        n_global = self.sysdef.state.n_local
        vol, lengths = self._box_host
        loop_end = self.ss.loop
        for j in range(k):
            loop = loop_end - k + 1 + j
            if not (cfg.printrate and loop % cfg.printrate == 0):
                continue
            eion, rk, tr_vir, tr_tion = rows[j]
            dof = 3.0 * n_global - self.sysdef.n_constraints
            temperature = 2.0 * rk / (dof * U.kB)
            if self.printinfo.print_molecular_pressure:
                # single-bead molecules: molecular virial == virial;
                # P = (tr_virial + 3 N_mol kB T) / 3V (molecularPressure.c)
                pressure = ((tr_vir + 3.0 * n_global * U.kB * temperature)
                            / (3.0 * vol))
            else:
                pressure = (tr_vir + tr_tion) / (3.0 * vol)
            time_ps = self.ss.time - (k - 1 - j) * cfg.dt
            line = self.printinfo.row(loop, time_ps, eion, rk, temperature,
                                      pressure, vol, lengths, n_global)
            if print_fn:
                print_fn(line)
            else:
                self.printinfo.emit(line, self.run_dir)


def simulate_master(db: ObjectDB, base_dir: str = ".", run_dir: str = ".",
                    n_loops: int | None = None, device=None) -> Simulation:
    sim = Simulation(db, base_dir, run_dir=run_dir, device=device)
    sim.run(n_loops)
    return sim
