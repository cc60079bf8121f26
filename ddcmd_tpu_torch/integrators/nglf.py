"""NGLF integrator: leapfrog with GROUP half-kicks.

Counterpart of ddcmd_tpu/integrators/nglf.py (reference nglf, ddcMD
src/nglf.c:67-112) without barostat, constraints, shear hooks or box(t):

  1. GROUP velocityUpdate(FRONT, 0.5 dt)     [half kick]
  2. r += dt v                                [drift]
  3. forces
  4. GROUP velocityUpdate(BACK, 0.5 dt)      [half kick]
  5. kinetic terms

Positions are NOT wrapped after the drift: the cell-pair engine's static
image shifts need positions consistent with the rebuild-time binning, so
the run loop wraps at each rebuild instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

from ..core.energy import EnergyInfo, kinetic_terms
from ..core.groups import velocity_update


@dataclass
class StepState:
    """Everything that evolves across steps.  loop and time live on the
    host: eager PyTorch knows them without reading the device."""

    state: object            # core.state.State
    box: object              # core.box.Box
    energy: EnergyInfo
    loop: int
    time: float              # internal ps

    def replace(self, **kw) -> "StepState":
        return dataclasses.replace(self, **kw)


def make_nglf_step(force_fn: Callable, dt: float):
    """step(ss, handle, coeffs, noise_front, noise_back) -> StepState.

    force_fn(state, box, handle) -> (f (N,3), e_pot, virial (3,3), pe (N,));
    noise_front/noise_back: (n_pad, 3) standard-normal draws for the two
    half-kicks (core.groups.kick_noise)."""

    def step(ss: StepState, handle, coeffs, noise_front, noise_back):
        state, box = ss.state, ss.box
        half = 0.5 * dt
        mask = state.mask

        v = velocity_update("front", state.v, state.f, state.mass,
                            state.group, coeffs, half, noise_front, mask)
        state = state.replace(v=v, r=state.r + dt * v)

        f, e_pot, virial, pe = force_fn(state, box, handle)
        state = state.replace(f=f, pe=pe)

        v = velocity_update("back", state.v, f, state.mass, state.group,
                            coeffs, half, noise_back, mask)
        state = state.replace(v=v)

        fmask = state.fmask
        rk, tion = kinetic_terms(v, state.mass, fmask)
        energy = EnergyInfo(eion=e_pot, rk=rk, virial=virial, tion=tion,
                            number=fmask.sum())
        return StepState(state=state, box=box, energy=energy,
                         loop=ss.loop + 1, time=ss.time + dt)

    return step


def first_energy_call(ss: StepState, force_fn, handle) -> StepState:
    """firstEnergyCall analog (ddcMD src/masters.c:579-612)."""
    f, e_pot, virial, pe = force_fn(ss.state, ss.box, handle)
    state = ss.state.replace(f=f, pe=pe)
    fmask = state.fmask
    rk, tion = kinetic_terms(state.v, state.mass, fmask)
    energy = EnergyInfo(eion=e_pot, rk=rk, virial=virial, tion=tion,
                        number=fmask.sum())
    return ss.replace(state=state, energy=energy)
