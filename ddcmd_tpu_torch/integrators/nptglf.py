"""NPTGLF: isotropic NPT with a zeta barostat friction variable.

Counterpart of ddcmd_tpu/integrators/nptglf.py (reference ddcMD
src/nptglf.c:40-155).  Step structure:

  deltap = pion - Peq ; zeta += 0.5 dt deltap
  v *= exp(-zeta dt / (6 Gamma vol_atom))          [barostat drag]
  group half-kicks (FRONT)
  vol_atom += 0.5 dt zeta / Gamma ; fac = exp(+...)
  r = (fac r + dt v) fac                           [breathing drift]
  vol_atom += 0.5 dt zeta / Gamma ; box volume updated
  forces
  group half-kicks (BACK)
  zeta += 0.5 dt deltap' with a 5-iteration self-consistent velocity
  rescale fac (nptglf.c:120-147); v *= fac.

The three barostat pieces (nptglf_open, nptglf_drift, nptglf_close) are
what the single-device step and the brick mesh's step
(parallel/brickstep.py) both run; the mesh passes them mesh-wide sums.
zeta is restart-persisted (nptglf_writedynamic, nptglf.c:34-38; the
port's io/restart.py writes it).
"""

from __future__ import annotations

import torch

from ..core.energy import EnergyInfo, kinetic_terms
from ..core.groups import velocity_update
from .nglf import StepState


def nptglf_open(zeta, ptens, vol, n_global: int, dt: float, Gamma: float,
                Peq: float):
    """The first zeta half-step from the last step's pressure (ptens: its
    virial plus kinetic tensor, (3, 3)) at volume vol: (zeta, vol_atom,
    drag), drag the velocity factor applied before the front kick."""
    vol_atom = vol / n_global
    pion = torch.trace(ptens) / (3.0 * vol)
    zeta = zeta + 0.5 * dt * (pion - Peq)
    drag = torch.exp(-zeta * dt / (6.0 * Gamma * vol_atom))
    return zeta, vol_atom, drag


def nptglf_drift(r, v, zeta, vol_atom, vol, n_global: int, dt: float,
                 Gamma: float):
    """The breathing drift: (r, lam, vol_atom), lam the isotropic (3,)
    box scale that takes the volume vol to n_global vol_atom."""
    vol_atom = vol_atom + 0.5 * dt / Gamma * zeta
    fac = torch.exp(zeta * dt / (6.0 * Gamma * vol_atom))
    r = (fac * r + dt * v) * fac
    vol_atom = vol_atom + 0.5 * dt / Gamma * zeta
    lam = torch.pow(vol_atom * n_global / vol, 1.0 / 3.0).expand(3)
    return r, lam, vol_atom


def nptglf_close(zeta, virial, tion, rk, vol_new, vol_atom, dt: float,
                 Gamma: float, Peq: float):
    """The second zeta half-step with the self-consistent velocity
    rescale (nptglf.c:120-147) from the step's virial, kinetic tensor and
    kinetic energy after the back kick: (zeta, fac), v *= fac."""
    p0 = torch.trace(virial + tion) / (3.0 * vol_new)
    zeta0 = zeta
    fac = torch.exp(-(zeta0 + 0.5 * dt * (p0 - Peq)) * dt
                    / (6.0 * Gamma * vol_atom))
    for _ in range(5):
        pion_i = p0 + (fac * fac - 1.0) * (2.0 / 3.0) * rk / vol_new
        zeta = zeta0 + 0.5 * dt * (pion_i - Peq)
        fac = torch.exp(-zeta * dt / (6.0 * Gamma * vol_atom))
    return zeta, fac


def make_nptglf_step(force_fn, dt: float, *, n_global: int, Gamma: float,
                     Peq: float, wrap_positions: bool = False,
                     has_berendsen: bool = False):
    """step(ss, handle, coeffs, noise_front, noise_back, box_lam=None,
    draws=None) -> StepState, the NGLF step's signature; NPTGLF reads
    neither box(t) nor the hook groups (nptglf.py of the JAX package)."""

    def step(ss: StepState, handle, coeffs, noise_front, noise_back,
             box_lam=None, draws=None) -> StepState:
        state, box = ss.state, ss.box
        half = 0.5 * dt
        mask = state.mask
        dtype = state.r.dtype

        vol = box.volume
        e = ss.energy
        zeta, vol_atom, drag = nptglf_open(
            ss.zeta.to(dtype), e.virial + e.tion, vol, n_global, dt, Gamma,
            Peq)
        v = velocity_update("front", state.v * drag, state.f, state.mass,
                            state.group, coeffs, half, noise_front, mask,
                            has_berendsen)
        r, lam, vol_atom = nptglf_drift(state.r, v, zeta, vol_atom, vol,
                                        n_global, dt, Gamma)
        box = box.scale(lam)
        if wrap_positions:
            r = box.back_in_box(r)
        state = state.replace(r=r, v=v)

        f, e_pot, virial, pe = force_fn(state, box, handle)
        state = state.replace(f=f, pe=pe)

        v = velocity_update("back", state.v, f, state.mass, state.group,
                            coeffs, half, noise_back, mask)
        fmask = state.fmask
        rk, tion = kinetic_terms(v, state.mass, fmask)
        zeta, fac = nptglf_close(zeta, virial, tion, rk, box.volume,
                                 vol_atom, dt, Gamma, Peq)
        state = state.replace(v=v * fac)
        energy = EnergyInfo(eion=e_pot, rk=rk * fac * fac, virial=virial,
                            tion=tion * fac * fac, number=fmask.sum())
        return ss.replace(state=state, box=box, energy=energy,
                          loop=ss.loop + 1, time=ss.time + dt, zeta=zeta)

    return step
