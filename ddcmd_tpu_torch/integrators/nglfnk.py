"""NGLFNK: Langevin-piston semi-anisotropic NPT in scaled coordinates.

Counterpart of ddcmd_tpu/integrators/nglfnk.py (reference ddcMD
src/nglfNK.c:38-160).  The box lengths L are dynamical variables with
per-axis piston masses W; particles evolve in fractional coordinates
S = r/L with Langevin friction mu = 1/tau and matched thermal noise; the
piston is driven by the per-axis pressure with Pxx=Pyy averaged:

  dSdt += dt/2 * ((f/m - mu dLdt S + sigma g1) - (mu L + 2 dLdt) dSdt)/L
  dLdt += dt/2 * V/(W L) (P_axis - Peq)
  S    += dt dSdt ;  L += dt dLdt        [drift: particles + box]
  forces at the new geometry
  dLdt += dt/2 * V/(W L) (P_axis' - Peq)
  dSdt  = (dSdt + dt/2 (f/m - mu dLdt S + sigma g2)/L)
          / (1 + dt/2 (mu L + 2 dLdt)/L)  [implicit back half-kick]
  v     = L dSdt + S dLdt

with the JAX package's documented departures from the reference's
experimental code: P_axis = (virial + tion)_aa / V in both half-steps; S
origin-centred and unwrapped between rebuilds on the cell engines; the
noise g1, g2 drawn per step (the front and back draws of the NGLF
step's callsite) rather than from per-particle LCG64 streams.  The
GROUP coefficients play no part: NGLFNK is its own thermostat.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.box import geom_volume
from ..core.energy import EnergyInfo, kinetic_terms
from .nglf import StepState


class PistonNK:
    """The NGLFNK arithmetic of one step in three pieces around the force
    call, which the single-device step (make_nglfnk_step) and the brick
    mesh's step (parallel/brickstep.py) both run: front (the front
    half-kick, the first piston half-step from the last step's pressure
    tensor, the drift of particles and box), half_velocity (the
    velocities whose kinetic tensor the back piston kick reads) and back
    (the second piston half-step, the implicit back half-kick).  The
    mesh passes the pressure tensors summed over its ranks.  h_frac:
    None for an orthorhombic box; a static (3,3) shape matrix for a
    triclinic one, with h = h_frac @ diag(L) (fixed cell shape, per-axis
    piston lengths L): r, v and f are de-tilted by h_frac^-1, run the
    per-axis dynamics, and map back -- the diagonal algorithm exactly
    when h_frac = I."""

    def __init__(self, dt: float, *, T: float, tau: float, Peq: float, W,
                 kB: float, h_frac=None):
        self.dt, self.T, self.tau, self.Peq, self.kB = dt, T, tau, Peq, kB
        self.W = np.asarray(W, dtype=np.float64)
        self.h_frac = h_frac
        self._consts = {}

    def tensors(self, dtype, dev):
        """W, h_frac and its inverse on the device, made once (a host
        copy each step would wait for the stream)."""
        key = (dtype, dev)
        if key not in self._consts:
            def ten(x):
                return torch.as_tensor(x, dtype=dtype, device=dev)

            hf = self.h_frac
            self._consts[key] = (ten(self.W), None, None) if hf is None \
                else (ten(self.W), ten(np.asarray(hf)),
                      ten(np.linalg.inv(np.asarray(hf))))
        return self._consts[key]

    @staticmethod
    def axis_pressure(ptens, V):
        """Per-axis pressure from a virial plus kinetic tensor, Pxx and
        Pyy averaged."""
        p = torch.diagonal(ptens) / V
        pxy = 0.5 * (p[0] + p[1])
        return torch.stack([pxy, pxy, p[2]])

    def front(self, r, v, f, mass, fmask, h, bdot, ptens, g1):
        """(carry, r, h) after the drift: r and h the new positions
        (unwrapped) and box, carry what the later pieces read."""
        dt, half = self.dt, 0.5 * self.dt
        mask = fmask[:, None]
        Wt, hf, hf_inv = self.tensors(r.dtype, r.device)
        if hf is None:
            L = torch.diagonal(h)
            r_p, v_p, f_p = r, v, f
        else:
            # de-tilted frame: h = h_frac diag(L)
            L = torch.diagonal(hf_inv @ h)
            r_p = r @ hf_inv.T
            v_p = v @ hf_inv.T
            f_p = f @ hf_inv.T
        V = geom_volume(L if hf is None else h)
        dLdt = bdot.to(r.dtype)

        S = r_p / L
        dSdt = (v_p - r_p * (dLdt / L)) / L

        mu = 1.0 / self.tau
        rmass = (1.0 / mass)[:, None]
        sigma = torch.sqrt(2.0 * self.kB * self.T * (rmass * mu) / half)

        acc = f_p * rmass - mu * dLdt * S + sigma * g1
        dSdt = dSdt + half * (acc - (mu * L + 2.0 * dLdt) * dSdt) / L
        dSdt = dSdt * mask

        P = self.axis_pressure(ptens, V)
        dLdt = dLdt + half * V / (Wt * L) * (P - self.Peq)

        S = S + dt * dSdt
        L = L + dt * dLdt
        if hf is None:
            h = torch.diag(L)
            r = S * L
        else:
            h = hf * L[None, :]
            r = (S * L) @ hf.T
        carry = dict(S=S, dSdt=dSdt, dLdt=dLdt, L=L, mask=mask,
                     rmass=rmass, sigma=sigma)
        return carry, r, h

    def wrapped(self, carry, r):
        """carry with S taken from the wrapped positions r."""
        _, _, hf_inv = self.tensors(r.dtype, r.device)
        return dict(carry, S=(r if hf_inv is None else r @ hf_inv.T)
                    / carry["L"])

    def half_velocity(self, carry):
        """The canonical velocities at the half step mapped to native
        space (the back piston kick's kinetic tensor)."""
        c = carry
        _, hf, _ = self.tensors(c["L"].dtype, c["L"].device)
        v_half = (c["L"] * c["dSdt"] + c["S"] * c["dLdt"]) * c["mask"]
        if hf is not None:
            v_half = v_half @ hf.T        # native frame (virial is native)
        return v_half

    def back(self, carry, f, ptens_half, V, g2):
        """(v, dLdt) after the second piston half-step (pressure from the
        step's virial plus the half-step kinetic tensor, ptens_half, at
        the new volume V) and the implicit back half-kick."""
        c = carry
        half = 0.5 * self.dt
        Wt, hf, hf_inv = self.tensors(f.dtype, f.device)
        L, S, mask = c["L"], c["S"], c["mask"]
        P2 = self.axis_pressure(ptens_half, V)
        dLdt = c["dLdt"] + half * V / (Wt * L) * (P2 - self.Peq)

        mu = 1.0 / self.tau
        f_p2 = f if hf is None else f @ hf_inv.T
        acc2 = f_p2 * c["rmass"] - mu * dLdt * S + c["sigma"] * g2
        dSdt = ((c["dSdt"] + half * acc2 / L)
                / (1.0 + half * (mu * L + 2.0 * dLdt) / L))
        dSdt = dSdt * mask

        v = (L * dSdt + S * dLdt) * mask
        if hf is not None:
            v = v @ hf.T
        return v, dLdt


def make_nglfnk_step(force_fn, dt: float, *, T: float, tau: float,
                     Peq: float, W, kB: float, wrap_positions: bool = False,
                     h_frac=None):
    """step(ss, handle, coeffs, g1, g2, box_lam=None, draws=None) ->
    StepState (PistonNK's pieces around the force call; h_frac as
    PistonNK takes it)."""
    piston = PistonNK(dt, T=T, tau=tau, Peq=Peq, W=W, kB=kB, h_frac=h_frac)

    def step(ss: StepState, handle, coeffs, g1, g2, box_lam=None,
             draws=None) -> StepState:
        state, box = ss.state, ss.box
        e = ss.energy
        carry, r, h = piston.front(state.r, state.v, state.f, state.mass,
                                   state.fmask, box.h, ss.bdot,
                                   e.virial + e.tion, g1)
        box = dataclasses.replace(box, h=h)
        if wrap_positions:
            r = box.back_in_box(r)
            carry = piston.wrapped(carry, r)
        state = state.replace(r=r)

        f, e_pot, virial, pe = force_fn(state, box, handle)
        state = state.replace(f=f, pe=pe)

        _, tion_h = kinetic_terms(piston.half_velocity(carry), state.mass,
                                  state.fmask)
        v, dLdt = piston.back(carry, f, virial + tion_h, box.volume, g2)
        state = state.replace(v=v)
        fmask = state.fmask
        rk, tion = kinetic_terms(v, state.mass, fmask)
        energy = EnergyInfo(eion=e_pot, rk=rk, virial=virial, tion=tion,
                            number=fmask.sum())
        return ss.replace(state=state, box=box, energy=energy,
                          loop=ss.loop + 1, time=ss.time + dt, bdot=dLdt)

    return step
