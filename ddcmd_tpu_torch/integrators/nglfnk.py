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

from ..core.energy import EnergyInfo, kinetic_terms
from .nglf import StepState


def make_nglfnk_step(force_fn, dt: float, *, T: float, tau: float,
                     Peq: float, W, kB: float, wrap_positions: bool = False,
                     h_frac=None):
    """step(ss, handle, coeffs, g1, g2, box_lam=None, draws=None) ->
    StepState.  h_frac: None for an orthorhombic box; a static (3,3)
    shape matrix for a triclinic one, with h = h_frac @ diag(L) (fixed
    cell shape, per-axis piston lengths L): r, v and f are de-tilted by
    h_frac^-1, run the per-axis dynamics, and map back -- the diagonal
    algorithm exactly when h_frac = I."""
    W = np.asarray(W, dtype=np.float64)
    consts = {}

    def tensors(dtype, dev):
        """W, h_frac and its inverse on the device, made once (a host
        copy each step would wait for the stream)."""
        key = (dtype, dev)
        if key not in consts:
            def ten(x):
                return torch.as_tensor(x, dtype=dtype, device=dev)

            consts[key] = (ten(W), None, None) if h_frac is None else (
                ten(W), ten(np.asarray(h_frac)),
                ten(np.linalg.inv(np.asarray(h_frac))))
        return consts[key]

    def axis_pressure(virial, tion, V):
        p = (torch.diagonal(virial) + torch.diagonal(tion)) / V
        pxy = 0.5 * (p[0] + p[1])
        return torch.stack([pxy, pxy, p[2]])

    def step(ss: StepState, handle, coeffs, g1, g2, box_lam=None,
             draws=None) -> StepState:
        state, box = ss.state, ss.box
        half = 0.5 * dt
        mask = state.fmask[:, None]
        Wt, hf, hf_inv = tensors(state.r.dtype, state.r.device)
        if h_frac is None:
            L = box.lengths
            r_p, v_p, f_p = state.r, state.v, state.f
        else:
            # de-tilted frame: h = h_frac diag(L)
            L = torch.diagonal(hf_inv @ box.h)
            r_p = state.r @ hf_inv.T
            v_p = state.v @ hf_inv.T
            f_p = state.f @ hf_inv.T
        V = box.volume
        dLdt = ss.bdot.to(state.r.dtype)

        S = r_p / L
        dSdt = (v_p - r_p * (dLdt / L)) / L

        mu = 1.0 / tau
        rmass = (1.0 / state.mass)[:, None]
        sigma = torch.sqrt(2.0 * kB * T * (rmass * mu) / half)

        acc = f_p * rmass - mu * dLdt * S + sigma * g1
        dSdt = dSdt + half * (acc - (mu * L + 2.0 * dLdt) * dSdt) / L
        dSdt = dSdt * mask

        P = axis_pressure(ss.energy.virial, ss.energy.tion, V)
        dLdt = dLdt + half * V / (Wt * L) * (P - Peq)

        S = S + dt * dSdt
        L = L + dt * dLdt
        if h_frac is None:
            box = dataclasses.replace(box, h=torch.diag(L))
            r = S * L
        else:
            box = dataclasses.replace(box, h=hf * L[None, :])
            r = (S * L) @ hf.T
        V = box.volume
        if wrap_positions:
            r = box.back_in_box(r)
            S = (r if h_frac is None else r @ hf_inv.T) / L
        state = state.replace(r=r)

        f, e_pot, virial, pe = force_fn(state, box, handle)
        state = state.replace(f=f, pe=pe)

        # the back piston kick needs the kinetic tensor at the half step:
        # the current canonical velocities mapped to native space
        v_half = (L * dSdt + S * dLdt) * mask
        if h_frac is not None:
            v_half = v_half @ hf.T        # native frame (virial is native)
        _, tion_h = kinetic_terms(v_half, state.mass, state.fmask)
        P2 = axis_pressure(virial, tion_h, V)
        dLdt = dLdt + half * V / (Wt * L) * (P2 - Peq)

        f_p2 = f if h_frac is None else f @ hf_inv.T
        acc2 = f_p2 * rmass - mu * dLdt * S + sigma * g2
        dSdt = ((dSdt + half * acc2 / L)
                / (1.0 + half * (mu * L + 2.0 * dLdt) / L))
        dSdt = dSdt * mask

        v = (L * dSdt + S * dLdt) * mask
        if h_frac is not None:
            v = v @ hf.T
        state = state.replace(v=v)
        fmask = state.fmask
        rk, tion = kinetic_terms(v, state.mass, fmask)
        energy = EnergyInfo(eion=e_pot, rk=rk, virial=virial, tion=tion,
                            number=fmask.sum())
        return ss.replace(state=state, box=box, energy=energy,
                          loop=ss.loop + 1, time=ss.time + dt, bdot=dLdt)

    return step
