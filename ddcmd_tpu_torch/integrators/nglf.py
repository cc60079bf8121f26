"""NGLF integrator family: leapfrog with GROUP half-kicks.

Counterpart of ddcmd_tpu/integrators/nglf.py (reference nglf, ddcMD
src/nglf.c:67-112; NGLFCONSTRAINT, src/nglfconstraint.c); the geometry
is the box's (lengths, or a triclinic h):

  0. NGLFCONSTRAINT with beta > 0: Berendsen barostat
     (changeVolume, nglfconstraint.c:64-85,510-575) -- from the molecular
     pressure tensor, lambda = cbrt(1 + (P - P0) beta dt / tau),
     semi-anisotropic (Pxx, Pyy averaged; Pzz separate) or isotropic;
     h <- diag(lambda) h, positions rescaled
  1. GROUP velocityUpdate(FRONT, 0.5 dt)     [half kick]
     (+ the BERENDSEN rescale and the SHEAR / DOUBLE_MIRROR / UNIONGROUP
     hooks) + constraint projection (front mode, live box)
  2. r += dt v                                [drift]
     + prescribed box(t): h' = (E * h_ref) @ M, positions mapped by
       A = h' h^-1 (scalePositionsByBoxChange, nglf.c:89)
     + post-drift hook (REFLECT walls, reflect.c:41)
  3. forces
  4. GROUP velocityUpdate(BACK, 0.5 dt)      [half kick]
     + RATTLE projection (back mode, live box)
  5. kinetic terms

The cell engines do not wrap positions after the drift: their static
image shifts need positions consistent with the rebuild-time binning, so
the run loop wraps at each rebuild instead, and the barostat's affine
rescale keeps them consistent (cell centres scale with the box).  The
(N,K)-list engine wraps after each drift (wrap_positions, backInBox,
nglf.c:90), as the JAX step does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from ..core.box import inv3x3
from ..core.energy import EnergyInfo, kinetic_terms
from ..core.groups import velocity_update
from ..objects import units as U


@dataclass
class StepState:
    """Everything that evolves across steps.  loop and time live on the
    host: eager PyTorch knows them without reading the device."""

    state: object            # core.state.State
    box: object              # core.box.Box
    energy: EnergyInfo
    loop: int
    time: float              # internal ps
    # NPTGLF's barostat friction (restart-persisted, integrator.c:173-175)
    # and NGLFNK's box-length velocities dL/dt (box_get_dhdt diagonal,
    # nglfNK.c:53), device tensors; unused by the other integrators
    zeta: torch.Tensor | None = None
    bdot: torch.Tensor | None = None

    def replace(self, **kw) -> "StepState":
        return dataclasses.replace(self, **kw)


def barostat_lambda(vir_diag, volume, barostat: dict, dt: float):
    """Berendsen per-axis scale lam = cbrt(1 + (P - P0) beta dt / tau)
    (changeVolume, nglfconstraint.c:64-85) from the diagonal of the
    (molecular) virial and the volume: the pressure tensor's diagonal is
    (vir_aa + N_mol kB T) / V at the target T.  Isotropic, or
    semi-anisotropic (Pxx and Pyy averaged, Pzz separate).  The one
    formula of the single-device step (barostat_scale) and the mesh step
    (parallel/brickstep_cells)."""
    p = ((vir_diag + barostat["n_molecules"] * barostat["T"] * U.kB)
         / volume - barostat["P0"])
    btt = barostat["beta"] * dt / barostat["tau"]
    if barostat["isotropic"]:
        return torch.pow(1.0 + p.sum() / 3.0 * btt, 1.0 / 3.0).expand(3)
    pxx = 0.5 * (p[0] + p[1])
    return torch.pow(1.0 + torch.stack([pxx, pxx, p[2]]) * btt, 1.0 / 3.0)


def barostat_scale(state, box, virial, barostat: dict, dt: float,
                   molecular_virial_fn: Callable | None = None):
    """Berendsen box rescale at the start of a step (changeVolume,
    nglfconstraint.c:518-527): returns (state, box) with h <- diag(lam) h
    and positions rescaled.  `virial` is the last force evaluation's;
    the pressure tensor uses the molecular virial and the target T."""
    if molecular_virial_fn is not None:
        virial = molecular_virial_fn(state, box, virial)
    lam = barostat_lambda(torch.diagonal(virial), box.volume, barostat, dt)
    return state.replace(r=state.r * lam), box.scale(lam)


def device_hooks(hook_groups, dtype, device):
    """The hook groups with each DOUBLE_MIRROR's points and normals as
    tensors on the device, made once: hooks_at then moves the planes
    without a host copy a kick."""
    hooks = []
    for p in hook_groups:
        if p.get("style") == "mirror":
            p = dict(p, **{k: torch.as_tensor(p[k], dtype=dtype,
                                              device=device)
                           for k in ("point1", "point2", "normal1",
                                     "normal2")})
        hooks.append(p)
    return tuple(hooks)


def hooks_at(time: float, box, hook_groups):
    """The hook groups (device_hooks's, on the box's device) with each
    DOUBLE_MIRROR plane point advanced to `time` (doubleMirror_Update,
    src/doubleMirror.c:51-65: point += v*n*dt each half step, wrapped
    back into the box); the other hooks as they are."""
    hooks = []
    for p in hook_groups:
        if p.get("style") == "mirror":
            q = dict(p)
            for key, vkey, nkey in (("point1", "v1", "normal1"),
                                    ("point2", "v2", "normal2")):
                pt = p[key] + p[vkey] * p[nkey] * time
                q[key] = box.back_in_box(pt[None, :])[0]
            hooks.append(q)
        else:
            hooks.append(p)
    return tuple(hooks)


def kick_context(r, box, time, shear_groups, draws):
    """velocity_update's shear_ctx at positions r and the box (shear_groups:
    device_hooks's): None without hook groups."""
    if not shear_groups:
        return None
    return (r, box.lengths, hooks_at(time, box, shear_groups), draws)


def box_time_map(h, box_lam):
    """(h', A) of a prescribed box(t) step from the box h: box_lam = (E, M,
    h_ref) gives h' = (E * h_ref) @ M (h_ref None: h itself) and the
    affine position map A = h' h^-1 (scalePositionsByBoxChange)."""
    E, M, h_ref = box_lam
    h_new = (E * (h if h_ref is None else h_ref)) @ M
    return h_new, h_new @ inv3x3(h)


def box_time_drift(box, r, box_lam):
    """Prescribed box(t) at the drift (boxPrescriptiveTime.c:96-145):
    box_lam = (E, M, h_ref) gives h' = (E * h_ref) @ M -- E carries
    STRAIN's elementwise exp-integral factors (VOLUME's diagonal scale),
    M DEFORMATION_RATE's expm(D dt) -- and positions map affinely by
    A = h' h^-1 (scalePositionsByBoxChange).  The run loop passes h_ref
    = the dispatch's first box with E, M accumulated over the dispatch
    in f64, so an f32 box tracks exp(int u dt) without compounding a
    rounding of every step; h_ref None takes the live box h, the JAX
    package's per-step update (nglf.py:158), which composes with a
    barostat that moved the box earlier in the step."""
    h_new, A = box_time_map(box.h, box_lam)
    return dataclasses.replace(box, h=h_new), r @ A.T


def make_nglf_step(force_fn: Callable, dt: float, *, barostat=None,
                   constraint_fn: Callable | None = None,
                   molecular_virial_fn: Callable | None = None,
                   post_drift_fn: Callable | None = None,
                   wrap_positions: bool = False,
                   has_berendsen: bool = False,
                   shear_groups: tuple = ()):
    """step(ss, handle, coeffs, noise_front, noise_back, box_lam=None,
    draws=None) -> StepState.

    force_fn(state, box, handle) -> (f (N,3), e_pot, virial (3,3), pe (N,));
    noise_front/noise_back: (n_pad, 3) standard-normal draws for the two
    half-kicks (core.groups.kick_noise).
    barostat: None or dict(P0, beta, tau, T, isotropic, n_molecules).
    constraint_fn(state, dt, mode, box_lengths) -> state with projected
    velocities (box_lengths the box's geometry: a triclinic box hands its
    h); molecular_virial_fn(state, box, virial) -> the virial corrected
    for intra-molecular force moments; post_drift_fn(state, box) -> state
    after the drift (REFLECT walls); wrap_positions: wrap into the box
    after the drift, before the post-drift hook (the list engine).
    has_berendsen: some group is BERENDSEN; shear_groups: the hook groups
    (GroupTable.shear_groups).  box_lam: None, or the prescribed box(t)
    update (box_time_drift); draws: None, or the UNIONGROUP member draws
    (2, members, n_pad, 3), front and back."""

    hooks = {}

    def step(ss: StepState, handle, coeffs, noise_front, noise_back,
             box_lam=None, draws=None):
        state, box = ss.state, ss.box
        half = 0.5 * dt
        key = (state.r.dtype, state.r.device)
        if key not in hooks:
            hooks[key] = device_hooks(shear_groups, *key)
        shear_groups_dev = hooks[key]
        if barostat is not None:
            state, box = barostat_scale(state, box, ss.energy.virial,
                                        barostat, dt, molecular_virial_fn)

        mask = state.mask
        v = velocity_update(
            "front", state.v, state.f, state.mass, state.group, coeffs,
            half, noise_front, mask, has_berendsen,
            kick_context(state.r, box, ss.time, shear_groups_dev,
                         None if draws is None else draws[0]))
        if constraint_fn is not None:
            # live box geometry: the barostat above may have rescaled it
            v = constraint_fn(state.replace(v=v), dt, "front",
                              box_lengths=box.geom).v
        r = state.r + dt * v
        if box_lam is not None:
            box, r = box_time_drift(box, r, box_lam)
        if wrap_positions:
            r = box.back_in_box(r)
        state = state.replace(v=v, r=r)
        if post_drift_fn is not None:
            state = post_drift_fn(state, box)

        f, e_pot, virial, pe = force_fn(state, box, handle)
        state = state.replace(f=f, pe=pe)

        v = velocity_update(
            "back", state.v, f, state.mass, state.group, coeffs, half,
            noise_back, mask, False,
            kick_context(state.r, box, ss.time + dt, shear_groups_dev,
                         None if draws is None else draws[1]))
        if constraint_fn is not None:
            v = constraint_fn(state.replace(v=v), dt, "back",
                              box_lengths=box.geom).v
        state = state.replace(v=v)

        fmask = state.fmask
        rk, tion = kinetic_terms(v, state.mass, fmask)
        energy = EnergyInfo(eion=e_pot, rk=rk, virial=virial, tion=tion,
                            number=fmask.sum())
        return ss.replace(state=state, box=box, energy=energy,
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
