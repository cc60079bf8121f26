"""GROUP machinery: per-particle half-kicks as one affine form.

Counterpart of ddcmd_tpu/core/groups.py, ported for the two group types
of the main path:

    v' = vcm + a*(v - vcm) + c*F/m + d*g,          (FRONT)
    v' = vcm + a*((v - vcm) + c*F/m + d*g),        (BACK)

    LANGEVIN:  a = exp(-dt/tau), c = dt, d = sqrt(2 dt kB Teq / (m tau))
    FREE:      a = 1, c = dt, d = 0          (plain leapfrog kick)

(langevin_velocityUpdate, ddcMD src/langevin.c:99-128).  The other GROUP
types raise NotImplementedError: they are ROADMAP queue 1, item 22.

Noise: `velocity_update` takes the standard-normal draw `noise` as an
argument.  The integrator draws it from a `torch.Generator` on the device
seeded from (deck seed, global step, callsite), so a restart or a redone
dispatch replays the same noise; it never matches jax.random bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..objects import ObjectDB
from ..objects import units as U


@dataclass
class Group:
    name: str
    index: int
    type: str
    Teq: Callable[[float], float] | None = None  # K, function of time
    tau: float = math.inf                        # ps
    vcm: tuple = (0.0, 0.0, 0.0)


def group_from_deck(db: ObjectDB, name: str, index: int) -> Group:
    obj = db.get(name, "GROUP")
    gtype = obj.get_str("type", "FREE").upper()
    if gtype in ("FREE", "NONE"):
        return Group(name=name, index=index, type="FREE")
    if gtype != "LANGEVIN":
        raise NotImplementedError(
            f"GROUP {name}: type {gtype} is not ported yet (ROADMAP queue "
            "1, item 22: the remaining GROUP types of core/groups.py)")
    if obj.get_str("Teq_dynamics", "EXPLICIT_TIME").upper() != \
            "EXPLICIT_TIME":
        raise NotImplementedError(
            f"GROUP {name}: Teq_dynamics other than EXPLICIT_TIME is not "
            "ported yet (ROADMAP queue 1, item 22)")
    from ..objects.eq import eq_parse

    # Teq may be time-dependent: "RAMP(300,500,0,100ps)" etc
    # (langevin normalParse -> eq_parse, langevin.c:80-86)
    return Group(name=name, index=index, type="LANGEVIN",
                 Teq=eq_parse(obj.get_literal("Teq", "0.0"), "T", "t"),
                 tau=obj.get_with_units("tau", "1.0", "t"))


@dataclass
class GroupTable:
    """Per-group coefficient arrays, gathered per particle."""

    groups: list[Group]

    @classmethod
    def build(cls, groups: list[Group]) -> "GroupTable":
        return cls(groups=list(groups))

    @property
    def time_dependent(self) -> bool:
        """True when some group's Teq schedule varies in time, so the
        coefficients need refreshing as the run advances."""
        from ..objects.eq import EqTarget

        return any(isinstance(g.Teq, EqTarget) and g.Teq.kind != "CONSTANT"
                   for g in self.groups)

    def coefficients(self, time: float, dt: float, dtype=torch.float32,
                     device="cpu"):
        """Per-group (a, c_on, kBTeq_over_tau2, vcm) for the affine kick,
        shapes (G,), (G,), (G,), (G,3); dt is the half step.
        d per particle = sqrt(kBTeq_over_tau2[g] * dt / m), with
        kBTeq_over_tau2 = 2*kB*Teq/tau for LANGEVIN and 0 for FREE."""
        G = len(self.groups)
        a = np.ones(G)
        c_on = np.ones(G)
        noise = np.zeros(G)
        vcm = np.array([g.vcm for g in self.groups], dtype=np.float64)
        for i, g in enumerate(self.groups):
            if g.type == "LANGEVIN":
                a[i] = math.exp(-dt / g.tau)
                noise[i] = 2.0 * U.kB * max(float(g.Teq(time)), 0.0) / g.tau

        def dev(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return dev(a), dev(c_on), dev(noise), dev(vcm.reshape(G, 3))


def velocity_update(mode: str, state_v, state_f, state_mass, group_ids,
                    coeffs, dt, noise, n_valid_mask):
    """One fused half-kick for all particles (both reference modes).

    mode: 'front' | 'back' (langevin_velocityUpdate, langevin.c:99-128).
    noise: (n_pad, 3) standard-normal draw (see the module docstring).
    """
    a_g, c_on_g, noise_g, vcm_g = coeffs
    a = a_g[group_ids][:, None]
    c = (c_on_g[group_ids] * dt / state_mass)[:, None]
    vcm = vcm_g[group_ids]
    d = torch.sqrt(noise_g[group_ids] * dt / state_mass)[:, None]
    if mode == "front":
        v = vcm + a * (state_v - vcm) + c * state_f + d * noise
    elif mode == "back":
        v = vcm + a * ((state_v - vcm) + c * state_f + d * noise)
    else:
        raise ValueError(mode)
    return torch.where(n_valid_mask[:, None], v, torch.zeros_like(v))


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def kick_noise(generator: torch.Generator, seed: int, step: int,
               callsite: int, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard-normal thermostat noise for global step `step` at
    `callsite`, drawn on the generator's device.  The generator is
    re-seeded from (seed, step, callsite), so a redone dispatch or a
    restart at the same step replays the same numbers."""
    key = _splitmix64(_splitmix64(_splitmix64(seed) ^ step) ^ callsite)
    generator.manual_seed(key >> 1)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)
