"""GROUP machinery: per-particle half-kicks as one affine form.

Counterpart of ddcmd_tpu/core/groups.py.  Every particle belongs to one
GROUP whose velocityUpdate(FRONT|BACK) performs the half-kick (ddcMD
src/group.h:9-80).  The working family of updates is one affine form

    v' = vcm + a*(v - vcm) + c*F/m + d*g,          (FRONT)
    v' = vcm + a*((v - vcm) + c*F/m + d*g),        (BACK)

with per-GROUP coefficients (langevin_velocityUpdate, src/langevin.c:
99-128):

    LANGEVIN:      a = exp(-dt/tau), c = dt, d = sqrt(2 dt kB Teq / (m tau))
    FREE:          a = 1, c = dt, d = 0          (plain leapfrog kick)
    FROZEN:        a = 0, c = 0, d = 0           (v stays 0)
    FIXEDVELOCITY: a = 0, c = 0, vcm = velocity  (v held at the velocity)
    PISTON:        a = 0, c = 0, vcm = (0, 0, vz(t + dt))
    EXTFORCE:      FREE + constant extra force (a force term, run/forces)
    QUENCH:        FREE, after zeroing the v components against F
    BERENDSEN:     FREE after v *= sqrt(1 + dt/tau (Teq/T - 1)), T the
                   group's temperature (FRONT only)

SHEAR / SHWALL (two-slice shear driver), DOUBLE_MIRROR (two moving
reflective planes) and UNIONGROUP (a composition of affine member
groups) are plain kicks plus a hook applied on their particles.
IONIZATION is the reference's no-op stub and runs as FREE, as does an
unknown type (with the JAX package's warning).  LANGEVIN with
Teq_dynamics=GLOBAL_ENERGY takes its live target from the run loop
(GroupTable.coefficients' teq_override).

Noise: `velocity_update` takes the standard-normal draw `noise` as an
argument, and each UNIONGROUP member's draw in `shear_ctx`.  The
integrator draws them from a `torch.Generator` on the device seeded from
(deck seed, global step, callsite) -- the member draws at callsites of
their own, union_callsite -- so a restart or a redone dispatch replays
the same noise; it never matches jax.random bit for bit.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
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
    extforce: tuple = (0.0, 0.0, 0.0)            # kJ/mol/nm, EXTFORCE only
    parms: dict = field(default_factory=dict)


_AFFINE_TYPES = {"LANGEVIN", "FREE", "FROZEN", "FIXEDVELOCITY", "EXTFORCE",
                 "QUENCH"}


def group_from_deck(db: ObjectDB, name: str, index: int) -> Group:
    from ..objects.eq import eq_parse

    obj = db.get(name, "GROUP")
    gtype = obj.get_str("type", "FREE").upper()
    g = Group(name=name, index=index, type=gtype)
    if gtype == "LANGEVIN":
        dyn = obj.get_str("Teq_dynamics", "EXPLICIT_TIME").upper()
        if dyn == "GLOBAL_ENERGY":
            # energy-feedback target (langevin_getTemperature,
            # src/langevin.c:31-51): a bath of heat capacity Cp per atom;
            # the run loop pins the total at the first energy and hands
            # Teq = (total - E)/(Cp N) to coefficients as teq_override
            Teq0 = obj.get_with_units("Teq", "0.0", "T")
            g.Teq = lambda t, _T=Teq0: _T
            g.parms["teq_dynamics"] = "GLOBAL_ENERGY"
            g.parms["Cp"] = obj.get_with_units("Cp", "1.0", "m*l^2/t^2/T")
        else:
            # Teq may be time-dependent: "RAMP(300,500,0,100ps)" etc
            # (langevin normalParse -> eq_parse, langevin.c:80-86)
            g.Teq = eq_parse(obj.get_literal("Teq", "0.0"), "T", "t")
        g.tau = obj.get_with_units("tau", "1.0", "t")
    elif gtype == "EXTFORCE":
        g.extforce = tuple(obj.get_with_unitsv("force", "0 0 0", "m*l/t^2"))
    elif gtype == "FIXEDVELOCITY":
        g.vcm = tuple(obj.get_with_unitsv("velocity", "0 0 0", "velocity"))
    elif gtype == "PISTON":
        # v = (0, 0, vz(t)) (piston.c:29-37); time-dependent vcm
        g.parms["vzeq"] = eq_parse(obj.get_literal("vz", "0.0"), "l/t", "t")
    elif gtype == "BERENDSEN":
        g.Teq = eq_parse(obj.get_literal("Teq", "0.0"), "T", "t")
        g.tau = obj.get_with_units("tau", "1.0", "t")
    elif gtype in ("SHEAR", "SHWALL"):
        # two z-slice shear driver/thermostat (shear_parms, src/shear.c:
        # 284-314); SHWALL anchors the slices at the box z-faces instead
        # of deck centres (shwall_parms, src/shwall.c:291-314)
        g.parms = dict(
            style=gtype.lower(),
            tau=obj.get_with_units("tau", "1.0", "t"),
            top_width=obj.get_with_units("top_width", "-1", "l"),
            bot_width=obj.get_with_units("bottom_width", "-1", "l"),
            top_velocity=obj.get_with_units("top_velocity", "-1", "l/t"),
            bot_velocity=obj.get_with_units("bottom_velocity", "-1", "l/t"),
            top_temp=obj.get_with_units("top_temp", "-1", "T"),
            bot_temp=obj.get_with_units("bottom_temp", "-1", "T"))
        if gtype == "SHEAR":
            g.parms["top_center"] = obj.get_with_units("top_center", "-1",
                                                       "l")
            g.parms["bot_center"] = obj.get_with_units("bottom_center", "-1",
                                                       "l")
    elif gtype == "DOUBLE_MIRROR":
        # two moving reflective planes (doubleMirror_parms,
        # src/doubleMirror.c:238-280)
        n1 = np.asarray(obj.get_floatv("normal1") if obj.has("normal1")
                        else [0.0, 0.0, 1.0])
        n2 = np.asarray(obj.get_floatv("normal2") if obj.has("normal2")
                        else [0.0, 0.0, -1.0])
        g.parms = dict(
            point1=tuple(obj.get_with_unitsv("point1", "0 0 -1", "l")),
            point2=tuple(obj.get_with_unitsv("point2", "0 0 1", "l")),
            normal1=tuple(n1 / np.linalg.norm(n1)),
            normal2=tuple(n2 / np.linalg.norm(n2)),
            v1=obj.get_with_units("v1", "0.0", "l/t"),
            v2=obj.get_with_units("v2", "0.0", "l/t"),
            output_rate=obj.get_int("outputRate", 0))
    elif gtype == "UNIONGROUP":
        # plain kick + the sum of each member's deviation from it
        # (unionGroup_velocityUpdate, src/unionGroup.c:134-182); members
        # are affine-family groups
        members = []
        for mname in obj.get_strv("groups"):
            m = group_from_deck(db, mname, -1)
            if m.type not in _AFFINE_TYPES and m.type != "PISTON":
                raise ValueError(
                    f"UNIONGROUP {name}: member {mname} of type {m.type} "
                    f"is not an affine-family group")
            members.append(m)
        g.parms["members"] = members
    elif gtype == "IONIZATION":
        # the reference's ionization group is a no-op stub
        # (group.c:31: `void ionization_parms(GROUP *gp){}`); FREE matches
        g.type = "FREE"
    elif gtype not in ("FREE", "FROZEN", "QUENCH", "NONE"):
        # unknown types load as FREE with a warning, as in the JAX package
        warnings.warn(f"GROUP type {gtype} not yet implemented; treating "
                      "as FREE")
        g.type = "FREE"
    return g


def union_callsite(gidx: int, j: int) -> int:
    """kick_noise callsite of member j of the UNIONGROUP of index gidx
    (the JAX package draws it from fold_in(key, 7919 + 31 gidx + j))."""
    return 7919 + 31 * gidx + j


@dataclass
class GroupTable:
    """Per-group coefficient arrays, gathered per particle."""

    groups: list[Group]
    kind: np.ndarray        # int32 code
    vcm: np.ndarray         # (G,3)

    KIND = {"FREE": 0, "LANGEVIN": 1, "FROZEN": 2, "FIXEDVELOCITY": 3,
            "EXTFORCE": 0, "QUENCH": 4, "BERENDSEN": 5, "NONE": 0,
            "PISTON": 3, "SHEAR": 0, "SHWALL": 0, "DOUBLE_MIRROR": 0,
            "UNIONGROUP": 0, "IONIZATION": 0}  # 0 + hook where needed

    @classmethod
    def build(cls, groups: list[Group]) -> "GroupTable":
        # UNIONGROUP members become hidden trailing groups so their affine
        # coefficients refresh with everyone else's (Teq schedules too);
        # no particle of a deck is ever assigned to them
        groups = list(groups)
        for g in list(groups):
            if g.type == "UNIONGROUP":
                idxs = []
                for m in g.parms["members"]:
                    m.index = len(groups)
                    idxs.append(m.index)
                    groups.append(m)
                g.parms["member_idx"] = tuple(idxs)
        kind = np.array([cls.KIND.get(g.type, 0) for g in groups],
                        dtype=np.int32)
        vcm = np.array([g.vcm for g in groups], dtype=np.float64)
        return cls(groups=groups, kind=kind, vcm=vcm)

    @property
    def shear_groups(self):
        """Static hook-group parameter dicts for velocity_update:
        SHEAR/SHWALL slices, DOUBLE_MIRROR planes, UNIONGROUP members."""
        hooks = []
        for g in self.groups:
            if g.type in ("SHEAR", "SHWALL"):
                hooks.append(dict(gidx=g.index, **g.parms))
            elif g.type == "DOUBLE_MIRROR":
                p = dict(g.parms)
                p.update(style="mirror", gidx=g.index)
                hooks.append(p)
            elif g.type == "UNIONGROUP":
                hooks.append(dict(style="union", gidx=g.index,
                                  members=g.parms["member_idx"]))
        return tuple(hooks)

    @property
    def union_draws(self) -> tuple:
        """(gidx, j) of every UNIONGROUP member draw, in the order
        velocity_update consumes them from shear_ctx."""
        return tuple((p["gidx"], j) for p in self.shear_groups
                     if p.get("style") == "union"
                     for j in range(len(p["members"])))

    @property
    def has_berendsen(self) -> bool:
        return any(g.type == "BERENDSEN" for g in self.groups)

    @property
    def time_dependent(self) -> bool:
        """True when some group's Teq schedule or PISTON vz(t) varies in
        time, so the coefficients need refreshing as the run advances
        (GLOBAL_ENERGY targets are the run loop's to refresh)."""
        from ..objects.eq import EqTarget

        def varies(eq):
            return isinstance(eq, EqTarget) and eq.kind != "CONSTANT"

        return any(varies(g.Teq) or varies(g.parms.get("vzeq"))
                   for g in self.groups)

    def coefficients(self, time: float, dt: float, dtype=torch.float32,
                     device="cpu", teq_override=None):
        """Per-group (a, c_on, kBTeq_over_tau2, vcm, kind, ber) for the
        affine kick, shapes (G,), (G,), (G,), (G,3), (G,), (G,2); dt is
        the half step.  d per particle = sqrt(kBTeq_over_tau2[g] * dt /
        m), with kBTeq_over_tau2 = 2*kB*Teq/tau for LANGEVIN and 0 else;
        ber = [Teq, 2 dt / tau] of each BERENDSEN group (berendsen.c:
        40-52; 2*dt is the full step).  teq_override: {group index: Teq}
        live targets (GLOBAL_ENERGY thermostats) that take precedence over
        the group's Teq(t)."""
        G = len(self.groups)
        a = np.ones(G)
        c_on = np.ones(G)
        noise = np.zeros(G)
        vcm = np.array(self.vcm, dtype=np.float64).reshape(G, 3)
        ber = np.zeros((G, 2))
        for i, g in enumerate(self.groups):
            if g.type == "LANGEVIN":
                a[i] = math.exp(-dt / g.tau)
                Teq_i = (teq_override[i] if teq_override and i in teq_override
                         else float(g.Teq(time)))
                noise[i] = 2.0 * U.kB * max(Teq_i, 0.0) / g.tau
            elif g.type in ("FROZEN", "FIXEDVELOCITY"):
                # v = 0, or v = velocity exactly (fixedVelocity.c)
                a[i] = 0.0
                c_on[i] = 0.0
            elif g.type == "PISTON":
                # v = (0, 0, vz(t + dt)) (piston.c:29-37)
                a[i] = 0.0
                c_on[i] = 0.0
                vcm[i] = (0.0, 0.0, float(g.parms["vzeq"](time + 2 * dt)))
            elif g.type == "BERENDSEN":
                ber[i, 0] = float(g.Teq(time))
                ber[i, 1] = 2.0 * dt / g.tau if g.tau > 0 else -1.0

        def dev(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return (dev(a), dev(c_on), dev(noise), dev(vcm), torch.as_tensor(
            self.kind, dtype=torch.int64, device=device), dev(ber))


def _slice_sums(v, f, mass, w_sl):
    """(11,) sums over a shear slice's rows (weights w_sl): count, mass,
    momentum (3), force (3), sum |f|^2 / m, sum v . f and the kinetic
    energy -- what _shear_slice reads, summable over the mesh's ranks."""
    def one(x):
        return x.reshape(1)

    return torch.cat([
        one(w_sl.sum()), one((mass * w_sl).sum()),
        (mass[:, None] * v * w_sl[:, None]).sum(dim=0),
        (f * w_sl[:, None]).sum(dim=0),
        one(((f * f).sum(dim=1) / mass * w_sl).sum()),
        one(((v * f).sum(dim=1) * w_sl).sum()),
        one((0.5 * mass * (v * v).sum(dim=1) * w_sl).sum())])


def _shear_slice(p, tag, sums, dt):
    """Slice statistics -> (vcm, chi, delta, v_b, chi_b, delta_b) from
    the slice's _slice_sums.

    shear_Update (src/shear.c:108-215): mass-weighted CM velocity, slice
    temperature T = 2 rk / (3 (n-1) kB), velocity drag delta = dt/tau
    (set_v - vcm.y), thermostat chi = sqrt(1 + dt/tau (set_T/T - 1));
    the BACK forms are the implicit (backward-Euler) variants solved by 5
    fixed-point iterations (shear.c:177-214).
    """
    sv = p[f"{tag}_velocity"]
    sT = p[f"{tag}_temp"]
    dtau = dt / p["tau"]
    n = sums[0]
    M = torch.clamp(sums[1], min=1e-30)
    P, F = sums[2:5], sums[5:8]
    af, vf, rk = sums[8], sums[9], sums[10]
    vcm = P / M
    rk = rk - 0.5 * M * (vcm * vcm).sum()
    ndof = torch.clamp(3.0 * (n - 1.0), min=1.0) * U.kB
    T = torch.clamp(2.0 * rk / ndof, min=1e-12)
    delta = dtau * (sv - vcm[1])
    chi = torch.sqrt(torch.clamp(1.0 + dtau * (sT / T - 1.0), min=0.0))
    v_b = torch.stack([vcm[0] + dt * F[0] / M,
                       (vcm[1] + dt * F[1] / M + dtau * sv) / (1.0 + dtau),
                       vcm[2] + dt * F[2] / M])
    delta_b = dtau * (sv - v_b[1])
    c = T + (2.0 * dt * (vf - torch.dot(vcm, F))
             + dt * dt * (af - torch.dot(F, F) / M)) / ndof
    temp = T
    for _ in range(5):
        chi_b = torch.sqrt(torch.clamp(1.0 + dtau * (sT / temp - 1.0),
                                       min=0.0))
        temp = torch.clamp(c / ((2.0 - chi_b) * (2.0 - chi_b)), min=1e-12)
    return vcm, chi, delta, v_b, chi_b, delta_b


def _apply_shear(mode, p, v, v_pre, z, f, mass, group_ids, n_valid_mask,
                 dt, Lz, group_sum=None):
    """SHEAR group hook, applied after the plain leapfrog kick
    (shear_velocityUpdate, src/shear.c:217-283): v += (chi - 1)(v -
    v_slice), + delta on y.  Slice statistics sum over every local
    particle (shear.c:132, no group filter) with the PRE-kick velocities;
    the kick applies only to the group's own particles.  In the
    statistics top wins ties (else-if, shear.c:137-152); in the kick
    bottom wins (sequential ifs, shear.c:242-254).  group_sum: the
    mesh's all-reduce of both slices' sums (over every rank's rows)."""
    dtype = v.dtype
    if p.get("style", "shear") == "shwall":
        # slices anchored at the z faces, one-sided distances
        # (shwall_Update, shwall.c:138-174)
        edge = 0.5 * Lz
        in_top = ((edge - z) < p["top_width"]) & n_valid_mask
        in_bot = ((z + edge) < p["bot_width"]) & n_valid_mask
    else:
        ztop = z - p["top_center"]
        ztop = ztop - Lz * torch.round(ztop / Lz)
        zbot = z - p["bot_center"]
        zbot = zbot - Lz * torch.round(zbot / Lz)
        in_top = (torch.abs(ztop) < 0.5 * p["top_width"]) & n_valid_mask
        in_bot = (torch.abs(zbot) < 0.5 * p["bot_width"]) & n_valid_mask
    sums = torch.stack([
        _slice_sums(v_pre, f, mass, in_top.to(dtype)),
        _slice_sums(v_pre, f, mass, (in_bot & ~in_top).to(dtype))])
    if group_sum is not None:
        sums = group_sum(sums)
    top = _shear_slice(p, "top", sums[0], dt)
    bot = _shear_slice(p, "bot", sums[1], dt)
    k = 0 if mode == "front" else 3
    vcm_t, chi_t, del_t = top[k:k + 3]
    vcm_b, chi_b, del_b = bot[k:k + 3]
    one = torch.ones((), dtype=dtype, device=v.device)
    zero = torch.zeros((), dtype=dtype, device=v.device)
    # per-particle slice coefficients; bottom overrides top, outside =
    # identity
    chi = torch.where(in_bot, chi_b, torch.where(in_top, chi_t, one))
    delta = torch.where(in_bot, del_b, torch.where(in_top, del_t, zero))
    vsl = torch.where(in_bot[:, None], vcm_b[None, :],
                      torch.where(in_top[:, None], vcm_t[None, :], zero))
    # SHEAR applies (chi-1) to the post-kick velocity (sequential updates,
    # shear.c:255-260); SHWALL to the pre-kick velocity (single
    # expression, shwall.c:268-270)
    vbase = v_pre if p.get("style", "shear") == "shwall" else v
    dv = (chi - 1.0)[:, None] * (vbase - vsl)
    dv = dv + torch.stack([zero.expand_as(delta), delta,
                           zero.expand_as(delta)], dim=1)
    member = (group_ids == p["gidx"]) & n_valid_mask
    return torch.where(member[:, None], v + dv, v)


def _apply_mirror(p, v, r, box_lengths, group_ids, n_valid_mask):
    """DOUBLE_MIRROR: elastic bounce off the nearer of two moving planes
    (doubleMirror_velocityUpdate, src/doubleMirror.c:98-161), after the
    plain kick in both modes; p['point1'/'point2'] are the current
    (time-advanced, wrapped) plane points the integrator supplies
    (doubleMirror_Update, doubleMirror.c:51-65), tensors on v's device
    (integrators/nglf.device_hooks)."""
    n1, n2 = p["normal1"], p["normal2"]
    r1 = r - p["point1"]
    r1 = r1 - box_lengths * torch.round(r1 / box_lengths)
    r2 = r - p["point2"]
    r2 = r2 - box_lengths * torch.round(r2 / box_lengths)
    d1 = r1 @ n1
    d2 = r2 @ n2
    use2 = torch.abs(d1) > torch.abs(d2)
    nrm = torch.where(use2[:, None], n2[None, :], n1[None, :])
    dot = torch.where(use2, d2, d1)
    vm = torch.full_like(dot, p["v1"]).masked_fill_(use2, p["v2"])
    vpar = (v * nrm).sum(dim=1)
    member = (group_ids == p["gidx"]) & n_valid_mask
    bounce = member & (dot <= 0) & ((vpar - vm) <= 0)
    return torch.where(bounce[:, None],
                       v + (2.0 * (vm - vpar))[:, None] * nrm, v)


def _apply_union(mode, p, v, v_pre, f, mass, group_ids, n_valid_mask,
                 coeffs, dt, draws):
    """UNIONGROUP: plain kick + the sum of member-group deviations from it
    (unionGroup_velocityUpdate, src/unionGroup.c:134-182; the clearly
    intended semantics -- the reference body double-kicks vy and never
    kicks vz, unionGroup.c:148-150, which the JAX package does not copy
    either).  draws: one (n_pad, 3) standard-normal draw per member."""
    a_g, c_on_g, noise_g, vcm_g = coeffs[:4]
    plain = v_pre + (dt / mass)[:, None] * f
    acc = plain
    for m, gn in zip(p["members"], draws):
        c = (c_on_g[m] * dt / mass)[:, None]
        d = torch.sqrt(noise_g[m] * dt / mass)[:, None]
        vcm = vcm_g[m]
        if mode == "front":
            vm = vcm + a_g[m] * (v_pre - vcm) + c * f + d * gn
        else:
            vm = vcm + a_g[m] * ((v_pre - vcm) + c * f + d * gn)
        acc = acc + (vm - plain)
    member = (group_ids == p["gidx"]) & n_valid_mask
    return torch.where(member[:, None], acc, v)


def velocity_update(mode: str, state_v, state_f, state_mass, group_ids,
                    coeffs, dt, noise, n_valid_mask,
                    has_berendsen: bool = False, shear_ctx=None,
                    group_sum: Callable | None = None):
    """One fused half-kick for all particles (both reference modes).

    mode: 'front' | 'back' (langevin_velocityUpdate, langevin.c:99-128).
    noise: (n_pad, 3) standard-normal draw (see the module docstring).
    has_berendsen: apply the BERENDSEN groups' FRONT rescale (kind 5).
    shear_ctx: None, or (r, box lengths, hook groups with the mirror
    points at this time (integrators/nglf.hooks_at), UNIONGROUP member
    draws in GroupTable.union_draws order).  group_sum(x) -> the sum of
    a tensor over every rank (the mesh's all-reduce: the BERENDSEN
    temperature and the SHEAR / SHWALL slice statistics are the
    group's and the slice's, not a brick's).
    """
    a_g, c_on_g, noise_g, vcm_g, kind_g, ber_g = coeffs
    a = a_g[group_ids][:, None]
    c = (c_on_g[group_ids] * dt / state_mass)[:, None]
    vcm = vcm_g[group_ids]
    d = torch.sqrt(noise_g[group_ids] * dt / state_mass)[:, None]
    # QUENCH (kind 4): zero components moving against the force before
    # the kick (quench.c:17-26)
    is_quench = (kind_g[group_ids] == 4)
    state_v = torch.where(is_quench[:, None] & (state_v * state_f < 0),
                          torch.zeros_like(state_v), state_v)
    # BERENDSEN (kind 5): FRONT-only group-temperature rescale
    # v *= sqrt(1 + (2 dt/tau)(Teq/Tave - 1)) (berendsen.c:40-64)
    if has_berendsen and mode == "front":
        G = kind_g.shape[0]
        fm = n_valid_mask.to(state_v.dtype)
        ke_i = 0.5 * state_mass * (state_v * state_v).sum(dim=1) * fm
        sums = torch.zeros((2, G), dtype=state_v.dtype,
                           device=state_v.device)
        sums[0].index_add_(0, group_ids, ke_i)
        sums[1].index_add_(0, group_ids, fm)
        if group_sum is not None:
            sums = group_sum(sums)
        Tave = 2.0 * sums[0] / (3.0 * torch.clamp(sums[1], min=1.0) * U.kB)
        ratio = ber_g[:, 0] / torch.clamp(Tave, min=1e-12)
        lam2 = torch.where(ber_g[:, 1] > 0,
                           1.0 + ber_g[:, 1] * (ratio - 1.0), ratio)
        lam = torch.where(kind_g == 5, torch.sqrt(torch.clamp(lam2, min=0.0)),
                          torch.ones_like(lam2))
        state_v = state_v * lam[group_ids][:, None]
    if mode == "front":
        v = vcm + a * (state_v - vcm) + c * state_f + d * noise
    elif mode == "back":
        v = vcm + a * ((state_v - vcm) + c * state_f + d * noise)
    else:
        raise ValueError(mode)
    if shear_ctx is not None:
        r, box_lengths, hook_groups, draws = shear_ctx
        k = 0
        for p in hook_groups:
            style = p.get("style", "shear")
            if style in ("shear", "shwall"):
                v = _apply_shear(mode, p, v, state_v, r[:, 2], state_f,
                                 state_mass, group_ids, n_valid_mask, dt,
                                 box_lengths[2], group_sum)
            elif style == "mirror":
                v = _apply_mirror(p, v, r, box_lengths, group_ids,
                                  n_valid_mask)
            elif style == "union":
                m = len(p["members"])
                v = _apply_union(mode, p, v, state_v, state_f, state_mass,
                                 group_ids, n_valid_mask, coeffs, dt,
                                 draws[k:k + m])
                k += m
    return torch.where(n_valid_mask[:, None], v, torch.zeros_like(v))


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def kick_noise(generator: torch.Generator, seed: int, step: int,
               callsite: int, shape, dtype=torch.float32,
               attempt: int = 0) -> torch.Tensor:
    """Standard-normal thermostat noise for global step `step` at
    `callsite`, drawn on the generator's device.  The generator is
    re-seeded from (seed, step, callsite, attempt), so a redone dispatch
    or a restart at the same step replays the same numbers.  `attempt`
    is 0 on every normal dispatch and on a stale-cadence redo; the NaN
    rollback's retries of one dispatch draw at attempts 1-3, fresh noise
    as the JAX package's split key gives them (ddcmd_tpu/run/simulate.py:
    924)."""
    key = _splitmix64(_splitmix64(_splitmix64(seed) ^ step) ^ callsite)
    if attempt:
        key = _splitmix64(key ^ attempt)
    generator.manual_seed(key >> 1)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)
