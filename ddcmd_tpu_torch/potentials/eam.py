"""EAM (embedded-atom method) potential: deck compilation, the per-pair
forms and the embedding, in torch.

Counterpart of ddcmd_tpu/potentials/eam.py (reference ddcMD src/eam.c,
two-pass structure :95-210) for the analytic forms:

  FS (Finnis-Sinclair, eam_fs.c:197-241):
      phi  = a exp(c/(r - x) - m ln(r/r0)),   pair energy
      rho  = b exp(c/(r - x) - n ln(r/r0)),   density contribution
      F(p) = -sqrt(p)
  SC (Sutton-Chen, eam_sc.c:38-78):
      phi = eps (a/r)^n, rho = (a/r)^m, F(p) = -c eps sqrt(p)
  EXP (Johnson-style, eam_exp.c:75-110):
      rho_ij = f_e exp(-beta (r/r_e - 1)),  f_e = rho_e/12
      phi    = phi_e exp(-gamma (r/r_e - 1))
      F(p)   = E_c (x ln x - x - y), x = (p/p_e)^(alpha/beta),
               y = (p/p_e)^(gamma/beta);  p_e = E_c/atomvolume
  AT (Ackland-Thetford, eam_at.c):
      phi = (r-c)^2 (c0 + c1 r + c2 r^2) [+ B (b0-r)^3 e^{-alpha r}, r<b0]
      rho = (r-d)^2,  F(p) = -A sqrt(p)
  RATIONAL (eam_rational.c): phi and rho rational functions of r^2 from
      in-deck FIT objects, F rational in rho.

Force combine (eam.c:166-190):
  (dv/dr)/r = pass2_e(r) + pass2_p(r) * (dF_i + dF_j).

compile_eam is host numpy, copied from the JAX package (importing
ddcmd_tpu imports jax).  TABULAR decks (with or without
`tabularFit=rational`) raise NotImplementedError: the JAX package runs
them on its XLA cell-block EAM engine, which the port does not have yet.
The pair sums run in the EAM kernels (ops/eam_half.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..objects import DeckError, ObjectDB
from ..objects import units as U

# the ROADMAP item the tabulated forms wait for
_TABULAR_ITEM = ("the cell-block EAM engine tabulated EAM runs on is not "
                 "ported yet (ROADMAP queue 1, items 16-17)")


@dataclass
class EamParms:
    form: str
    n_species: int
    rcut: float
    pair_tables: dict          # form-specific (T,T) parameter arrays
    embed_tables: dict         # form-specific (T,) parameter arrays


def compile_eam(db: ObjectDB, name: str, species, base_dir: str = ".") -> EamParms:
    del base_dir                  # only TABULAR reads files
    pot = db.get(name, "POTENTIAL")
    form = pot.get_str("form", "exp").upper()
    if form == "TABULAR":
        raise NotImplementedError(f"{name}: EAM form TABULAR: {_TABULAR_ITEM}")
    rmax = pot.get_with_units("rmax", "0.0", "Angstrom")
    if rmax <= 0:
        raise DeckError(f"{name}: EAM requires rmax")
    ns = len(species)
    eV = U.unit_scale("eV")
    Ang = U.unit_scale("Angstrom")

    if form == "FS":
        a = np.zeros((ns, ns))
        b = np.zeros((ns, ns))
        c = np.zeros((ns, ns))
        m = np.zeros((ns, ns))
        n = np.zeros((ns, ns))
        ro = np.zeros((ns, ns))
        ls = np.zeros(ns)
        for i, sp in enumerate(species):
            vals = pot.get_floatv(sp.name)
            if len(vals) < 6:
                raise DeckError(f"{name}: FS needs 6 values for {sp.name}")
            ai, bi, ci, mi, ni, li = vals[:6]
            a[i, i] = ai * eV
            b[i, i] = bi * eV * eV
            c[i, i] = ci * Ang
            m[i, i] = mi
            n[i, i] = ni
            ls[i] = li * Ang
            ro[i, i] = 1.0 * Ang
        for i in range(ns):
            for j in range(i + 1, ns):
                a[i, j] = a[j, i] = np.sqrt(a[i, i] * a[j, j])
                b[i, j] = b[j, i] = np.sqrt(b[i, i] * b[j, j])
                c[i, j] = c[j, i] = 0.25 * (c[i, i] / ls[i] + c[j, j] / ls[j]) * (ls[i] + ls[j])
                m[i, j] = m[j, i] = 0.5 * (m[i, i] + m[j, j])
                n[i, j] = n[j, i] = 0.5 * (n[i, i] + n[j, j])
                ro[i, j] = ro[j, i] = 1.0 * Ang
        x = np.full((ns, ns), rmax)
        return EamParms(form, ns, rmax,
                        dict(a=a, b=b, c=c, m=m, n=n, ro=ro, x=x), {})

    if form == "SC":
        # deck: per-species eps (eV), a (Ang), n, m, c (sc form,
        # eam_sc.c:90-140); combining: geometric eps, arithmetic a/n/m
        eps = np.zeros(ns)
        av = np.zeros(ns)
        nv = np.zeros(ns)
        mv = np.zeros(ns)
        cv = np.zeros(ns)
        for i, sp in enumerate(species):
            vals = pot.get_floatv(sp.name)
            if len(vals) < 5:
                raise DeckError(f"{name}: SC needs 5 values for {sp.name} (eps a n m c)")
            eps[i] = vals[0] * eV
            av[i] = vals[1] * Ang
            nv[i] = vals[2]
            mv[i] = vals[3]
            cv[i] = vals[4]
        E = np.sqrt(np.outer(eps, eps))
        A = 0.5 * (av[:, None] + av[None, :])
        N = 0.5 * (nv[:, None] + nv[None, :])
        M = 0.5 * (mv[:, None] + mv[None, :])
        return EamParms(form, ns, rmax, dict(eps=E, a=A, n=N, m=M),
                        dict(nce=-cv * eps))

    if form == "EXP":
        atomvolume = pot.get_with_units("atomvolume", "1.0", "Angstrom^3")
        phi_e = pot.get_with_units("phi_e", "0.0", "eV")
        r_e = pot.get_with_units("r_e", "0.0", "Angstrom")
        alpha = pot.get_float("alpha", 0.0)
        beta = pot.get_float("beta", 0.0)
        gamma = pot.get_float("gamma", 0.0)
        E_c = pot.get_with_units("E_c", "0.0", "eV")
        rho_e = E_c / atomvolume          # eam_exp.c: overrides deck rho_e
        f_e = rho_e / 12.0
        ones = np.ones((ns, ns))
        return EamParms(form, ns, rmax,
                        dict(f_e=f_e * ones, phi_e=phi_e * ones,
                             beta=beta * ones, gamma=gamma * ones,
                             r_e_inv=ones / r_e),
                        dict(E_c=np.full(ns, E_c), rho_e=np.full(ns, rho_e),
                             ab=np.full(ns, alpha / beta),
                             gb=np.full(ns, gamma / beta)))

    if form == "AT":
        keys = ("A", "B", "b0", "alpha", "c", "c0", "c1", "c2", "d")
        per = {k: np.zeros(ns) for k in keys}
        for i, sp in enumerate(species):
            vals = pot.get_floatv(sp.name)
            if len(vals) < 9:
                raise DeckError(f"{name}: AT needs 9 values for {sp.name} (A B b0 alpha c c0 c1 c2 d)")
            scale = dict(A=eV, B=eV / Ang ** 3, b0=Ang, alpha=1.0 / Ang,
                         c=Ang, c0=eV / Ang ** 2, c1=eV / Ang ** 3,
                         c2=eV / Ang ** 4, d=Ang)
            for k, v in zip(keys, vals):
                per[k][i] = v * scale[k]
        pt = {k: 0.5 * (per[k][:, None] + per[k][None, :]) for k in keys if k != "A"}
        return EamParms(form, ns, rmax, pt, dict(negA=-per["A"]))

    if form == "RATIONAL":
        # FIT objects: <sp>_embedding, <i>_<j>_density (or <sp>_density for
        # density_type=elementwise), <i>_<j>_2body.  Each FIT {cutoff;
        # orderP; orderQ; P=...; Q=...; xUnits; yUnits}; coefficients scale
        # P_k *= y_conv/x_conv^k, Q_k /= x_conv^k, cutoff *= x_conv
        # (read_fit_object, eam_rational.c:27-94).  Density and pair
        # functions are rational functions of r^2 (their cutoff too);
        # embedding is rational in rho (rational_pass0/embedding,
        # eam_rational.c:320-381).
        def read_fit(nm):
            fit = db.get(nm, "FIT")
            cutoff = fit.get_float("cutoff", 0.0)
            pdeg = fit.get_int("orderP", 0)
            qdeg = fit.get_int("orderQ", 0)
            P = np.zeros(pdeg + 1)
            Q = np.zeros(qdeg + 1)
            pv = fit.get_floatv("P") if fit.has("P") else [0.0]
            qv = fit.get_floatv("Q") if fit.has("Q") else [0.0]
            P[: len(pv)] = pv[: pdeg + 1]
            Q[: len(qv)] = qv[: qdeg + 1]
            xu = fit.get_str("xUnits", "NONE")
            yu = fit.get_str("yUnits", "NONE")
            xc = 1.0 if xu.upper() == "NONE" else U.unit_scale(xu)
            yc = 1.0 if yu.upper() == "NONE" else U.unit_scale(yu)
            for k in range(pdeg + 1):
                P[k] *= yc / xc ** k
            for k in range(qdeg + 1):
                Q[k] /= xc ** k
            return cutoff * xc, P, Q

        names = [sp.name for sp in species]
        embeds = [read_fit(f"{nm}_embedding") for nm in names]

        rho_type = pot.get_str("density_type", "NONE").lower()
        rho_fits = {}
        if rho_type == "elementwise":
            # rho[i] = sum_j RHO_{spec(j)}(r_ij): table keyed by neighbor
            # species only (eam_rational.c:159-179)
            for j, nm in enumerate(names):
                fun = read_fit(f"{nm}_density")
                for i in range(ns):
                    rho_fits[(i, j)] = fun
        elif rho_type in ("pair_symmetric", "pairsymmetric"):
            for i in range(ns):
                for j in range(i, ns):
                    try:
                        fun = read_fit(f"{names[i]}_{names[j]}_density")
                    except DeckError:
                        fun = read_fit(f"{names[j]}_{names[i]}_density")
                    rho_fits[(i, j)] = rho_fits[(j, i)] = fun
        elif rho_type in ("pair_general", "pairgeneral"):
            for i in range(ns):
                for j in range(ns):
                    rho_fits[(i, j)] = read_fit(f"{names[i]}_{names[j]}_density")
        else:
            raise DeckError(f"{name}: RATIONAL density_type must be "
                            f"elementwise/pair_symmetric/pair_general, "
                            f"got {rho_type!r}")

        phi_fits = {}
        for i in range(ns):
            for j in range(i, ns):
                try:
                    fun = read_fit(f"{names[i]}_{names[j]}_2body")
                except DeckError:
                    fun = read_fit(f"{names[j]}_{names[i]}_2body")
                phi_fits[(i, j)] = phi_fits[(j, i)] = fun

        def stack(fits, count):
            dmax = max(max(len(f[1]), len(f[2])) for f in fits.values()) \
                if isinstance(fits, dict) else \
                max(max(len(f[1]), len(f[2])) for f in fits)
            P = np.zeros((count, dmax))
            Q = np.zeros((count, dmax))
            cut = np.zeros(count)
            items = fits.items() if isinstance(fits, dict) else enumerate(fits)
            for k, (c, p, q) in items:
                idx = k[0] * ns + k[1] if isinstance(k, tuple) else k
                P[idx, : len(p)] = p
                Q[idx, : len(q)] = q
                cut[idx] = c
            return P, Q, cut

        rP, rQ, rcut_r = stack(rho_fits, ns * ns)
        pP, pQ, rcut_p = stack(phi_fits, ns * ns)
        eP, eQ, ecut = stack(embeds, ns)
        return EamParms(form, ns, rmax,
                        dict(rhoP=rP, rhoQ=rQ, rho_cut=rcut_r,
                             phiP=pP, phiQ=pQ, phi_cut=rcut_p),
                        dict(P=eP, Q=eQ, cut=ecut))

    raise DeckError(f"EAM form {form} not implemented")


def _rational_eval(P, Q, x, derivative: bool):
    """P(x)/Q(x) with gathered coefficient rows P,Q of shape (..., D).

    Horner over the static degree D (eval_rational, eam_rational.c:294-317);
    derivative is d/dx.
    """
    D = P.shape[-1]
    p = P[..., D - 1]
    q = Q[..., D - 1]
    dp = torch.zeros_like(p)
    dq = torch.zeros_like(q)
    for k in range(D - 2, -1, -1):
        dp = dp * x + p
        dq = dq * x + q
        p = p * x + P[..., k]
        q = q * x + Q[..., k]
    qinv = 1.0 / q
    val = p * qinv
    if not derivative:
        return val
    return val, qinv * (dp - val * dq)


def _pair_eval(form: str, pt: dict, pair_idx, r2, ir, ir2, derivative: bool):
    """phi/rho (or their (d/dr)/r) per pair; pt tensors indexed by the
    flattened (t_i * T + t_j) pair index (an int or an index tensor)."""
    def g(k):
        return pt[k].reshape(-1)[pair_idx]

    r = r2 * ir
    if form == "RATIONAL":
        # rational functions of r^2, zero beyond each fit's own cutoff
        # (rational_pass0, eam_rational.c:339-381); (d/dr)/r = 2 d/d(r2)
        ok_p = r2 < pt["rho_cut"][pair_idx]
        ok_e = r2 < pt["phi_cut"][pair_idx]
        e, de2 = _rational_eval(pt["phiP"][pair_idx], pt["phiQ"][pair_idx],
                                r2, True)
        p, dp2 = _rational_eval(pt["rhoP"][pair_idx], pt["rhoQ"][pair_idx],
                                r2, True)
        if not derivative:
            return torch.where(ok_e, e, 0.0), torch.where(ok_p, p, 0.0)
        return (torch.where(ok_e, 2.0 * de2, 0.0),
                torch.where(ok_p, 2.0 * dp2, 0.0))
    if form == "FS":
        a, b, c, m, n, ro, x = (g(k) for k in ("a", "b", "c", "m", "n", "ro", "x"))
        dri = 1.0 / (r - x)
        lr = torch.log(r / ro)
        e = a * torch.exp(c * dri - m * lr)
        p = b * torch.exp(c * dri - n * lr)
        if not derivative:
            return e, p
        return (-(m / r + c * dri * dri) * ir * e,
                -(n / r + c * dri * dri) * ir * p)
    if form == "SC":
        eps, a, n, m = (g(k) for k in ("eps", "a", "n", "m"))
        arg2 = a * a * ir2
        e = eps * arg2 ** (0.5 * n)
        p = arg2 ** (0.5 * m)
        if not derivative:
            return e, p
        return -n * e * ir2, -m * p * ir2
    if form == "EXP":
        f_e, phi_e, beta, gamma, r_e_inv = (
            g(k) for k in ("f_e", "phi_e", "beta", "gamma", "r_e_inv"))
        p = f_e * torch.exp(-beta * (r * r_e_inv - 1.0))
        e = phi_e * torch.exp(-gamma * (r * r_e_inv - 1.0))
        if not derivative:
            return e, p
        return -gamma * r_e_inv * e * ir, -beta * r_e_inv * p * ir
    if form == "AT":
        B, b0, alpha, c, c0, c1, c2, d = (
            g(k) for k in ("B", "b0", "alpha", "c", "c0", "c1", "c2", "d"))
        poly = c0 + c1 * r + c2 * r2
        core = B * (b0 - r) ** 3 * torch.exp(-alpha * r)
        e = torch.where(r < c, (r - c) ** 2 * poly, 0.0) \
            + torch.where(r < b0, core, 0.0)
        p = torch.where(r < d, (r - d) ** 2, 0.0)
        if not derivative:
            return e, p
        de = torch.where(r < c, 2.0 * (r - c) * poly
                         + (r - c) ** 2 * (c1 + 2.0 * c2 * r), 0.0)
        de = de + torch.where(
            r < b0, -B * (b0 - r) ** 2 * torch.exp(-alpha * r)
            * (alpha * (b0 - r) + 3.0), 0.0)
        dp = torch.where(r < d, 2.0 * (r - d), 0.0)
        return de * ir, dp * ir
    raise ValueError(form)


def _embedding(form: str, et: dict, tidx, rho):
    """(F(rho), dF/drho) per particle or slot; et tensors indexed by the
    species index tidx."""
    eps = 1e-30
    if form == "RATIONAL":
        # F(rho) = P(rho)/Q(rho) for rho < cutoff else 0
        # (rational_embedding, eam_rational.c:320-337)
        ok = rho < et["cut"][tidx]
        v, dv = _rational_eval(et["P"][tidx], et["Q"][tidx], rho, True)
        return torch.where(ok, v, 0.0), torch.where(ok, dv, 0.0)
    if form == "FS":
        v = -torch.sqrt(rho + eps)
        dv = 0.5 / v
        return v, dv
    if form == "SC":
        nce = et["nce"][tidx]
        v = nce * torch.sqrt(rho + eps)
        dv = 0.5 * v / (rho + eps)
        return v, dv
    if form == "AT":
        negA = et["negA"][tidx]
        v = negA * torch.sqrt(rho + eps)
        dv = 0.5 * v / (rho + eps)
        return v, dv
    if form == "EXP":
        E_c = et["E_c"][tidx]
        rho_e = et["rho_e"][tidx]
        ab = et["ab"][tidx]
        gb = et["gb"][tidx]
        rr = rho / rho_e
        ok = rr > 0
        rrs = torch.where(ok, rr, 1.0)
        lnp = torch.log(rrs)
        y = torch.exp(gb * lnp)
        lnx = ab * lnp
        x = torch.exp(lnx)
        v = E_c * (x * lnx - x - y)
        dv = E_c * (ab * x * lnx - gb * y) / torch.where(ok, rho, 1.0)
        return torch.where(ok, v, 0.0), torch.where(ok, dv, 0.0)
    raise ValueError(form)


def eam_device_tables(parms: EamParms, dtype=torch.float32, device="cpu"):
    """Form parameter tensors on the device.  `parms` may come from either
    package's compile_eam (its fields are numpy arrays).  rcut2 stays a
    host float rounded to f32 (a launch argument, never a device read)."""
    if parms.form == "TABULAR" or "phiX0" in parms.pair_tables:
        raise NotImplementedError(
            f"EAM form {parms.form} (tabulated or tabularFit=rational): "
            f"{_TABULAR_ITEM}")

    def dev(tabs):
        return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                for k, v in tabs.items()}

    return dict(pair=dev(parms.pair_tables), embed=dev(parms.embed_tables),
                rcut2=float(np.float32(parms.rcut ** 2)), form=parms.form,
                n_species=parms.n_species)
