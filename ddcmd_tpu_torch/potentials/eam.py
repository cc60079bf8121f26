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
  TABULAR (eam_tabular.c): phi, rho and F from files
      (<A>-<B>_pair = file of r, phi, rho; <A>_embed = file of rho, F),
      looked up by linear interpolation (_tab_lookup); with the deck key
      `tabularFit=rational` the tables are refit to the RATIONAL form
      (fit_tabular_rational), in the shifted, scaled variable
      u = (x - X0) S of each fit.

Force combine (eam.c:166-190):
  (dv/dr)/r = pass2_e(r) + pass2_p(r) * (dF_i + dF_j).

compile_eam, _fit_rational_1d and fit_tabular_rational are host numpy,
copied from the JAX package (importing ddcmd_tpu imports jax), so a refit
gives its coefficients to within float rounding.  The pair sums run in
the EAM kernels (ops/eam_half.py: the analytic forms and the refit, 1-4
species) or on the plain cell-block EAM engine (ops/cellpair_eam.py:
every form, any species count, geometry and dtype) or over the (N,K)
list (eam_eval: every form, any species count, geometry and dtype).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import nearest_image_pbc
from ..objects import DeckError, ObjectDB
from ..objects import units as U


@dataclass
class EamParms:
    form: str
    n_species: int
    rcut: float
    pair_tables: dict          # form-specific (T,T) parameter arrays
    embed_tables: dict         # form-specific (T,) parameter arrays


def compile_eam(db: ObjectDB, name: str, species, base_dir: str = ".") -> EamParms:
    pot = db.get(name, "POTENTIAL")
    form = pot.get_str("form", "exp").upper()
    rmax = pot.get_with_units("rmax", "0.0", "Angstrom")
    if rmax <= 0 and form != "TABULAR":  # TABULAR can take rmax from tables
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

    if form == "TABULAR":
        # deck: <A>-<B>_pair = file (cols: r, phi(r), rho(r));
        #       <A>_embed = file (cols: rho, F(rho))
        # (eam_tabular.c:60-110 keyword scheme; tfunc files)
        import os

        from ..utils.tfunction import TabulatedFunction

        pair_tabs = {}
        rmax_seen = 0.0
        for i, si in enumerate(species):
            for j in range(i, ns):
                sj = species[j]
                key = f"{si.name}-{sj.name}_pair"
                if not pot.has(key):
                    key = f"{sj.name}-{si.name}_pair"
                tf = TabulatedFunction.from_file(
                    os.path.join(base_dir, pot.get_str(key)))
                pair_tabs[(i, j)] = pair_tabs[(j, i)] = tf
                rmax_seen = max(rmax_seen, tf.x_max)
        embed_tabs = []
        for si in species:
            embed_tabs.append(TabulatedFunction.from_file(
                os.path.join(base_dir, pot.get_str(f"{si.name}_embed"))))
        if rmax <= 0:
            rmax = rmax_seen
        tab = EamParms(form, ns, rmax,
                       dict(tabs=pair_tabs), dict(tabs=embed_tabs))
        if pot.get_str("tabularFit", "").lower() == "rational":
            # refit to the RATIONAL form the EAM kernels evaluate; the fit
            # residual is checked against tabularFitTol (default 1e-3
            # relative)
            tol = float(pot.get_str("tabularFitTol", "1e-3"))
            fitted, err = fit_tabular_rational(tab)
            if err > tol:
                raise DeckError(
                    f"{name}: tabularFit=rational residual {err:.2e} "
                    f"exceeds tabularFitTol={tol:.2e}")
            return fitted
        return tab

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


def _fit_rational_1d(x, y, n_p=12, n_q=8, n_iter=12):
    """Least-squares rational fit y(x) ~ P(x)/Q(x) by Sanathanan-Koerner
    iteration (linearize y*Q - P = 0, reweight by 1/Q_prev) on a
    Chebyshev basis over the sample range (monomial Vandermondes above
    degree ~8 are too ill-conditioned for lstsq).  Candidate (deg_p,
    deg_q) pairs are tried and any fit whose Q has a zero in range is
    rejected; coefficients convert back to the monomial form
    _rational_eval expects.  Returns (p, q, max_abs_err / max|y|, x_mid,
    1 / half_range): the coefficients are monomials of
    u = (x - x_mid) / half_range."""
    import numpy.polynomial.chebyshev as Ch
    from numpy.polynomial import Polynomial

    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    scale = max(np.abs(y).max(), 1e-300)
    # fit in the range-centred variable: converting Chebyshev to
    # monomials of raw x explodes the coefficients (the kernels run the
    # Horner sums in f32), while centred, scaled monomials keep term
    # growth ~2^deg * |c_deg|
    xm = 0.5 * (float(x.min()) + float(x.max()))
    h = max(0.5 * (float(x.max()) - float(x.min())), 1e-300)
    t = (x - xm) / h                             # [-1, 1]

    def cheb_cols(deg):
        return Ch.chebvander(t, deg)

    def to_mono(coef):
        series = Ch.Chebyshev(coef)             # domain = [-1, 1] = t
        return series.convert(kind=Polynomial).coef

    def attempt(np_, nq_):
        Vp = cheb_cols(np_)
        Vq = cheb_cols(nq_)[:, 1:] if nq_ else np.zeros((len(t), 0))
        w = np.ones_like(y)
        best_pq = None
        for _ in range(n_iter):
            A = np.concatenate([Vp * w[:, None], -(y * w)[:, None] * Vq],
                               axis=1)
            sol, *_ = np.linalg.lstsq(A, y * w, rcond=None)
            p, q = sol[: np_ + 1], sol[np_ + 1:]
            Qx = 1.0 + Vq @ q
            if np.any(Qx <= 1e-6):               # pole (or near) in range
                break
            err = np.abs((Vp @ p) / Qx - y).max() / scale
            if best_pq is None or err < best_pq[2]:
                best_pq = (p, q, err)
            w = 1.0 / np.abs(Qx)
        if best_pq is None:
            return None
        p, q, err = best_pq
        pk = to_mono(p)
        qk = to_mono(np.concatenate([[1.0], q])) if len(q) else np.array([1.0])
        return pk, qk, err

    best = None
    for np_, nq_ in ((n_p, n_q), (n_p, n_q // 2), (n_p + 4, 0), (n_p, 0),
                     (n_p + 8, 0)):
        got = attempt(np_, nq_)
        if got is not None and (best is None or got[2] < best[2]):
            best = got
            if got[2] < 1e-8:
                break
    if best is None:                             # unreachable: nq=0 is Q=1
        raise RuntimeError("rational fit failed")
    return best + (xm, 1.0 / h)


def fit_tabular_rational(parms: EamParms, n_p=10, n_q=6):
    """TABULAR -> RATIONAL refit (deck `tabularFit=rational`): each pair
    table's phi and rho become rationals of r^2, each embedding table's F
    a rational of rho, as monomials of the fit's shifted, scaled variable
    (keys phiX0/phiS, rhoX0/rhoS and the embedding's X0/S).  The
    embedding's cutoff is inf: F stays live past the sampled range.
    Returns (EamParms RATIONAL, max relative residual over all fitted
    tables)."""
    assert parms.form == "TABULAR"
    ns = parms.n_species
    worst = 0.0
    rhoP = {}
    phiP = {}
    for (i, j), tf in parms.pair_tables["tabs"].items():
        if (j, i) in phiP:                       # (i,j)/(j,i) share the tf
            phiP[(i, j)] = phiP[(j, i)]
            rhoP[(i, j)] = rhoP[(j, i)]
            continue
        r = tf.x0 + tf.dx * np.arange(tf.values.shape[1])
        keep = r > 1e-6
        r2 = r[keep] ** 2
        pphi, qphi, e1, x1, s1 = _fit_rational_1d(r2, tf.values[0][keep],
                                                  n_p, n_q)
        prho, qrho, e2, x2, s2 = _fit_rational_1d(r2, tf.values[1][keep],
                                                  n_p, n_q)
        worst = max(worst, e1, e2)
        phiP[(i, j)] = (tf.x_max ** 2, pphi, qphi, x1, s1)
        rhoP[(i, j)] = (tf.x_max ** 2, prho, qrho, x2, s2)
    embeds = []
    for tf in parms.embed_tables["tabs"]:
        rho = tf.x0 + tf.dx * np.arange(tf.values.shape[1])
        pe, qe, e3, x3, s3 = _fit_rational_1d(rho, tf.values[0], n_p, n_q)
        worst = max(worst, e3)
        # keep F live past the sampled range (TABULAR clips; zeroing
        # would kill dF and kick forces discontinuously if rho drifts)
        embeds.append((np.inf, pe, qe, x3, s3))

    def stack(fits, count):
        dmax = max(max(len(f[1]), len(f[2])) for f in fits.values()) \
            if isinstance(fits, dict) else \
            max(max(len(f[1]), len(f[2])) for f in fits)
        P = np.zeros((count, dmax))
        Q = np.zeros((count, dmax))
        cut = np.zeros(count)
        x0 = np.zeros(count)
        sc = np.ones(count)
        items = fits.items() if isinstance(fits, dict) else enumerate(fits)
        for k, (c, p, q, xm, ih) in items:
            idx = k[0] * ns + k[1] if isinstance(k, tuple) else k
            P[idx, : len(p)] = p
            Q[idx, : len(q)] = q
            cut[idx] = c
            x0[idx] = xm
            sc[idx] = ih
        return P, Q, cut, x0, sc

    rP, rQ, rc, rx, rs = stack(rhoP, ns * ns)
    pP, pQ, pc, px, ps = stack(phiP, ns * ns)
    eP, eQ, ec, ex, es = stack(embeds, ns)
    fitted = EamParms("RATIONAL", ns, parms.rcut,
                      dict(rhoP=rP, rhoQ=rQ, rho_cut=rc, rhoX0=rx, rhoS=rs,
                           phiP=pP, phiQ=pQ, phi_cut=pc, phiX0=px, phiS=ps),
                      dict(P=eP, Q=eQ, cut=ec, X0=ex, S=es))
    return fitted, worst


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
        # tabularFit coefficients are monomials of u = (r2 - X0) * S (an
        # f32-safe variable); FIT decks carry no shift or scale (X0 = 0,
        # S = 1); chain rule: d/d(r2) = S d/du
        if "phiX0" in pt:
            s_e = pt["phiS"][pair_idx]
            s_p = pt["rhoS"][pair_idx]
            u_e = (r2 - pt["phiX0"][pair_idx]) * s_e
            u_p = (r2 - pt["rhoX0"][pair_idx]) * s_p
        else:
            s_e = s_p = 1.0
            u_e = u_p = r2
        e, de2 = _rational_eval(pt["phiP"][pair_idx], pt["phiQ"][pair_idx],
                                u_e, True)
        de2 = de2 * s_e
        p, dp2 = _rational_eval(pt["rhoP"][pair_idx], pt["rhoQ"][pair_idx],
                                u_p, True)
        dp2 = dp2 * s_p
        if not derivative:
            return torch.where(ok_e, e, 0.0), torch.where(ok_p, p, 0.0)
        return (torch.where(ok_e, 2.0 * de2, 0.0),
                torch.where(ok_p, 2.0 * dp2, 0.0))
    if form == "TABULAR":
        e = _tab_lookup(pt, pair_idx, r, 0, derivative)
        p = _tab_lookup(pt, pair_idx, r, 1, derivative)
        if derivative:  # tables store d/dr; the engines want (d/dr)/r
            return e * ir, p * ir
        return e, p
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
        if "X0" in et:
            sc = et["S"][tidx]
            u = (rho - et["X0"][tidx]) * sc
        else:
            sc = 1.0
            u = rho
        v, dv = _rational_eval(et["P"][tidx], et["Q"][tidx], u, True)
        dv = dv * sc
        return torch.where(ok, v, 0.0), torch.where(ok, dv, 0.0)
    if form == "TABULAR":
        v = _tab_lookup(et, tidx, rho, 0, False)
        dv = _tab_lookup(et, tidx, rho, 0, True)
        return v, dv
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
    package's compile_eam (its fields are numpy arrays, its tables
    TabulatedFunctions: x0, dx, values, derivs are read).  A TABULAR deck
    gives stacked tables (pair: vals / ders (T*T, 2, m) of [phi, rho],
    embed: (T, 1, m) of [F]) with their x0, inv_dx and m.  rcut2 stays a
    host float rounded as `dtype` rounds it (a launch argument, never a
    device read)."""
    if parms.form == "TABULAR":
        T = parms.n_species
        ptabs = parms.pair_tables["tabs"]
        m = max(t.values.shape[1] for t in ptabs.values())
        vals = np.zeros((T * T, 2, m))
        ders = np.zeros((T * T, 2, m))
        x0 = np.zeros(T * T)
        inv_dx = np.zeros(T * T)
        for (i, j), t in ptabs.items():
            vals[i * T + j, :, : t.values.shape[1]] = t.values[:2]
            ders[i * T + j, :, : t.values.shape[1]] = t.derivs[:2]
            x0[i * T + j] = t.x0
            inv_dx[i * T + j] = 1.0 / t.dx
        etabs = parms.embed_tables["tabs"]
        me = max(t.values.shape[1] for t in etabs)
        evals = np.zeros((T, me))
        eders = np.zeros((T, me))
        ex0 = np.zeros(T)
        einv = np.zeros(T)
        for i, t in enumerate(etabs):
            evals[i, : t.values.shape[1]] = t.values[0]
            eders[i, : t.values.shape[1]] = t.derivs[0]
            ex0[i] = t.x0
            einv[i] = 1.0 / t.dx
        pair = dict(vals=vals, ders=ders, x0=x0, inv_dx=inv_dx)
        embed = dict(vals=evals[:, None, :], ders=eders[:, None, :], x0=ex0,
                     inv_dx=einv)
    else:
        pair, embed = parms.pair_tables, parms.embed_tables

    def dev(tabs):
        return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                for k, v in tabs.items()}

    pt, et = dev(pair), dev(embed)
    if parms.form == "TABULAR":
        pt["m"], et["m"] = m, me
    return dict(pair=pt, embed=et,
                rcut2=float(torch.tensor(parms.rcut ** 2, dtype=dtype)),
                form=parms.form, n_species=parms.n_species)


def _tab_lookup(tab, sel_idx, x, col, derivative):
    """Stacked-table linear interpolation: tab tensors (P, cols, m), t
    clamped to [0, m - 1.001] as the JAX package clamps it."""
    src = tab["ders"] if derivative else tab["vals"]
    t = (x - tab["x0"][sel_idx]) * tab["inv_dx"][sel_idx]
    t = torch.clamp(t, 0.0, tab["m"] - 1.001)
    i = torch.floor(t).long()
    frac = t - i
    v0 = src[sel_idx, col, i]
    v1 = src[sel_idx, col, i + 1]
    return v0 + frac * (v1 - v0)



def eam_eval(r, sidx, fmask, nbr_idx, geom, tables, pbc_mask=None):
    """Two-pass EAM over the full (N,K) list (the JAX package's eam_eval,
    on the same _pair_eval / _embedding); pbc_mask as in
    martini_nonbond.  Returns (f, e, virial, pe)."""
    sentinel = r.shape[0]
    form = tables["form"]
    T = tables["n_species"]
    r_ext = torch.cat([r, r.new_zeros((1, 3))], dim=0)
    s_ext = torch.cat([sidx, sidx.new_zeros((1,))], dim=0)
    # orthorhombic boxes keep the displacements per component, (N,K) each
    ortho = geom.dim() == 1
    if ortho:
        d_c = []
        r2 = torch.zeros(nbr_idx.shape, dtype=r.dtype, device=r.device)
        for c in range(3):
            dc = nearest_image_pbc(
                r[:, c][:, None] - r_ext[:, c][nbr_idx], geom[c:c + 1],
                None if pbc_mask is None else pbc_mask[c:c + 1])
            d_c.append(dc)
            r2 = r2 + dc * dc
    else:
        dr = nearest_image_pbc(r[:, None, :] - r_ext[nbr_idx], geom,
                               pbc_mask)
        r2 = torch.sum(dr * dr, dim=-1)

    valid = ((nbr_idx != sentinel) & (r2 < tables["rcut2"]) & (r2 > 0)
             & (fmask[:, None] > 0))
    w = valid.to(r.dtype)
    r2s = torch.where(valid, r2, 1.0)
    ir2 = 1.0 / r2s
    ir = torch.sqrt(ir2)
    s_j = s_ext[nbr_idx]
    pair_idx = sidx[:, None] * T + s_j

    # pass 1: pair energy and density (full list: both directions)
    e1, p1 = _pair_eval(form, tables["pair"], pair_idx, r2s, ir, ir2, False)
    rho = torch.sum(p1 * w, dim=1)
    pe_pair = 0.5 * torch.sum(e1 * w, dim=1)

    F_i, dF = _embedding(form, tables["embed"], sidx, rho)
    F_i = F_i * fmask
    dF = dF * fmask

    # pass 2: forces.  The j-side embedding derivative pairs with the
    # transposed density derivative dp(t_j, t_i): rho_j accumulates
    # p_(t_j, t_i)(r_ij) (the eam.c:166-190 combine rule)
    de, dp = _pair_eval(form, tables["pair"], pair_idx, r2s, ir, ir2, True)
    if T == 1:
        dpT = dp
    else:
        _, dpT = _pair_eval(form, tables["pair"], s_j * T + sidx[:, None],
                            r2s, ir, ir2, True)
    dF_ext = torch.cat([dF, dF.new_zeros((1,))])
    coef = -(de + dp * dF[:, None] + dpT * dF_ext[nbr_idx]) * w
    if ortho:
        f = torch.stack([torch.sum(coef * d_c[c], dim=1) for c in range(3)],
                        dim=1)
        virial = 0.5 * torch.stack([
            torch.stack([torch.sum(coef * d_c[a] * d_c[b])
                         for b in range(3)]) for a in range(3)])
    else:
        fij = coef[:, :, None] * dr
        f = torch.sum(fij, dim=1)
        virial = 0.5 * torch.einsum("nka,nkb->ab", fij, dr)
    pe = pe_pair + F_i
    return f, pe.sum(), virial, pe
