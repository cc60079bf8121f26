"""Force orchestration: one force function from all potentials.

Counterpart of ddcmd_tpu/run/forces.py:build_force_fn (ddcenergy analog,
ddcMD src/ddcenergy.c:160-238) on three engines:

  * "kernel" (the JAX package's "pallas"): the MARTINI nonbond and PAIR
    Lennard-Jones terms on the pair kernels, EAM on its kernels (the
    analytic forms and the tabularFit=rational refit);
  * "cellblock": the same terms on the plain cell-block engines (every
    EAM form);
  * "nlist": every term over the (N,K) neighbor list in plain PyTorch
    (martini_nonbond, pair_lj with the TableFunction, eam_eval,
    pairenergy_eval, the ORDERSH bias), as the JAX package's list engine.

RESTRAINT springs, EXTFORCE groups' constant forces and the bonded
terms (the residue-template batches,
and the generic per-term evaluator on the terms that cross residue
instances and CMAP) run on all three, the bonded terms on a CUDA device
as one captured CUDA graph (GraphedTerm); NONE terms add nothing.  Excluded
(bonded) pairs are masked inside the pair engine (the record's
exclusion channels on the cell engines, the excluded-partner table on
the list), and the bonded block adds back only the reaction-field part
the reference keeps for them (excl_mode "rf_add"): the port never
computes excluded pairs and subtracts them.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..core.box import pbc_mask_or_none
from ..core.system import SystemDef
from ..objects import units as U
from ..ops import cellpair as cb
from ..ops.cellpair import half_back_map, half_grid, pbc_allowed
from ..ops.cellpair_half import (cell_smem_bytes, cellpair_eval_half,
                                 choose_col_group, fit_col_group,
                                 grid_tensors, kernel_inputs)
from ..ops.cellpair_eam import eam_cellblock_eval_half
from ..ops.eam_half import (eam_col_smem_bytes, eam_eval_half,
                            eam_half_supported, eam_kernel_inputs,
                            eam_kernel_tables, n_params)
from ..potentials.eam import eam_device_tables, eam_eval
from ..potentials.martini import martini_device_tables, martini_nonbond
from ..potentials.pair import TABLE_ENGINE, pair_device_tables, pair_lj
from ..potentials.restraint import restraint_eval

# widest exclusion component the exact-f32 record encoding carries
EXCL_MAX_MEMBERS = 12


def _inlist_excl(sysdef: SystemDef) -> bool:
    """True when the pair engine masks excluded pairs (and the bonded
    block adds back only the kept RF term): the MARTINI nonbond term with
    an exclusion list.  The port has no compute-then-subtract path, so
    this is every deck with exclusions."""
    return (sysdef.bonded is not None
            and sysdef.bonded.exclusions is not None
            and any(p[0] == "MARTINI" for p in sysdef.potentials))


def _excl_components(exclusions, n_pad: int) -> dict:
    """{root: [rows]} connected components of the exclusion graph, in the
    order the JAX package's _excl_channels meets them."""
    parent = np.arange(n_pad)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, j in exclusions:
        parent[find(int(i))] = find(int(j))
    comps = defaultdict(list)
    for i, j in exclusions:
        comps[find(int(i))].append(int(i))
        comps[find(int(j))].append(int(j))
    return {root: sorted(set(m)) for root, m in comps.items()}


def wide_exclusion_component(sysdef: SystemDef) -> int:
    """Members of the deck's widest exclusion component when it is wider
    than the EXCL_MAX_MEMBERS the cell engines' in-kernel channels
    encode, else 0."""
    bt = sysdef.bonded
    if bt is None or bt.exclusions is None or len(bt.exclusions) == 0:
        return 0
    comps = _excl_components(np.asarray(bt.exclusions), sysdef.state.n_pad)
    widest = max(len(m) for m in comps.values())
    return widest if widest > EXCL_MAX_MEMBERS else 0


def _excl_channels(exclusions, n_pad: int):
    """Per-particle in-kernel exclusion channels (n_pad, 2) f32:
    [component_id, B + 2^-(intra+1)] with B the exclusion bitmask over the
    particle's connected component of the exclusion graph.  All values are
    exact in f32 when every component has <= 12 members (B < 2^12,
    2^-(intra+1) >= 2^-12).  A wider component raises: such a deck runs on
    the (N,K)-list engine, which masks excluded pairs in the list (the JAX
    package demotes it there), and the port never falls back to
    compute-then-subtract (the f32 residual of a deep bond compression is
    an energy-injecting catapult)."""
    ex = np.asarray(exclusions)
    if len(ex) == 0:
        return None
    vals = np.zeros((n_pad, 2), np.float32)
    intra = {}
    for cid, members in enumerate(_excl_components(ex, n_pad).values()):
        if len(members) > EXCL_MAX_MEMBERS:
            raise NotImplementedError(
                f"an exclusion component of {len(members)} particles "
                f"(rows {members[:4]}...) exceeds the {EXCL_MAX_MEMBERS} the "
                "in-kernel exclusion channels of the cell engines encode "
                'exactly; run the deck on engine="nlist", the (N,K)-list '
                "engine, which masks excluded pairs in the list")
        for k, m in enumerate(members):
            intra[m] = k
            vals[m, 0] = float(cid + 1)
    B = np.zeros(n_pad, np.int64)
    for i, j in ex:
        B[int(i)] |= 1 << intra[int(j)]
        B[int(j)] |= 1 << intra[int(i)]
    rows = np.asarray(sorted(intra.keys()))
    # the fraction stores 2^-(intra+1) (intra=0 must stay fractional); the
    # kernel doubles it back -- both steps exact powers of two
    vals[rows, 1] = (B[rows] + np.exp2(
        -np.asarray([intra[m] for m in rows], np.float64) - 1.0)
    ).astype(np.float32)
    return vals


def _excl_table(exclusions, n_pad: int) -> np.ndarray:
    """(n_pad, Emax) int64 per-particle excluded-partner rows, sentinel
    n_pad, both directions of each (i, j) (the list engine's in-list
    mask)."""
    nbrs = defaultdict(list)
    for i, j in np.asarray(exclusions):
        nbrs[int(i)].append(int(j))
        nbrs[int(j)].append(int(i))
    emax = max(len(v) for v in nbrs.values())
    tbl = np.full((n_pad, emax), n_pad, dtype=np.int64)
    for i, v in nbrs.items():
        tbl[i, :len(v)] = v
    return tbl


class GraphedTerm:
    """A force term of the positions and the box geometry alone, fn(r,
    geom) -> (f, e, virial, pe), replayed on a CUDA device as one captured
    CUDA graph: the bonded terms issue ~150-700 small kernels a call
    (the per-family math, the torsions' and CMAP's autograd), which left
    the host issuing ~1,060 launches a step on the c36 tripeptide at 16%
    busy.  Captured at the first call on the card (after two warm-up
    calls on a side stream), replayed on copies of r and geom; the
    outputs are the graph's own buffers, overwritten by the next call.
    On the CPU it calls fn."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = None

    def _capture(self, r, geom):
        self.r, self.geom = r.clone(), geom.clone()
        with torch.cuda.device(r.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.fn(self.r, self.geom)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.fn(self.r, self.geom)

    def __call__(self, r, geom):
        if r.device.type != "cuda":
            return self.fn(r, geom)
        if self.graph is None or self.r.shape != r.shape \
                or self.geom.shape != geom.shape:
            self._capture(r, geom)
        self.r.copy_(r)
        self.geom.copy_(geom)
        self.graph.replay()
        return self.out


def bonded_tables(sysdef: SystemDef, dtype=torch.float32):
    """The covalent terms' tables on the host (device_bonded_tables in
    `rf_add` mode: the pair kernel masks the excluded pairs and the
    exclusion term adds back only their kept RF part), or None when the
    topology has no bonded term to evaluate (constraints alone add
    none)."""
    bt = sysdef.bonded
    if bt is None or not any(v for k, v in bt.counts().items()
                             if k not in ("n_constraints", "cons_groups")):
        return None
    from ..potentials.bonded import device_bonded_tables

    state = sysdef.state
    mparms = next(p[2] for p in sysdef.potentials if p[0] == "MARTINI")
    return device_bonded_tables(
        bt, dtype, "cpu",
        lj_sigma=mparms.sigma, lj_eps=mparms.eps, lj_shift=mparms.shift,
        rcut=mparms.rcut, keR=U.ke / mparms.epsilon_r,
        charges=state.q.cpu().numpy(),
        species_lj_type=mparms.species_lj_type,
        species_per_particle=state.species.cpu().numpy(),
        excl_mode="rf_add", krf=mparms.krf, crf=mparms.crf)


def build_force_fn(sysdef: SystemDef, grid, dtype=torch.float32,
                   engine: str = "kernel"):
    """Returns force_fn(state, box, handle) -> (f, e_pot, virial, pe),
    with handle the slot permutation from ops.cellpair.build_cell_slots
    on `grid` (the cell engines) or the (N,K) index list from
    nbr.celllist.build_neighbor_list (engine "nlist").

    engine "kernel" (the JAX package's "pallas"; `grid` a plan_lanes
    grid, f32): the MARTINI and PAIR pair terms run their column kernel
    when choose_col_group gives G > 1 and fit_col_group keeps a G > 1
    whose column kernel fits in shared memory, else their per-cell
    kernel; EAM its two-pass kernels.  engine "cellblock" (a
    CellBlockGrid.plan grid, any dtype, triclinic boxes, pbc < 7): the
    pair terms run the plain cell-block engine of ops/cellpair.py, EAM
    that of ops/cellpair_eam.py, both with the pbc < 7 stencil mask;
    neither launches a kernel.  A PAIR TableFunction, PAIRENERGY and
    ORDERSH raise on either cell engine (the list engine's alone).
    engine "nlist" (a CellGrid, any dtype and geometry) runs every term
    over the list (_nlist_terms) and launches no kernel.  The term list
    is kept as force_fn.terms (per-term profiling); each kernel term
    carries `kernel_inputs` (the call it makes, for chip_smoke.py),
    `grid` and `G`."""
    state = sysdef.state
    device = state.device
    if engine == "nlist":
        terms = _nlist_terms(sysdef, dtype, device)
    else:
        terms = _cell_terms(sysdef, grid, dtype, engine, device)

    # covalent terms: the residue-template batches, and the generic
    # evaluator on what does not batch (junctions across residue
    # instances, CMAP)
    btab = bonded_tables(sysdef, dtype)
    if btab is not None:
        from ..potentials.bonded import bonded_eval
        from ..potentials.bonded_batch import (batched_bonded_eval,
                                               build_batched_bonded,
                                               has_terms)

        n_pad = state.n_pad
        # a type of one instance goes to the generic evaluator: batched,
        # the c36 tripeptide's three one-instance residues double its
        # bonded graph (2.19 against 1.09 ms a call on an H100, 700 W)
        bplan, left = build_batched_bonded(btab, sysdef.residue_instances,
                                           n_pad, dtype, device,
                                           min_instances=2)
        if not has_terms(left):
            left = None

        def bonded(r, geom, bplan=bplan, left=left, n_pad=n_pad):
            out = None
            if bplan is not None:
                out = batched_bonded_eval(r, geom, bplan, n_pad, dtype)
            if left is not None:
                gen = bonded_eval(r, geom, left, n_pad, dtype)
                out = gen if out is None else tuple(
                    a + b for a, b in zip(out, gen))
            return out

        graphed = GraphedTerm(bonded)

        def bonded_term(state, box, perm):
            return graphed(state.r, box.geom)

        bonded_term.graphed = graphed
        terms.append(bonded_term)

    ext = np.array([g.extforce for g in sysdef.groups], dtype=np.float64)
    if np.any(ext != 0.0):
        terms.append(_extforce_term(ext, dtype, device))

    def force_fn(state, box, perm):
        f = torch.zeros((state.n_pad, 3), dtype=dtype, device=device)
        pe = torch.zeros((state.n_pad,), dtype=dtype, device=device)
        virial = torch.zeros((3, 3), dtype=dtype, device=device)
        for term in terms:
            tf, _te, tv, tpe = term(state, box, perm)
            f = f + tf
            virial = virial + tv
            pe = pe + tpe
        # total energy from the per-particle sums, after all terms (as
        # the JAX package: every term keeps e == sum(pe))
        return f, pe.sum(), virial, pe

    force_fn.terms = terms
    return force_fn


def _cell_terms(sysdef: SystemDef, grid, dtype, engine, device):
    """The terms of the cell engines ("kernel", "cellblock")."""
    state = sysdef.state
    n_loc = state.n_local
    excl_vals = None
    if _inlist_excl(sysdef):
        excl_vals = torch.as_tensor(
            _excl_channels(sysdef.bonded.exclusions, state.n_pad),
            device=device)
    terms = []
    for ptype, _, parms in sysdef.potentials:
        if ptype == "EAM":
            terms.append(_eam_term(parms, grid, engine, sysdef.box.pbc,
                                   dtype, device))
        elif ptype == "MARTINI":
            tables = martini_device_tables(parms, dtype=dtype, device=device)
            tmap = torch.as_tensor(parms.species_lj_type, device=device)
            # reaction-field Coulomb is dead weight when every local charge
            # is zero (the Martini water box): skip the per-pair RF math and
            # the (zero) self energy
            coul = bool(np.any(state.q[:n_loc].cpu().numpy() != 0.0))
            # uniform-type fast path: scalar LJ parameters in the kernel
            used = np.unique(parms.species_lj_type[
                state.species[:n_loc].cpu().numpy()])
            if len(used) == 1:
                t0 = int(used[0])
                tables = dict(tables, **{
                    k: tables[k][t0:t0 + 1, t0:t0 + 1]
                    for k in ("sigma", "eps", "shift")})
                tmap = torch.zeros_like(tmap)
            terms.append(_pair_term(tables, tmap, coul, excl_vals, grid,
                                    engine, sysdef.box.pbc, device))
        elif ptype == "PAIR":
            # the species index is the type index, the (T, T) tables whole,
            # Coulomb off (run/forces.py:245-283 of the JAX package); the
            # cell engines read no table, so a TableFunction raises
            if parms.table is not None:
                raise NotImplementedError(TABLE_ENGINE)
            tables = pair_device_tables(parms, dtype=dtype, device=device)
            tmap = torch.arange(parms.n_species, device=device)
            terms.append(_pair_term(tables, tmap, False, None, grid, engine,
                                    sysdef.box.pbc, device))
        elif ptype == "RESTRAINT":
            terms.append(_restraint_term(state, parms, dtype, device))
        elif ptype in ("ORDERSH", "PAIRENERGY"):
            raise NotImplementedError(
                f"{ptype} runs on the (N,K)-list engine only (engine "
                '"nlist"; Simulation selects it)')
        elif ptype not in ("NONE", "REFLECT"):
            # REFLECT is a post-drift hook, NONE adds no force
            raise NotImplementedError(f"force term {ptype}")
    return terms


def _nlist_terms(sysdef: SystemDef, dtype, device):
    """The terms of the (N,K)-list engine (run/forces.py:223-384 of the
    JAX package): MARTINI through martini_nonbond with the excluded
    pairs masked in the list, PAIR through pair_lj (LJ or the table), EAM
    through eam_eval (any form), PAIRENERGY, the ORDERSH bias and
    RESTRAINT springs; each term's handle is the (N,K) list, and on a box
    with a non-periodic axis each takes the minimum image on the
    periodic axes only (the JAX terms take it on all three)."""
    state = sysdef.state
    excl_tbl = None
    if _inlist_excl(sysdef):
        excl_tbl = torch.as_tensor(
            _excl_table(sysdef.bonded.exclusions, state.n_pad),
            device=device)
    terms = []
    for ptype, _, parms in sysdef.potentials:
        if ptype == "MARTINI":
            tables = martini_device_tables(parms, dtype=dtype, device=device)
            tmap = torch.as_tensor(parms.species_lj_type, device=device)

            def term(state, box, nbr, tables=tables, tmap=tmap):
                return martini_nonbond(state.r, state.q, tmap[state.species],
                                       state.fmask, nbr, box.geom, tables,
                                       excl_tbl=excl_tbl,
                                       pbc_mask=pbc_mask_or_none(box))[:4]
        elif ptype == "PAIR":
            tables = pair_device_tables(parms, dtype=dtype, device=device)

            def term(state, box, nbr, tables=tables):
                return pair_lj(state.r, state.species, state.fmask, nbr,
                               box.geom, tables, pbc_mask_or_none(box))
        elif ptype == "EAM":
            tables = eam_device_tables(parms, dtype=dtype, device=device)

            def term(state, box, nbr, tables=tables):
                return eam_eval(state.r, state.species, state.fmask, nbr,
                                box.geom, tables, pbc_mask_or_none(box))
        elif ptype == "PAIRENERGY":
            from ..potentials.pairenergy import (pairenergy_device_tables,
                                                 pairenergy_eval)

            tables = pairenergy_device_tables(parms, dtype=dtype,
                                              device=device)

            def term(state, box, nbr, tables=tables):
                return pairenergy_eval(state.r, state.species, state.fmask,
                                       nbr, box.geom, tables,
                                       pbc_mask_or_none(box))
        elif ptype == "ORDERSH":
            from ..potentials.ordersh import make_ordersh_eval

            osh = make_ordersh_eval(parms, state.n_local, dtype)

            def term(state, box, nbr, osh=osh):
                return osh(state.r, state.fmask, nbr, box.geom,
                           pbc_mask_or_none(box))[:4]
        elif ptype == "RESTRAINT":
            term = _restraint_term(state, parms, dtype, device)
        elif ptype in ("NONE", "REFLECT"):
            continue
        else:
            raise NotImplementedError(f"force term {ptype}")
        terms.append(term)
    return terms


def _pair_term(tables, tmap, coul, excl_vals, grid, engine, pbc, device):
    """The shifted-LJ (+ reaction field) term of a MARTINI or PAIR
    potential on the engine: the pair kernels on a plan_lanes grid, or
    the plain cell-block engine (with the pbc < 7 stencil mask) on a
    CellBlockGrid.plan grid.  With Coulomb on, the reaction field's self
    energy is added per particle."""
    hg = half_grid(grid)
    if engine == "cellblock":
        back = half_back_map(hg)
        allowed = pbc_allowed(hg, pbc)

        def pair(state, box, perm):
            return cb.cellpair_eval_half(
                state.r, state.q, tmap[state.species], perm, box.geom, hg,
                tables, back, coulomb=coul, allowed=allowed,
                excl_vals=excl_vals)
        G = None
    else:
        T = tables["sigma"].shape[0]
        G = fit_col_group(hg, choose_col_group(hg), lambda U: cell_smem_bytes(
            hg.cap, T, excl_vals is not None))
        gt = grid_tensors(hg, device, G)

        def pair(state, box, perm):
            return cellpair_eval_half(
                state.r, state.q, tmap[state.species], perm, box.lengths, hg,
                tables, gt, coulomb=coul, excl_vals=excl_vals)

    def pair_term(state, box, perm):
        f, e, virial, pe = pair(state, box, perm)
        if not coul:
            return f, e, virial, pe
        e_self_i = (-0.5 * state.q * state.q * state.fmask
                    * tables["keR"] * tables["crf"])
        return f, e + e_self_i.sum(), virial, pe + e_self_i

    if engine != "cellblock":
        def pair_kernel_inputs(state, box, perm):
            """(kernel, args, kw) of the pair kernel call pair_term makes
            (chip_smoke.py holds the kernel against its twin on these)."""
            return kernel_inputs(state.r, state.q, tmap[state.species],
                                 perm, box.lengths, hg, tables, gt, coul,
                                 excl_vals)

        pair_term.kernel_inputs = pair_kernel_inputs
    pair_term.grid = hg
    pair_term.G = G
    return pair_term


def _extforce_term(ext, dtype, device):
    """EXTFORCE groups: a constant external force on each member
    particle (extforce.c; run/forces.py:459-472 of the JAX package), with
    the potential V = -F.r per particle and no virial."""
    ext = torch.as_tensor(ext, dtype=dtype, device=device)

    def extforce_term(state, box, perm):
        fi = ext[state.group] * state.fmask[:, None]
        pe = -(fi * state.r).sum(dim=1)
        return fi, pe.sum(), torch.zeros((3, 3), dtype=dtype,
                                         device=device), pe

    return extforce_term


def _restraint_term(state, parms, dtype, device):
    """Harmonic restraints (run/forces.py:369-384 of the JAX package): the
    restrained gids map to state rows once, on the host."""
    row_of = {int(g): i for i, g in enumerate(state.gid[:state.n_local])}
    rows = torch.as_tensor([row_of[int(g)] for g in parms.gids],
                           device=device)

    def ten(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    r0, kb, am = ten(parms.r0), ten(parms.kb), ten(parms.axis_mask)

    def restraint_term(state, box, perm):
        return restraint_eval(state.r, box.geom, rows, r0, kb, am)

    return restraint_term


def _eam_term(parms, grid, engine, pbc, dtype, device):
    """The EAM term (run/forces.py:290-339 of the JAX package), the
    species index as the EAM type index: on "kernel" the two-pass kernels
    (the analytic forms and the tabularFit=rational refit, 1-4 species;
    the rest raises ValueError), on "cellblock" the plain cell-block EAM
    engine (every form, any species count, geometry and dtype) with the
    pbc < 7 stencil mask.  The kernels are fully periodic: "kernel" on a
    deck with pbc < 7 raises ValueError."""
    tables = eam_device_tables(parms, dtype=dtype, device=device)
    hg = half_grid(grid)
    if engine == "cellblock":
        back = half_back_map(hg)
        allowed = pbc_allowed(hg, pbc)

        def eam_cb_term(state, box, perm):
            return eam_cellblock_eval_half(state.r, state.species,
                                           state.fmask, perm, box.geom, hg,
                                           tables, back, allowed)

        eam_cb_term.grid = hg
        eam_cb_term.G = None
        return eam_cb_term
    if pbc & 7 != 7:
        raise ValueError(
            f"engine 'kernel': EAM with pbc={pbc}: the EAM kernels are "
            "fully periodic; the deck runs on engine 'cellblock'")
    if not eam_half_supported(tables):
        raise ValueError(
            f"engine 'kernel': EAM form {tables['form']} with "
            f"{tables['n_species']} species: the EAM kernels take the "
            "analytic forms and the tabularFit=rational refit with 1-4 "
            "species; the deck runs on engine 'cellblock'")
    tables = eam_kernel_tables(tables)
    npar = n_params(tables["kform"], tables["degree"])
    G = fit_col_group(hg, choose_col_group(hg), lambda U: eam_col_smem_bytes(
        U, hg.cap, tables["n_species"], npar))
    gt = grid_tensors(hg, device, G)

    def eam_term(state, box, perm):
        return eam_eval_half(state.r, state.species, state.fmask, perm,
                             box.lengths, hg, tables, gt)

    def eam_inputs(state, box, perm):
        """(rho_kernel, force_kernel, slots, args, kw) of the two passes
        eam_term runs (chip_smoke.py holds them against their twins)."""
        return eam_kernel_inputs(state.r, state.species, state.fmask, perm,
                                 box.lengths, hg, tables, gt)

    eam_term.kernel_inputs = eam_inputs
    eam_term.tables = tables
    eam_term.grid = hg
    eam_term.G = G
    return eam_term
