"""Multi-rank helpers for tests/test_torch_mesh.py: spawn one process per
brick over gloo and run a rank function in each.

This module imports torch and the port only (never jax): the spawned
children import it to find their target, so a test module that imports
jax stays out of them.
"""

from __future__ import annotations

import os
import re
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT = 120.0      # s for all ranks of one run


def _entry(fn, rank, world, rdv, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def start_ranks(fn, world: int, tmp_dir, *args, timeout=JOIN_TIMEOUT):
    """Start fn(rank, *args) in `world` spawned gloo ranks (a file://
    rendezvous in tmp_dir) and return join(): every rank is joined within
    `timeout` seconds of the start all told or killed; join raises
    unless all exit 0.  The caller may work in between."""
    rdv = os.path.join(str(tmp_dir), f"rdv_{fn.__name__}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, rdv, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout

    def join():
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running "
                               f"after {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")

    return join


def run_ranks(fn, world: int, tmp_dir, *args, timeout=JOIN_TIMEOUT):
    """fn(rank, *args) in `world` spawned gloo ranks (start_ranks), joined
    before it returns."""
    start_ranks(fn, world, tmp_dir, *args, timeout=timeout)()


def _psim(deck_dir, shape):
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    return ParallelSimulation(*load(deck_dir), shape=shape, device="cpu")


def halo_invariants(rank, deck_dir, shape, out):
    """The frozen-routing refresh reproduces the exchange's ghosts, and
    the reverse reduce of one unit per valid ghost row lands on exactly
    its source rows (tests/test_pallas_shard.py:83-123)."""
    from ddcmd_tpu_torch.parallel.brick import (halo_exchange_3d,
                                                halo_reduce_3d,
                                                halo_refresh_3d)

    ps = _psim(deck_dir, shape)
    f, m, plan, mesh = ps.fields, ps.mask, ps.plan, ps.mesh
    Lv = ps.step_fn.Lv
    ghosts, gmask, ov, routing = halo_exchange_3d(
        {k: f[k] for k in ("r", "q")}, m, Lv, plan, mesh)
    pool_r = halo_refresh_3d(f["r"], routing, plan, mesh)
    same = torch.where(gmask[:, None], pool_r[m.shape[0]:] - ghosts["r"], 0.0)
    ship = torch.cat([torch.zeros((m.shape[0], 1)), gmask[:, None].float()])
    copies = halo_reduce_3d(ship, routing, plan, m.shape[0], mesh)
    np.savez(f"{out}_{rank}.npz", ov=bool(ov), same=float(same.abs().max()),
             copies=copies.numpy(), n_ghost=int(gmask.sum()),
             mask=m.numpy())


def first_forces(rank, deck_dir, shape, out):
    """First forces (gathered by gid), energy and virial of the mesh."""
    ps = _psim(deck_dir, shape)
    ps.f, e, virial, ov, _ = ps.step_fn.first_forces(ps.fields,
                                                      ps.mask)
    g = ps.gather_by_gid(("f",))
    if rank == 0:
        np.savez(out, e=float(e), virial=virial.numpy(), ov=bool(ov),
                 f=g["f"], ncore=np.asarray(ps.cplan.ncore))


def _owned_gids(ps) -> np.ndarray:
    """Every rank's owned gids, mesh-wide, in rank order (duplicates
    kept)."""
    m = ps.mesh.all_gather(ps.mask.to(torch.int64)).numpy().reshape(-1)
    g = ps.mesh.all_gather(ps.fields["gid"]).numpy().reshape(-1)
    return g[m.astype(bool)]


def chunk_migrate(rank, deck_dir, shape, out):
    """Chunks with migration: the owned gids mesh-wide before and after
    (so a row duplicated and another lost cannot hide in the count), the
    rows that changed brick, finite scalars and forces."""
    ps = _psim(deck_dir, shape)
    gids0 = _owned_gids(ps)
    gid0 = set(ps.fields["gid"][ps.mask].tolist())
    ps.first_energy()
    ps.run(4 * ps.chunk_steps)
    gids1 = _owned_gids(ps)
    gid1 = set(ps.fields["gid"][ps.mask].tolist())
    moved = torch.tensor([len(gid1 - gid0)], dtype=torch.int64)
    n = ps.mesh.psum(ps.mask.sum().reshape(1))
    moved = ps.mesh.psum(moved)
    if rank == 0:
        np.savez(out, n=int(n[0]), moved=int(moved[0]), loop=ps.loop,
                 gids0=gids0, gids1=gids1,
                 finite=bool(torch.isfinite(ps.f[ps.mask]).all()))


def bilayer_npt(rank, deck_dir, shape, out, npt=True):
    """The bilayer through the mesh: first forces (gathered by gid) and
    energy; with `npt`, one NPT step from the first state (its box
    against barostat_scale on the same virial), then one NPT chunk with
    migration: every rank's owned (gid, head gid), the constraint
    residual and the box after it."""
    from ddcmd_tpu_torch.core.box import Box
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.integrators.nglf import barostat_scale

    ps = _psim(deck_dir, shape)
    e = ps.first_energy()
    g = ps.gather_by_gid(("f",))
    if not npt:
        if rank == 0:
            np.savez(out, e=e, f=g["f"], excl=ps.step_fn.excl,
                     npt=ps.barostat is not None)
        return
    st = ps.step_fn
    _, _, _, dyn1, _, ov1 = st.chunk(ps.fields, ps.mask, ps.f,
                                     ps.box_state(), ps.loop, steps=1)
    L1 = dyn1["Lv"]
    box0 = Box.from_h(np.diag(ps.Lv.numpy()))
    _, box1 = barostat_scale(ps.sysdef.state, box0, torch.diag(ps.vird),
                             ps.barostat, ps.sysdef.cfg.dt)
    lines = []
    ps.run(ps.chunk_steps, print_fn=lines.append)
    m = ps.mesh.all_gather(ps.mask.to(torch.int64)).numpy().reshape(-1)
    owned = m.astype(bool)
    gids = ps.mesh.all_gather(ps.fields["gid"]).numpy().reshape(-1)[owned]
    hgids = ps.mesh.all_gather(ps.fields["hgid"]).numpy().reshape(-1)[owned]
    where = np.repeat(np.arange(ps.mesh.size), ps.plan.local_cap)[owned]
    r = ps.gather_by_gid(("r",))["r"]
    if rank == 0:
        bt = ps.sysdef.bonded
        resid = constraint_residual(
            SimpleNamespace(r=r), bt.cons_atoms, bt.cons_pairs,
            bt.cons_dist, box_lengths=ps.Lv.numpy())
        np.savez(out, e=e, f=g["f"], L1=L1.numpy(),
                 L1_ref=box1.lengths.numpy(), ov1=bool(ov1),
                 gids=gids, hgids=hgids, where=where, resid=resid,
                 L=ps.Lv.numpy(), loop=ps.loop, chunk=ps.chunk_steps,
                 excl=ps.step_fn.excl, npt=ps.barostat is not None,
                 finite=bool(torch.isfinite(ps.f[ps.mask]).all()),
                 n_lines=len(lines))


def affine_run(rank, deck_dir, shape, steps, out):
    """The first energy, then `steps` steps of the mesh: positions and
    velocities gathered by gid."""
    ps = _psim(deck_dir, shape)
    e = ps.first_energy()
    ps.run(steps)
    g = ps.gather_by_gid(("r", "v"))
    if rank == 0:
        np.savez(out, e=e, r=g["r"], v=g["v"], loop=ps.loop,
                 L=ps.Lv.numpy())


# -- load-balanced walls, the mesh checkpoint, the sharded analyses ---------

def skewed_water(d, n=6000, p_drop=0.8, seed=3, analyses=None):
    """models.martini_water(n) with 80% of the beads removed from the
    slab x < 0 at y fractions [0, 0.3) and from the slab x >= 0 at
    [0.5, 0.8): ORCB's y walls then differ by ~0.24 of the box between
    the two x-slabs (more than rlist), while every brick of a (2,2,2)
    plan stays wider than 2 rlist.  `analyses`: {name: keyword text} of
    ANALYSIS objects appended to the deck (not listed in SIMULATE
    analysis=, which the mesh refuses)."""
    from ddcmd_tpu_torch.io.collection import read_collection
    from ddcmd_tpu_torch.models import martini_water
    from ddcmd_tpu_torch.models.builders import write_atoms

    martini_water(d, n=n)
    col = read_collection("atoms#", d)
    L = float(open(os.path.join(d, "object.data")).read().split(
        "h= ")[1].split()[0]) / 10.0
    f = np.asarray(col.r, np.float64) / L + 0.5
    rng = np.random.default_rng(seed)
    hole = (((f[:, 0] < 0.5) & (f[:, 1] < 0.3))
            | ((f[:, 0] >= 0.5) & (f[:, 1] >= 0.5) & (f[:, 1] < 0.8)))
    keep = ~(hole & (rng.random(len(f)) < p_drop))
    m = int(keep.sum())
    write_atoms(os.path.join(d, "atoms#000000"),
                np.asarray(col.r)[keep] * 10.0, np.zeros((m, 3)),
                ["WxW"] * m, ["solvent"] * m, np.diag([L * 10.0] * 3))
    p = os.path.join(d, "object.data")
    text = open(p).read().replace(f"size={n};", f"size={m};")
    text += "".join(f"{k} ANALYSIS {{ {v} }}\n"
                    for k, v in (analyses or {}).items())
    open(p, "w").write(text)
    return d


def set_loadbalance(d, kind, rate=0, update_rate=20):
    """Name a LOADBALANCE of `kind` at `rate` on the deck's DDC object."""
    p = os.path.join(d, "object.data")
    text = open(p).read()
    text = re.sub(r"ddc DDC \{[^}]*\}\n?", "", text)
    text = re.sub(r"bal LOADBALANCE \{[^}]*\}\n?", "", text)
    text += (f"ddc DDC {{ updateRate={update_rate}; loadBalance=bal; }}\n"
             f"bal LOADBALANCE {{ type={kind}; rate={rate}; }}\n")
    open(p, "w").write(text)


def _walls_npz(walls):
    return {f"w{a}": np.asarray(w, np.float64) for a, w in enumerate(walls)}


def lb_first_forces(rank, deck_dir, shape, out):
    """First forces (gathered by gid), energy and virial of a load-balanced
    mesh, its walls, and each rank's ghost gids from the staged halo
    exchange (<out>_ghosts_<rank>.npz)."""
    from ddcmd_tpu_torch.parallel.brick import halo_exchange_3d

    ps = _psim(deck_dir, shape)
    ps.f, e, virial, ov, _ = ps.step_fn.first_forces(ps.fields,
                                                      ps.mask)
    g = ps.gather_by_gid(("f",))
    ghosts, gmask, ov_h, _ = halo_exchange_3d(
        {"r": ps.fields["r"], "gid": ps.fields["gid"]}, ps.mask,
        ps.step_fn.Lv, ps.plan, ps.mesh)
    np.savez(f"{out}_ghosts_{rank}.npz", gid=ghosts["gid"][gmask].numpy(),
             own=ps.fields["gid"][ps.mask].numpy(), ov=bool(ov_h))
    if rank == 0:
        np.savez(out, e=float(e), virial=virial.numpy(), ov=bool(ov),
                 f=g["f"], ncore=np.asarray(ps.cplan.ncore),
                 cap=ps.cplan.cap, lb_rate=ps.lb_rate, **_walls_npz(
                     ps.plan.walls))


def lb_run(rank, deck_dir, shape, steps, out):
    """`steps` steps of a load-balanced mesh with its rebalances: the walls
    before and after, the rebalance count, every owned gid mesh-wide
    before and after, finite forces."""
    ps = _psim(deck_dir, shape)
    walls0 = ps.plan.walls
    gids0 = _owned_gids(ps)
    ps.first_energy()
    lines = []
    ps.run(steps, print_fn=lines.append)
    gids1 = _owned_gids(ps)
    if rank == 0:
        np.savez(out, loop=ps.loop, n_rebalance=ps.n_rebalance,
                 gids0=gids0, gids1=gids1, n_lines=len(lines),
                 finite=bool(torch.isfinite(ps.f[ps.mask]).all()),
                 **{f"a{k}": v for k, v in _walls_npz(walls0).items()},
                 **_walls_npz(ps.plan.walls))


def orcb_misplaced(rank, deck_dir, shape, out):
    """One particle's position and velocity swapped with a particle's two
    x-slabs away (4 slabs), so that after the chunk's one staged hop it
    sits outside its new owner's brick: the ORCB containment check flags
    it, and the run's ladder recovers through redistribute (counted)."""
    ps = _psim(deck_dir, shape)
    r_host = ps._host_arrays["r"]
    L = ps._live_L()
    fx = r_host[:, 0] / L[0] + 0.5
    w = np.asarray(ps.plan.walls[0])
    a = int(np.nonzero((fx > w[0] + 0.02) & (fx < w[1] - 0.02))[0][0])
    b = int(np.nonzero((fx > w[2] + 0.02) & (fx < w[3] - 0.02))[0][0])
    gid = gid64_of(ps)
    for i, j in ((a, b), (b, a)):
        rows = torch.nonzero(ps.mask & (ps.fields["gid"] == int(gid[i])))
        if len(rows):
            ps.fields["r"][rows[0, 0]] = torch.as_tensor(r_host[j])
            ps.fields["v"][rows[0, 0]] = torch.as_tensor(
                ps._host_arrays["v"][j])
    calls = []
    redistribute = ps.redistribute
    ps.redistribute = lambda *x: (calls.append(1), redistribute(*x))[1]
    ps.first_energy()
    ps.run(ps.chunk_steps)
    gids1 = _owned_gids(ps)
    if rank == 0:
        np.savez(out, redistributed=len(calls), loop=ps.loop, gids1=gids1,
                 n=len(gid),
                 finite=bool(torch.isfinite(ps.f[ps.mask]).all()))


def gid64_of(ps):
    from ddcmd_tpu_torch.parallel.brick import gid64

    return gid64(ps.sysdef.collection.gid)


def lb_checkpoint(rank, deck_dir, shape, steps, run_dir, out):
    """`steps` steps with rebalances, then the N-writer checkpoint into
    run_dir and the gathered writer (DDCMD_SHARD_WRITERS=0) into
    run_dir/gathered; the mesh's energy of the checkpointed state and
    its walls."""
    ps = _psim(deck_dir, shape)
    ps.first_energy()
    ps.run(steps)
    snap = ps.write_checkpoint(run_dir)
    os.environ["DDCMD_SHARD_WRITERS"] = "0"
    os.makedirs(os.path.join(run_dir, "gathered"), exist_ok=True)
    snap_g = ps.write_checkpoint(os.path.join(run_dir, "gathered"))
    del os.environ["DDCMD_SHARD_WRITERS"]
    e = ps.first_energy()
    if rank == 0:
        np.savez(out, e=e, snap=snap, snap_g=snap_g, loop=ps.loop,
                 n_rebalance=ps.n_rebalance, **_walls_npz(ps.plan.walls))


def lb_restart(rank, deck_dir, shape, restart, out):
    """The mesh from a restart: its walls and first energy, then with
    DDCMD_PXYZ_RESTART=0 the walls computed afresh."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    ps = ParallelSimulation(*load(deck_dir, restart=restart), shape=shape,
                            device="cpu")
    e = ps.first_energy()
    os.environ["DDCMD_PXYZ_RESTART"] = "0"
    fresh = ParallelSimulation(*load(deck_dir, restart=restart), shape=shape,
                               device="cpu").plan.walls
    del os.environ["DDCMD_PXYZ_RESTART"]
    if rank == 0:
        np.savez(out, e=e, **_walls_npz(ps.plan.walls),
                 **{f"f{k}": v for k, v in _walls_npz(fresh).items()})


def lb_analyses(rank, deck_dir, shape, steps, run_dir, out):
    """After `steps` steps: each eval_sharded class against its gathered
    eval on view(), run_analyses' files, and view()'s r, v and f
    against gather_by_gid."""
    from ddcmd_tpu_torch.analysis.registry import build_analysis

    ps = _psim(deck_dir, shape)
    ps.first_energy()
    ps.run(steps)
    view = ps.view()
    g = ps.gather_by_gid(("r", "v", "f"))
    n = ps.sysdef.state.n_local
    res = {}
    for obj in ps.db.by_class("ANALYSIS"):
        sh, ga = build_analysis(obj.name, obj), build_analysis(obj.name, obj)
        if not hasattr(sh, "eval_sharded"):
            continue
        res[f"{obj.name}_shardable"] = sh.shardable(ps)
        if not sh.shardable(ps):
            continue
        sh.eval_sharded(ps)
        ga.eval(view)
        for k, v in sh.state.items():
            if isinstance(v, (np.ndarray, list)) and len(v):
                res[f"{obj.name}_sh_{k}"] = np.asarray(v, np.float64)
                res[f"{obj.name}_ga_{k}"] = np.asarray(ga.state[k],
                                                       np.float64)
    done = ps.run_analyses(run_dir)
    if rank == 0:
        np.savez(out, done=np.asarray(done), loop=ps.loop,
                 r=g["r"], v=g["v"], f=g["f"],
                 vr=view.ss.state.r[:n].numpy(),
                 vv=view.ss.state.v[:n].numpy(),
                 vf=view.ss.state.f[:n].numpy(),
                 L=ps._live_L(), **res)


def halo_gids(rank, shape, walls, r, L, rlist, out):
    """Each rank's ghost gids from the staged halo exchange of positions
    r (gid = row) under a BrickPlan with `walls` in a cubic box L."""
    from ddcmd_tpu_torch.parallel.brick import (BrickPlan,
                                                distribute_bricks,
                                                halo_exchange_3d)
    from ddcmd_tpu_torch.parallel.mesh import BrickMesh

    n = len(r)
    plan = BrickPlan(shape=shape, local_cap=n, halo_cap=n, migrate_cap=64,
                     rlist=rlist, walls=walls)
    buf, mask, _ = distribute_bricks(
        dict(r=r, gid=np.arange(n, dtype=np.int64)), [L] * 3, plan)
    mesh = BrickMesh(shape, "cpu")
    rows = slice(rank * n, (rank + 1) * n)
    gh, gm, ov, _ = halo_exchange_3d(
        {k: torch.as_tensor(v[rows]) for k, v in buf.items()},
        torch.as_tensor(mask[rows]), torch.tensor([L] * 3), plan, mesh)
    np.savez(f"{out}_{rank}.npz", gid=gh["gid"][gm].numpy(), ov=bool(ov))


def seam_migrate(rank, shape, walls, r, L, rlist, row, x_new, out):
    """Distribute r (gid = row) under `walls`, move particle `row`'s x to
    the unwrapped fraction x_new (on its owner), migrate once: the
    overflow flag and each rank's owned gids."""
    from ddcmd_tpu_torch.parallel.brick import (BrickPlan,
                                                distribute_bricks,
                                                migrate_3d)
    from ddcmd_tpu_torch.parallel.mesh import BrickMesh

    n = len(r)
    plan = BrickPlan(shape=shape, local_cap=n, halo_cap=n, migrate_cap=64,
                     rlist=rlist, walls=walls)
    buf, mask, _ = distribute_bricks(
        dict(r=r, gid=np.arange(n, dtype=np.int64)), [L] * 3, plan)
    rows = slice(rank * n, (rank + 1) * n)
    f = {k: torch.as_tensor(v[rows]) for k, v in buf.items()}
    m = torch.as_tensor(mask[rows])
    hit = torch.nonzero(m & (f["gid"] == row)).reshape(-1)
    if len(hit):
        f["r"][hit[0], 0] = float(x_new) * L
    cur, m2, ov = migrate_3d(f, m, torch.tensor([L] * 3), plan,
                             BrickMesh(shape, "cpu"))
    ov = BrickMesh(shape, "cpu").psum(ov.to(torch.float32).reshape(1))
    np.savez(f"{out}_{rank}.npz", ov=bool(ov[0] > 0),
             own=cur["gid"][m2].numpy())


# -- the brick (N,K)-list engine ---------------------------------------------

def list_bricks(rank, spec, shape, dtype, out, move=None):
    """The dry run's brick legs on parallel/brickstep.BrickStepList: the
    system in the npz `spec` (r, v, q, mass, species, group, gid, the LJ
    and RF tables, L, rcut, skin; with `bonds` the dimers' bonds and
    constraints, gid-keyed, and hgid; with `h` a triclinic box) on a mesh
    of `shape` in `dtype`: first forces gathered by gid, energy,
    overflow, then one step and one migration (their overflows, every
    owned gid after it).  move: (gid, x) sets that particle's x on its
    owner after the distribution, as if it had drifted there since the
    last migration."""
    res = _list_bricks(rank, dict(np.load(spec)), shape, dtype, move)
    if rank == 0:
        np.savez(out, **res)


def _list_bricks(rank, z, shape, dtype, move=None):
    """list_bricks' work on the loaded spec `z`: its npz fields (on rank
    0; the others' are those of their own copies)."""
    from ddcmd_tpu_torch.core.groups import Group, GroupTable
    from ddcmd_tpu_torch.nbr.celllist import CellGrid
    from ddcmd_tpu_torch.parallel.brick import BrickPlan, distribute_bricks
    from ddcmd_tpu_torch.parallel.brickstep import BrickStepList
    from ddcmd_tpu_torch.parallel.mesh import BrickMesh

    dt_ = getattr(torch, dtype)
    n, L = len(z["r"]), float(z["L"])
    geom = np.asarray(z["h"], np.float64) if "h" in z else np.full(3, L)
    spans = (1.0 / np.linalg.norm(np.linalg.inv(geom), axis=1)
             if geom.ndim == 2 else geom)
    rcut, skin = float(z["rcut"]), float(z["skin"])
    n_dev = int(np.prod(shape))
    plan = BrickPlan(shape=shape, local_cap=8 * n // n_dev,
                     halo_cap=4 * n // n_dev, migrate_cap=256,
                     rlist=rcut + skin)
    grid = CellGrid.plan(spans, rcut, skin, n,
                         plan.local_cap + plan.ghost_cap)
    mesh = BrickMesh(shape, "cpu")
    tables = {k: torch.as_tensor(z[k], dtype=dt_)
              for k in ("sigma", "eps", "shift")}
    tables.update({k: float(z[k]) for k in ("rcut2", "krf", "crf", "keR")})
    coeffs = GroupTable.build([Group("free", 0, "LANGEVIN",
                                     Teq=lambda t: 310.0, tau=1.0)]
                              ).coefficients(0.0, 0.01, dtype=dt_)
    keys = ["r", "v", "q", "mass", "species", "group", "gid"] + (
        ["hgid"] if "hgid" in z else [])
    arrays = {k: (z[k].astype(np.float64 if dtype == "float64"
                              else np.float32)
                  if k in ("r", "v", "q", "mass") else z[k]) for k in keys}
    buf, mask, _ = distribute_bricks(arrays, geom, plan)
    rows = slice(rank * plan.local_cap, (rank + 1) * plan.local_cap)
    fields = {k: torch.as_tensor(v[rows]) for k, v in buf.items()}
    mask = torch.as_tensor(mask[rows])
    if move is not None:
        hit = torch.nonzero(mask & (fields["gid"] == move[0])).reshape(-1)
        fields["r"][hit, 0] = move[1]
    # the drift guard's origin: the positions the step starts from
    fields["r0"] = fields["r"].clone()
    kw = {}
    if "bonds" in z:
        from ddcmd_tpu_torch.parallel.bonded_shard import (
            constraint_gid_tables, mesh_bonded_plan)
        from ddcmd_tpu_torch.potentials.bonded import (BondedTerms,
                                                       device_bonded_tables)

        bt = BondedTerms(bonds=z["bonds"], bond_parms=z["bond_parms"])
        bplan, left = mesh_bonded_plan(device_bonded_tables(bt, dt_), None, n,
                                       z["gid"], "cpu", dt_)
        bt.cons_atoms, bt.cons_pairs = z["bonds"].copy(), z["cons_pairs"]
        bt.cons_dist, bt.n_constraints = z["cons_dist"], len(z["bonds"])
        kw = dict(bonded_plan=bplan, bonded_left=left,
                  cons_tables=constraint_gid_tables(bt, z["gid"]))
    st = BrickStepList(mesh, plan, grid, tables, coeffs, 0.02, geom,
                       np.array([0, 1]), 0, 1, force_kind="martini",
                       skin=skin, dtype=dt_, **kw)
    f, e, virial, ov, _ = st.first_forces(fields, mask)
    m = mesh.all_gather(mask.to(torch.int64)).reshape(-1).bool()
    g = mesh.all_gather(fields["gid"]).reshape(-1)[m].numpy()
    fa = mesh.all_gather(f).reshape(-1, 3)[m].numpy()
    order = np.argsort(z["gid"], kind="stable")
    f_gid = np.zeros((n, 3), fa.dtype)
    f_gid[order[np.searchsorted(z["gid"], g, sorter=order)]] = fa
    fields2, f2, scal, ov_s = st.step(fields, mask, f, 0)
    fields3, mask3, _, ov_m = st.migrate(fields2, mask, f2)
    m3 = mesh.all_gather(mask3.to(torch.int64)).reshape(-1).bool()
    g3 = mesh.all_gather(fields3["gid"]).reshape(-1)[m3].numpy()
    return dict(e=float(e), f=f_gid, ov=bool(ov), ov_s=bool(ov_s),
                ov_m=bool(ov_m), gids=g3, e_step=float(scal[0]),
                finite=bool(torch.isfinite(f2[mask]).all()),
                fmax=float(np.linalg.norm(fa, axis=1).max()))


def mesh_forces(rank, deck_dir, shape, out, engine=None, dtype="float32",
                steps=0, lb_first=False):
    """The mesh of a deck on the engine DDCMD_SHARD_ENGINE=`engine` forces
    (None: the pick) in `dtype`, after one rebalance when `lb_first`:
    first forces gathered by gid, energy, virial, the engine, the first
    energy's wall time, then `steps` steps (finite forces, every owned
    gid mesh-wide)."""
    if engine is not None:
        os.environ["DDCMD_SHARD_ENGINE"] = engine
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    ps = ParallelSimulation(*load(deck_dir), shape=shape, device="cpu",
                            dtype=getattr(torch, dtype))
    if lb_first:
        ps.rebalance()
    t0 = time.perf_counter()
    ps.f, e, virial, ov, _ = ps.step_fn.first_forces(ps.fields,
                                                      ps.mask)
    seconds = time.perf_counter() - t0
    g = ps.gather_by_gid(("f",))
    ps.vird = torch.diagonal(virial).clone()
    extra = {}
    if steps:
        ps.run(steps)
        extra = dict(gids=_owned_gids(ps), loop=ps.loop,
                     n_rebalance=ps.n_rebalance,
                     finite=bool(torch.isfinite(ps.f[ps.mask]).all()))
    if ps.plan.voronoi is not None:
        extra.update(centers=ps.plan.voronoi["centers"],
                     margins=ps.plan.voronoi["margins"])
    if rank == 0:
        np.savez(out, e=float(e), virial=virial.numpy(), ov=bool(ov),
                 f=g["f"], engine=ps.shard_engine, seconds=seconds, **extra)


def voronoi_halo(rank, deck_dir, shape, out):
    """After one rebalance of a VORONOI deck: each rank's owned and ghost
    gids from the list engine's staged halo (<out>_<rank>.npz), and on
    rank 0 the gathered positions, the centres and the margins."""
    from ddcmd_tpu_torch.parallel.brick import halo_exchange_3d

    ps = _psim(deck_dir, shape)
    ps.rebalance()
    gh, gm, ov, _ = halo_exchange_3d(
        {"r": ps.fields["r"], "gid": ps.fields["gid"]}, ps.mask, ps.Lv,
        ps.plan, ps.mesh, centred=True)
    np.savez(f"{out}_{rank}.npz", ghost=gh["gid"][gm].numpy(),
             own=ps.fields["gid"][ps.mask].numpy(), ov=bool(ov))
    r = ps.gather_by_gid(("r",))["r"]
    if rank == 0:
        np.savez(out, r=r, centers=ps.plan.voronoi["centers"],
                 margins=ps.plan.voronoi["margins"], L=ps._live_L(),
                 rlist=ps.plan.rlist)


def voronoi_checkpoint(rank, deck_dir, shape, run_dir, out, restart=None):
    """A VORONOI mesh: without `restart` one rebalance then a checkpoint
    into run_dir; with it, the mesh from that restart.  Its centres,
    margins and first energy (and the snapshot directory)."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    ps = ParallelSimulation(*load(deck_dir, restart=restart), shape=shape,
                            device="cpu")
    snap = ""
    if restart is None:
        ps.rebalance()
        snap = ps.write_checkpoint(run_dir)
    e = ps.first_energy()
    if rank == 0:
        np.savez(out, e=e, snap=snap, centers=ps.plan.voronoi["centers"],
                 margins=ps.plan.voronoi["margins"])


# -- triclinic bricks (tests/test_torch_mesh_triclinic.py) -------------------

def owners_by_gid(ps) -> np.ndarray:
    """(n,) the rank that owns each particle, in the collection's order
    (collective)."""
    m = ps.mesh.all_gather(ps.mask.to(torch.int64)).numpy().astype(bool)
    g = ps.mesh.all_gather(ps.fields["gid"]).numpy()
    col = gid64_of(ps)
    order = np.argsort(col, kind="stable")
    out = np.full(len(col), -1, np.int64)
    for r in range(ps.mesh.size):
        out[order[np.searchsorted(col, g[r][m[r]], sorter=order)]] = r
    return out


def _deck_run(ps, steps):
    """First energy and forces by gid, then `steps` steps: the owned gids
    mesh-wide and whether the forces stayed finite."""
    e = ps.first_energy()
    f = ps.gather_by_gid(("f",))["f"]
    ps.run(steps)
    return dict(e=e, f=f, gids=_owned_gids(ps), loop=ps.loop,
                finite=bool(torch.isfinite(ps.f[ps.mask]).all()))


def triclinic_mesh(rank, spec, decks, out):
    """The eight ranks of the triclinic tests.  The tilted synthetic
    system of the npz `spec` through _list_bricks at (2,2,2) in f32 and
    f64, and at (8,1,1) in f64 with the row spec["seam_gid"] moved past
    the +x seam to spec["seam_x"]; then through ParallelSimulation at
    (2,2,2) in f64: the GENERAL PAIR deck decks["pair"] (first energy and
    forces by gid, two chunks, its checkpoint into the deck directory
    and the mesh restarted from it), the ZRAMP deck decks["zramp"] (its
    walls and owners, first forces, two chunks) and the VORONOI deck
    decks["voronoi"] (its centres and owners at the start, then one
    rebalance, first forces and two chunks).  Rank 0 writes every result
    into the npz `out`, keys prefixed by leg."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    z = dict(np.load(spec))
    res = {}
    for key, shape, dtype, move in (
            ("f32", (2, 2, 2), "float32", None),
            ("f64", (2, 2, 2), "float64", None),
            ("seam", (8, 1, 1), "float64",
             (int(z["seam_gid"]), float(z["seam_x"])))):
        out_k = _list_bricks(rank, z, shape, dtype, move)
        res.update({f"{key}_{k}": v for k, v in out_k.items()})

    def mesh(kind, restart=None):
        d = decks[kind]
        return ParallelSimulation(*load(d, restart=restart), shape=(2, 2, 2),
                                  device="cpu", dtype=torch.float64)

    ps = mesh("pair")
    res.update({f"pair_{k}": v for k, v in _deck_run(ps, 20).items()},
               pair_engine=ps.shard_engine, pair_h=ps.Lv.numpy())
    res["pair_e1"] = ps.first_energy()
    ps.write_checkpoint(decks["pair"])
    ps2 = mesh("pair", os.path.join(decks["pair"], "restart"))
    res.update(pair_restart_e=ps2.first_energy(),
               pair_restart_h=ps2.Lv.numpy())
    ps = mesh("zramp")
    res.update(zramp_owner=owners_by_gid(ps), **{
        f"zramp_{k}": v for k, v in _walls_npz(ps.plan.walls).items()})
    res.update({f"zramp_{k}": v for k, v in _deck_run(ps, 20).items()})
    ps = mesh("voronoi")
    res.update(voronoi_owner=owners_by_gid(ps),
               voronoi_centers=ps.plan.voronoi["centers"])
    ps.rebalance()
    res.update(voronoi_centers_rb=ps.plan.voronoi["centers"],
               voronoi_margins_rb=ps.plan.voronoi["margins"],
               voronoi_r_rb=ps.gather_by_gid(("r",))["r"])
    res.update({f"voronoi_{k}": v for k, v in _deck_run(ps, 20).items()})
    if rank == 0:
        np.savez(out, **res)


def triclinic_npt(rank, deck_dir, shape, steps, out):
    """The GENERAL NPT deck through the mesh in f64: first energy, then
    `steps` steps; the live h after them, the owned gids mesh-wide."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    ps = ParallelSimulation(*load(deck_dir), shape=shape, device="cpu",
                            dtype=torch.float64)
    res = _deck_run(ps, steps)
    if rank == 0:
        np.savez(out, h=ps.Lv.numpy(), engine=ps.shard_engine,
                 barostat=ps.barostat is not None, **res)


# -- the 1-D slab engine (tests/test_torch_slab.py) --------------------------

def _slab_setup(z, walls=None, dtype=torch.float32):
    """(plan, grid, tables, L, arrays) of the dry run's system on the
    world's ring of slabs, walls: load-balanced wall fractions."""
    from ddcmd_tpu_torch.nbr.celllist import CellGrid
    from ddcmd_tpu_torch.parallel.slab import SlabPlan

    n, L = len(z["r"]), float(z["L"])
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    rcut, skin = float(z["rcut"]), float(z["skin"])
    plan = SlabPlan(n_dev=n_dev, local_cap=4 * n // n_dev,
                    halo_cap=4 * n // n_dev, migrate_cap=256,
                    rlist=rcut + skin, walls=walls)
    grid = CellGrid.plan([L] * 3, rcut, skin, n,
                         plan.local_cap + 2 * plan.halo_cap)
    tables = {k: torch.as_tensor(z[k], dtype=dtype)
              for k in ("sigma", "eps", "shift")}
    tables.update({k: float(z[k]) for k in ("rcut2", "krf", "crf", "keR")})
    npdt = np.float64 if dtype == torch.float64 else np.float32
    arrays = {k: (z[k].astype(npdt) if k in ("r", "v", "q", "mass")
                  else z[k])
              for k in ("r", "v", "q", "mass", "species", "group", "gid")}
    return plan, grid, tables, L, arrays


def slab_legs(rank, spec, out):
    """tests/test_parallel.py:53, 82, 145 on the port's slab ring: with
    uniform slabs the first forces (collected by gid), energy and virial,
    five LANGEVIN steps and a migration; with the ZRAMP walls spec["walls"]
    the first forces and energy, three steps and a migration; in f64 with
    the row spec["seam_gid"] moved past the +x seam to spec["seam_x"] the
    first energy and forces.  Rank 0 writes the npz `out`."""
    from ddcmd_tpu_torch.core.groups import Group, GroupTable
    from ddcmd_tpu_torch.parallel.slab import collect, distribute
    from ddcmd_tpu_torch.parallel.step import make_mesh, make_sharded_step

    z = dict(np.load(spec))
    mesh = make_mesh()
    res = {}
    for key, walls, group, steps, dtype in (
            ("uniform", None, "LANGEVIN", 5, torch.float32),
            ("zramp", tuple(z["walls"]), "FREE", 3, torch.float32),
            ("seam", None, "FREE", 0, torch.float64)):
        plan, grid, tables, L, arrays = _slab_setup(z, walls, dtype)
        coeffs = GroupTable.build([Group("g", 0, group, Teq=lambda t: 300.0,
                                         tau=1.0)]).coefficients(
                                             0.0, 0.01, dtype=dtype)
        step, first, migrate = make_sharded_step(
            mesh, plan, grid, tables, coeffs, 0.02, [L] * 3,
            np.array([0, 1]), len(z["r"]), seed=1)
        buf, mask, counts = distribute(arrays, L, plan)
        rows = slice(rank * plan.local_cap, (rank + 1) * plan.local_cap)
        fields = {k: torch.as_tensor(v[rows]) for k, v in buf.items()}
        mask = torch.as_tensor(mask[rows])
        if key == "seam":
            hit = fields["gid"] == int(z["seam_gid"])
            fields["r"][mask & hit, 0] = float(z["seam_x"])
        f, e, virial, ov = first(fields, mask)
        got = collect(dict(fields, f=f), mask, plan, mesh)
        f_gid = np.zeros((len(z["r"]), 3))
        f_gid[got["gid"]] = got["f"]
        res.update({f"{key}_e": float(e), f"{key}_virial": virial.numpy(),
                    f"{key}_ov": bool(ov), f"{key}_f": f_gid,
                    f"{key}_counts": counts})
        ovs, scal = [], []
        for i in range(steps):
            fields, f, s, ov_s = step(fields, mask, f, i)
            ovs.append(bool(ov_s))
            scal.append(s.numpy())
        if steps:
            fields, mask, f, ov_m = migrate(fields, mask, f)
            m_all = mesh.all_gather(mask.to(torch.int64)).reshape(-1).bool()
            res.update({f"{key}_ov_steps": np.array(ovs),
                        f"{key}_scalars": np.array(scal),
                        f"{key}_ov_m": bool(ov_m),
                        f"{key}_gids": mesh.all_gather(fields["gid"]
                                                       ).reshape(-1)[m_all]
                        .numpy(),
                        f"{key}_finite": bool(torch.isfinite(f[mask]).all())})
    if rank == 0:
        np.savez(out, **res)


def _by_gid(ps, names):
    """The named fields gathered by gid (collective), float64."""
    return {k: v.astype(np.float64) for k, v in
            ps.gather_by_gid(names).items()}


def _outside(ps) -> int:
    """Owned rows outside their brick mesh-wide, by the wall comparison
    that decides ownership (collective)."""
    from ddcmd_tpu_torch.parallel.brick import _bounds_of, _in_box

    out = torch.zeros_like(ps.mask)
    for a, n in enumerate(ps.shape):
        if n > 1:
            lo, hi = _bounds_of(ps.plan, ps.mesh.idx3, a)
            x = _in_box(ps.fields["r"][:, a] / ps.Lv[a])
            out = out | (ps.mask & ((x < lo) | (x >= hi)))
    return int(ps.mesh.psum(out.sum().reshape(1))[0])


def mesh_outputs(rank, decks, out):
    """ParallelSimulation.run(migrate_rate=) and the outputs at their
    rates at (2,1,1), one leg a deck of `decks` ({leg: (deck dir, dict of
    the leg's settings)}):
      nvt: FREE f64, run(3 R, migrate_rate=R): positions by gid, loop;
      npt: the Berendsen deck, FREE f64: run(2 k + 3), then run(2 h,
        migrate_rate=h): loop and box after each;
      hot_<engine>: a hot FREE fluid (f64 list engine, or f32 cells
        engine), `steps` one-step calls of run(1, migrate_rate=R): each
        step's positions, forces and energy, the rows outside their
        bricks before it, the redistributes;
      outputs: the deck with analyses, printStress, printGraphs and two
        groups, run `steps` into its run dir (rank 0 writes).
    Rank 0 saves every leg into out (npz)."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    res = {}
    quiet = dict(print_fn=lambda line: None)
    for leg, (d, kw) in decks.items():
        dtype = getattr(torch, kw.get("dtype", "float64"))
        ps = ParallelSimulation(*load(d), shape=(2, 1, 1), device="cpu",
                                dtype=dtype, run_dir=kw.get("run_dir", "."))
        res[f"{leg}_engine"] = ps.shard_engine
        ps.first_energy()
        if leg == "nvt":
            ps.run(3 * kw["R"], migrate_rate=kw["R"], **quiet)
            res.update(nvt_r=_by_gid(ps, ("r",))["r"], nvt_loop=ps.loop)
        elif leg == "npt":
            k = ps.chunk_steps
            half = max(1, k // 2)
            ps.run(2 * k + 3, **quiet)
            res.update(npt_loop1=ps.loop, npt_L1=ps.Lv.numpy().copy())
            ps.run(2 * half, migrate_rate=half, **quiet)
            res.update(npt_loop2=ps.loop, npt_L2=ps.Lv.numpy().copy(),
                       npt_n=int(ps.mesh.psum(ps.mask.sum().reshape(1))[0]))
        elif leg.startswith("hot"):
            redis = []
            real = ps.redistribute

            def counted(*a, **k_):
                redis.append(ps.loop)
                return real(*a, **k_)

            ps.redistribute = counted
            rows = []
            for _ in range(kw["steps"]):
                outside = _outside(ps)
                ps.run(1, migrate_rate=kw["R"], **quiet)
                g = _by_gid(ps, ("r", "f"))
                rows.append((outside, float(ps._last_row[0]), g["r"],
                             g["f"]))
            res.update({f"{leg}_outside": np.array([x[0] for x in rows]),
                        f"{leg}_e": np.array([x[1] for x in rows]),
                        f"{leg}_r": np.stack([x[2] for x in rows]),
                        f"{leg}_f": np.stack([x[3] for x in rows]),
                        f"{leg}_redis": np.array(redis, np.int64)})
        else:
            ps.run(kw["steps"], **quiet)
            res.update(outputs_loop=ps.loop,
                       outputs_ends=np.cumsum([k_ for k_, _ in
                                               ps.dispatch_log]))
    if rank == 0:
        np.savez(out, **res)


def mesh_dynamics(rank, decks, steps, out, restarts=(), f32=()):
    """Item 22's decks through ParallelSimulation at (1,1,2) in f64 (the
    legs of `f32` in f32), one leg a deck of `decks` ({leg: deck dir}):
    the first energy, `steps` steps, then the positions and velocities
    by gid, the live h, zeta, bdot, the last row's energy, kinetic
    energy and virial, the loop, the engine, each brick's owned count
    and the dispatch ends; and the
    energy and the coefficients' noise column of the last coefficient
    refresh (the GLOBAL_ENERGY leg's live Teq).  Each leg of `restarts`
    then writes its checkpoint into its deck directory and a second mesh
    restarts from it: its loop, zeta and bdot.  Rank 0 saves every leg
    into out (npz), keys prefixed by leg."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation, live_h

    res = {}
    for leg, d in decks.items():
        dtype = torch.float32 if leg in f32 else torch.float64
        ps = ParallelSimulation(*load(d), shape=(1, 1, 2), device="cpu",
                                dtype=dtype, run_dir=d)
        seen = []
        real = ps._refresh

        def refresh(ps=ps, real=real, seen=seen):
            real()
            seen.append((ps._eion_last, ps.coeffs[2].numpy().copy()))

        ps._refresh = refresh
        e0 = ps.first_energy()
        ps.run(steps, print_fn=lambda line: None)
        g = _by_gid(ps, ("r", "v"))
        owned = ps.mesh.all_gather(ps.mask.sum().reshape(1)).reshape(-1)
        row = ps._last_row
        res.update({f"{leg}_{k}": v for k, v in dict(
            r=g["r"], v=g["v"], h=live_h(ps._live_geom()),
            zeta=float(ps.zeta), bdot=ps.bdot.numpy(), e=row[0], rk=row[1],
            virial=row[7:16].reshape(3, 3), e0=e0, loop=ps.loop,
            engine=ps.shard_engine, owned=owned.numpy(),
            ends=np.cumsum([k for k, _ in ps.dispatch_log])).items()})
        if seen and seen[-1][0] is not None:
            res[f"{leg}_ge_e"], res[f"{leg}_ge_noise"] = seen[-1]
        if leg in restarts:
            ps.write_checkpoint(d)
            back = ParallelSimulation(
                *load(d, restart=os.path.join(d, "restart")),
                shape=(1, 1, 2), device="cpu", dtype=torch.float64)
            res.update({f"{leg}_restart_loop": back.loop,
                        f"{leg}_restart_zeta": float(back.zeta),
                        f"{leg}_restart_bdot": back.bdot.numpy()})
    if rank == 0:
        np.savez(out, **res)


def run_legs(rank, todo):
    """Several rank functions of this module in one spawn, in order: todo
    holds (function name, its arguments after the rank)."""
    for name, args in todo:
        globals()[name](rank, *args)


def _spy_transforms(ps, record):
    """Wrap ps.apply_transform: record(ps, tobj, when) runs before ("pre")
    and after ("post") each call on every rank (it may gather)."""
    real = ps.apply_transform

    def spy(tobj):
        record(ps, tobj, "pre")
        ctx = real(tobj)
        record(ps, tobj, "post")
        return ctx

    ps.apply_transform = spy


def mesh_transforms(rank, decks, out):
    """SIMULATE transform= under ParallelSimulation at (2,1,1), one leg a
    deck of `decks` ({leg: deck dir}):
      same: MT_SAME at rate 20 over 60 f64 steps (every step's row, r
        and v by gid before the transforms of each multiple and at the
        end, the view's r, the collection's gids); checkpoints with the
        shard writers and the gathered writer; then THERMALIZE with
        randomizeSeed=1 applied directly (each rank's host velocities);
      rep64: REPLICATE 2x1x1 at rate 20 over 40 f64 steps (every step's
        row, r and v by gid at the end; its VELOCITYAUTOCORRELATION and
        graphs files in the deck's mesh64/);
      rep32: the same deck in f32, 20 steps (the replica at 20), 5
        more, then a BOX that tilts applied directly, and 2 steps: for
        each transform r and v before it, the energy, forces by gid,
        engine and box after it;
      bilayer: the nx = 4 NPT bilayer (FREE, RATTLE) in f64, 12 steps,
        its REPLICATE 2x1x1 (no rate) applied directly, 12 more (every
        step's row, r, v and the box at the end, each bonded family's
        energy before and after the replica); then a SELECTSUBSET that
        cuts a lipid: the error on each rank and the state before and
        after it.
    Rank 0 saves every leg into out (npz), keys prefixed by leg."""
    import chip_smoke
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.parallel.brick import gid64
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation, live_h

    res = {}
    quiet = dict(print_fn=lambda line: None)

    def mesh(d, dtype=torch.float64, run_dir=None):
        run_dir = run_dir or d
        os.makedirs(run_dir, exist_ok=True)
        return ParallelSimulation(*load(d), shape=(2, 1, 1), device="cpu",
                                  dtype=dtype, run_dir=run_dir)

    def put(leg, **kw):
        res.update({f"{leg}_{k}": v for k, v in kw.items()})

    def final(leg, ps, rows):
        g = _by_gid(ps, ("r", "v"))
        owned = ps.mesh.all_gather(ps.mask.sum().reshape(1)).reshape(-1)
        put(leg, rows=rows, r=g["r"], v=g["v"],
            h=live_h(ps._live_geom()), loop=ps.loop, engine=ps.shard_engine,
            n=ps.sysdef.state.n_local, owned=owned.numpy(),
            ends=np.cumsum([k for k, _ in ps.dispatch_log]))

    # --- same: the same-count transforms ------------------------------
    d = decks["same"]
    ps = mesh(d)
    before = []

    def same_rec(ps_, tobj, when):
        if when == "pre" and tobj.name == "therm":
            before.append(_by_gid(ps_, ("r", "v")))

    _spy_transforms(ps, same_rec)
    final("same", ps, chip_smoke.run_rows(ps, 60, **quiet))
    view = ps.view()
    n = ps.sysdef.state.n_local
    put("same", pre_r=np.stack([b["r"] for b in before]),
        pre_v=np.stack([b["v"] for b in before]),
        view_r=view.ss.state.r[:n].double().numpy(),
        col_gid=gid64(ps.sysdef.collection.gid),
        row_gid=gid64(ps.sysdef.state.gid[:n]),
        ck_shards=ps.write_checkpoint(os.path.join(d, "ck_shards")))
    os.environ["DDCMD_SHARD_WRITERS"] = "0"
    try:
        put("same", ck_gathered=ps.write_checkpoint(
            os.path.join(d, "ck_gathered")))
    finally:
        del os.environ["DDCMD_SHARD_WRITERS"]
    # THERMALIZE with randomizeSeed=1: rank 0 draws, every rank takes it
    ps.db.compile_string("rnd TRANSFORM { type=THERMALIZE; "
                         "temperature=310 K; randomizeSeed=1; }\n")
    v0 = _by_gid(ps, ("v",))["v"]
    ps.apply_transform(ps.db.get("rnd", "TRANSFORM"))
    host_v = ps.mesh.all_gather(torch.as_tensor(ps._host_arrays["v"]))
    put("random", v0=v0, v=_by_gid(ps, ("v",))["v"], host_v=host_v.numpy())
    del ps

    # --- rep64: REPLICATE at its rate in f64 ---------------------------
    ps = mesh(decks["rep"], run_dir=os.path.join(decks["rep"], "mesh64"))
    final("rep64", ps, chip_smoke.run_rows(ps, 40, **quiet))
    del ps

    # --- rep32: the same in f32 on the cells engine, then a tilt -------
    ps = mesh(decks["rep"], torch.float32,
              os.path.join(decks["rep"], "mesh32"))
    seen = []

    def rec32(ps_, tobj, when):
        if when == "pre":
            g = _by_gid(ps_, ("r", "v"))
            seen.append(dict(name=tobj.name, r=g["r"], v=g["v"],
                             engine0=ps_.shard_engine,
                             h0=live_h(ps_._live_geom())))
        else:
            e = ps_.first_energy()
            seen[-1].update(e=e, f=_by_gid(ps_, ("f",))["f"],
                            engine=ps_.shard_engine,
                            h=live_h(ps_._live_geom()))

    _spy_transforms(ps, rec32)
    ps.first_energy()
    ps.run(20, **quiet)
    ps.run(5, **quiet)
    L = [10.0 * float(x) for x in ps._live_L()]
    tilt = (f"tilt TRANSFORM {{ type=BOX; hNew={L[0]!r} 0 {0.1 * L[2]!r} "
            f"0 {L[1]!r} 0 0 0 {L[2]!r} Angstrom; }}\n")
    ps.db.compile_string(tilt)
    ps.apply_transform(ps.db.get("tilt", "TRANSFORM"))
    ps.run(2, **quiet)
    for i, s in enumerate(seen):
        put(f"rep32_{i}", **{k: v for k, v in s.items()})
    put("rep32", count=len(seen), loop=ps.loop, tilt=tilt,
        finite=bool(np.isfinite(ps._last_row).all()))
    del ps

    # --- bilayer: REPLICATE on a topology, then a cut ------------------
    ps = mesh(decks["bilayer"])
    fams = []

    def rec_bl(ps_, tobj, when):
        g = _by_gid(ps_, ("r",))
        fams.append(chip_smoke.family_energies(
            ps_.sysdef, g["r"], ps_._live_geom()))

    _spy_transforms(ps, rec_bl)
    rows = chip_smoke.run_rows(ps, 12, **quiet)
    ps.apply_transform(ps.db.get("rep", "TRANSFORM"))
    final("bilayer", ps, np.concatenate(
        [rows, chip_smoke.run_rows(ps, 12, **quiet)]))
    names = sorted(fams[0])
    put("bilayer", families=names,
        fam0=np.array([fams[0][k] for k in names]),
        fam1=np.array([fams[1][k] for k in names]),
        counts=np.array([ps.sysdef.bonded.counts()[k] for k in
                         ("bonds", "angles", "n_constraints")]))
    # a SELECTSUBSET through a lipid: every rank raises, nothing changes
    g0 = _by_gid(ps, ("r", "v", "f"))
    sd = ps.sysdef
    rn, rws = next(i for i in sd.residue_instances if i[0] == "DPPC")
    x = np.sort(g0["r"][rws, 0])
    ps.db.compile_string(f"cut TRANSFORM {{ type=SELECTSUBSET; xmin="
                         f"{0.5 * (x[0] + x[-1]) * 10.0} Angstrom; }}\n")
    try:
        ps.apply_transform(ps.db.get("cut", "TRANSFORM"))
        err = ""
    except ValueError as e:
        err = str(e)
    errs = [None] * ps.mesh.size
    dist.all_gather_object(errs, err)
    g1 = _by_gid(ps, ("r", "v", "f"))
    put("cut", errs=np.array(errs), n=sd.state.n_local,
        gid=int(sd.collection.gid[rws].min()),
        same=all(np.array_equal(g0[k], g1[k]) for k in g0),
        e0=float(ps._last_row[0]), e1=ps.first_energy())
    if rank == 0:
        np.savez(out, **res)
