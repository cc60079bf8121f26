"""The brick mesh's checkpoint (ParallelSimulation.write_checkpoint) over 8
gloo ranks, and its restarts in both drivers of both packages.

A ZRAMP-balanced (2,2,2) water box (tests/torch_mesh_ranks.skewed_water
at n = 4000) runs 10 steps on a 5-step cadence with a rebalance at rate
5, then writes its snapshot with one atoms# shard per rank and, beside
it, the gathered single writer's (DDCMD_SHARD_WRITERS=0).  The shards
are held to the gathered records, read by both packages' readers, and
the snapshot restarts under the port's and the JAX package's
Simulation (first energy within 2e-5 of the mesh's) and under both
meshes with the saved walls resumed from the pxyz.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.io.collection import read_collection as j_read_collection
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.run.simulate import Simulation as JSimulation
from ddcmd_tpu_torch.io.collection import _strip_header, read_collection
from ddcmd_tpu_torch.io.pxyz import read_pxyz_full
from ddcmd_tpu_torch.models import load
from ddcmd_tpu_torch.run.simulate import Simulation

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

SHAPE = (2, 2, 2)
RLIST = 1.5


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """The deck, the run directory and the rank-0 results of the 8-rank
    run that wrote the checkpoint."""
    root = tmp_path_factory.mktemp("meshio")
    d = str(root / "deck")
    os.makedirs(d)
    ranks.skewed_water(d, n=4000)
    ranks.set_loadbalance(d, "ZRAMP", rate=5, update_rate=5)
    run_dir = d          # a restart's collection files are deck-relative
    out = str(root / "ck.npz")
    ranks.run_ranks(ranks.lb_checkpoint, 8, root, d, SHAPE, 10, run_dir,
                    out)
    return dict(d=d, run_dir=run_dir, z=np.load(out), root=root)


def _records(snapdir):
    """(header text of shard 0, record lines of every shard)."""
    paths = sorted(p for p in os.listdir(snapdir) if p.startswith("atoms#"))
    lines = []
    for i, p in enumerate(paths):
        with open(os.path.join(snapdir, p), "rb") as f:
            blob = f.read()
        body = _strip_header(blob)
        if i == 0:
            head = blob[:len(blob) - len(body)].decode()
        assert i == 0 or body == blob          # continuation: records only
        # a record's leading pad is lost where a header was stripped
        lines += [ln.strip() for ln in body.decode().splitlines()
                  if ln.strip()]
    return head, paths, lines


def test_n_writer_shards_equal_the_gathered_writer(snap):
    """One shard per rank; shard 0's header carries nfiles=8 and the
    mesh-wide nrecord; the records sorted by gid are byte-equal to the
    gathered writer's; both packages' readers read the same particles;
    restart and pxyz sit beside them."""
    z = snap["z"]
    sd, sg = str(z["snap"]), str(z["snap_g"])
    assert int(z["n_rebalance"]) == 1 and int(z["loop"]) == 10
    head, paths, lines = _records(sd)
    head_g, paths_g, lines_g = _records(sg)
    n = len(lines_g)
    assert paths == [f"atoms#{k:06d}" for k in range(8)]
    assert paths_g == ["atoms#000000"]
    assert "nfiles=8;" in head and f"nrecord={n};" in head
    assert head.replace("nfiles=8;", "nfiles=1;") == head_g
    key = lambda ln: int(ln.split()[0])     # noqa: E731  (gid first)
    assert sorted(lines, key=key) == sorted(lines_g, key=key)
    for name in ("restart", "pxyz", "profile"):
        assert os.path.exists(os.path.join(sd, name))
    with open(os.path.join(sd, "restart")) as f, \
            open(os.path.join(sg, "restart")) as g:
        assert f.read() == g.read()
    col = read_collection("atoms#", sd)
    jcol = j_read_collection("atoms#", sd)
    gcol = read_collection("atoms#", sg)
    o, og = np.argsort(col.gid), np.argsort(gcol.gid)
    np.testing.assert_array_equal(np.asarray(col.gid)[o],
                                  np.asarray(gcol.gid)[og])
    np.testing.assert_array_equal(np.asarray(col.r)[o],
                                  np.asarray(gcol.r)[og])
    np.testing.assert_array_equal(np.asarray(jcol.r), np.asarray(col.r))
    np.testing.assert_array_equal(np.asarray(jcol.v), np.asarray(col.v))


def test_restart_in_both_simulations(snap):
    """The snapshot through the port's Simulation (the kernels' plain
    twins, f32) and the JAX package's (the (N,K)-list engine, f64): the
    first energy within 2e-5 of the mesh's at the checkpoint."""
    d, e = snap["d"], float(snap["z"]["e"])
    restart = os.path.join(snap["run_dir"], "restart")
    sim = Simulation(*load(d, restart=restart), run_dir=d, device="cpu")
    sim.first_energy()
    assert sim.ss.loop == 10
    assert float(sim.ss.energy.eion) == pytest.approx(e, rel=2e-5)
    jsim = JSimulation(*j_load(d, restart=restart), run_dir=d,
                       engine="nlist", dtype=jnp.float64)
    jsim.first_energy()
    assert float(jsim.ss.energy.eion) == pytest.approx(e, rel=2e-5)


def test_mesh_restart_resumes_walls(snap, tmp_path):
    """The snapshot under the port's mesh resumes the saved walls (its
    first energy as the mesh's at the checkpoint), and with
    DDCMD_PXYZ_RESTART=0 computes them afresh from the restart's
    positions, as the JAX package's host functions do; the JAX package's
    mesh resumes the same saved walls from the port's pxyz."""
    from ddcmd_tpu.parallel.loadbalance import clamp_walls, tensor_walls
    from ddcmd_tpu.run.parallel_sim import \
        ParallelSimulation as JParallelSimulation

    d, z = snap["d"], snap["z"]
    restart = os.path.join(snap["run_dir"], "restart")
    out = str(tmp_path / "rs.npz")
    ranks.run_ranks(ranks.lb_restart, 8, tmp_path, d, SHAPE, restart, out)
    rz = np.load(out)
    # the pxyz keeps 12 significant digits (the JAX package's format)
    saved = read_pxyz_full(os.path.join(str(z["snap"]), "pxyz"))["walls"]
    for a in range(3):
        np.testing.assert_array_equal(rz[f"w{a}"], saved[a])
        np.testing.assert_allclose(saved[a], z[f"w{a}"], rtol=0,
                                   atol=1e-11)
    assert float(rz["e"]) == pytest.approx(float(z["e"]), rel=1e-6)
    sd = j_build_system(j_load(d, restart=restart)[0], d,
                        dtype=jnp.float32)
    n = sd.state.n_local
    L = np.asarray(sd.box.lengths, np.float64)
    fresh = [clamp_walls(w, 1.05 * RLIST / L[a]) for a, w in enumerate(
        tensor_walls(np.asarray(sd.state.r[:n]), L, SHAPE, work_power=2))]
    for a in range(3):
        np.testing.assert_array_equal(rz[f"fw{a}"], fresh[a])
    assert any(not np.array_equal(fresh[a], z[f"w{a}"]) for a in range(3))
    jps = JParallelSimulation(*j_load(d, restart=restart), shape=SHAPE)
    for a in range(3):
        np.testing.assert_array_equal(np.asarray(jps.plan.walls[a]),
                                      saved[a])
