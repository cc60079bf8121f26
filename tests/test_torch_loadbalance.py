"""Load-balanced walls and the pxyz file: the port's host code against the
JAX package's.

parallel/loadbalance.py is a copy (tests/test_torch_host.py holds its
statements equal); here its results, the brick assignment under walls
(parallel/brick.distribute_bricks), io/pxyz.py's text and restart hook,
and the pxyz that every port snapshot now carries are held to the JAX
package's on seeded inputs.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.io import pxyz as jpx
from ddcmd_tpu.parallel import brick as jbrick
from ddcmd_tpu.parallel import loadbalance as jlb
from ddcmd_tpu_torch.io import pxyz as tpx
from ddcmd_tpu_torch.parallel import brick as tbrick
from ddcmd_tpu_torch.parallel import loadbalance as tlb

SHAPES = [(2, 2, 2), (4, 2, 1), (3, 1, 2)]


def _positions(seed=5, n=3000, L=(7.0, 6.0, 8.0)):
    """Two blobs on the body diagonal over a uniform background: a
    density neither separable nor uniform."""
    rng = np.random.default_rng(seed)
    L = np.asarray(L)
    blob = rng.standard_normal((n // 2, 3)) * 0.12 * L + 0.2 * L
    bg = (rng.random((n - n // 2, 3)) - 0.5) * L
    r = np.concatenate([blob, bg])
    return (r - L * np.round(r / L)).astype(np.float32), L


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("shape", SHAPES)
def test_walls_equal_jax(shape):
    """tensor_walls (both work powers, a smear), zramp_walls, orcb_walls
    (with and without the width clamp and a work weight), clamp_walls and
    walls_assign equal the JAX package's on the same positions."""
    r, L = _positions()
    for kw in (dict(work_power=2), dict(work_power=1),
               dict(smear_radius=0.3, smear="hat")):
        _same(tlb.tensor_walls(r, L, shape, **kw),
              jlb.tensor_walls(r, L, shape, **kw))
    _same([tlb.zramp_walls(r[:, 2], -4.0, 8.0, 5, nz=40)],
          [jlb.zramp_walls(r[:, 2], -4.0, 8.0, 5, nz=40)])
    work = np.random.default_rng(1).random(len(r))
    for kw in (dict(), dict(min_frac=(0.2, 0.3, 0.25)), dict(work=work)):
        tw, jw = tlb.orcb_walls(r, L, shape, **kw), jlb.orcb_walls(
            r, L, shape, **kw)
        _same(tw, jw)
        f = r / L + 0.5
        f -= np.floor(f)
        _same(tlb.walls_assign(f, tw, shape), jlb.walls_assign(f, jw, shape))
    for w, mf in (([0.0, 0.05, 0.5, 0.52, 1.0], 0.1), ([0, 0.9, 1.0], 0.2),
                  ([0.0, 0.5, 1.0], 0.6)):
        _same([tlb.clamp_walls(w, mf)], [jlb.clamp_walls(w, mf)])


@pytest.mark.parametrize("kind", ["tensor", "orcb"])
def test_distribute_bricks_equal_jax(kind):
    """distribute_bricks under tensor and ORCB walls gives the JAX
    package's buffers, mask and counts (with head gids too)."""
    r, L = _positions(seed=8)
    shape = (2, 2, 2)
    walls = (tuple(jlb.tensor_walls(r, L, shape)) if kind == "tensor"
             else jlb.orcb_walls(r, L, shape))
    n = len(r)
    g = np.arange(n, dtype=np.int64) + 7
    gid = np.stack([(g & 0xFFFFFFFF).astype(np.uint32),
                    (g >> 32).astype(np.uint32)], axis=1)
    head = g - ((g - 7) % 3)           # molecules of three rows
    hgid = np.stack([(head & 0xFFFFFFFF).astype(np.uint32),
                     (head >> 32).astype(np.uint32)], axis=1)
    arrays = dict(r=r, v=np.ones_like(r), gid=gid, hgid=hgid)
    cap = n
    tplan = tbrick.BrickPlan(shape=shape, local_cap=cap, halo_cap=8,
                             migrate_cap=8, rlist=0.5, walls=walls)
    jplan = jbrick.BrickPlan(shape=shape, local_cap=cap, halo_cap=8,
                             migrate_cap=8, rlist=0.5, walls=walls)
    tb, tm, tc = tbrick.distribute_bricks(arrays, L, tplan)
    jb, jm, jc = jbrick.distribute_bricks(arrays, L, jplan)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc, jc)
    assert (tc > 0).all() and tplan.orcb == (kind == "orcb")
    for k in arrays:
        np.testing.assert_array_equal(tb[k], jb[k])


def _plans(shape=(2, 2, 2)):
    r, L = _positions(seed=2)
    kw = dict(shape=shape, local_cap=64, halo_cap=8, migrate_cap=8,
              rlist=0.5)
    out = {"none": None}
    for name, walls in (("uniform", None),
                        ("tensor", tuple(jlb.tensor_walls(r, L, shape))),
                        ("orcb", jlb.orcb_walls(r, L, shape))):
        out[name] = (tbrick.BrickPlan(walls=walls, **kw),
                     jbrick.BrickPlan(walls=walls, **kw))
    return out, L


def test_pxyz_text_equals_jax(tmp_path):
    """write_pxyz for a single domain, uniform, tensor and ORCB plans
    writes the JAX package's text, and read_pxyz_full / read_pxyz read it
    back as the JAX package does."""
    plans, L = _plans()
    for name, pair in plans.items():
        tp, jp = (None, None) if pair is None else pair
        a, b = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
        tpx.write_pxyz(a, L, tp)
        jpx.write_pxyz(b, L, jp)
        with open(a) as f, open(b) as g:
            assert f.read() == g.read(), name
        tf, jf = tpx.read_pxyz_full(a), jpx.read_pxyz_full(b)
        assert tf["shape"] == jf["shape"] and tf["lb"] == jf["lb"]
        np.testing.assert_array_equal(tf["centers"], jf["centers"])
        assert ("walls" in tf) == ("walls" in jf) == (name in ("tensor",
                                                              "orcb"))
        if "walls" in tf:
            _same(tf["walls"], jf["walls"])
            walls = tp.walls
            for a_ in range(3):
                np.testing.assert_allclose(tf["walls"][a_], walls[a_],
                                           rtol=0, atol=1e-11)
        sh, c = tpx.read_pxyz(a)
        assert sh == jpx.read_pxyz(b)[0]
        np.testing.assert_array_equal(c, jpx.read_pxyz(b)[1])


def test_restore_plan_lb_equals_jax(tmp_path):
    """restore_plan_lb on matching and mismatching shapes and kinds gives
    the JAX package's results; a pxyz that exists but cannot be read
    gives "no saved state" in both, and the port warns."""
    plans, L = _plans()
    for name in ("none", "uniform", "tensor", "orcb"):
        p = str(tmp_path / f"p_{name}")
        pair = plans[name]
        jpx.write_pxyz(p, L, None if pair is None else pair[1])
        for shape in ((2, 2, 2), (2, 2, 1)):
            for kind in (None, "tensor", "bisection", "voronoi"):
                tw, tv = tpx.restore_plan_lb(p, shape, kind)
                jw, jv = jpx.restore_plan_lb(p, shape, kind)
                assert (tw is None) == (jw is None) and tv is None is jv
                if tw is not None:
                    _same(tw, jw)
                    assert (shape, kind, name) in (
                        ((2, 2, 2), "tensor", "tensor"),
                        ((2, 2, 2), "bisection", "orcb"))
    bad = str(tmp_path / "bad")
    with open(bad, "w") as f:
        f.write("not a pxyz\n")
    assert jpx.restore_plan_lb(bad, (2, 2, 2), "tensor") == (None, None)
    with pytest.warns(UserWarning, match="cannot be read"):
        assert tpx.restore_plan_lb(bad, (2, 2, 2), "tensor") == (None, None)
    assert tpx.restore_plan_lb(str(tmp_path / "absent"), (2, 2, 2),
                               "tensor") == (None, None)


def test_simulation_snapshot_holds_jax_files(tmp_path):
    """The repair: a port Simulation checkpoint holds the JAX package's
    snapshot files (atoms#000000, restart, profile, pxyz) and its pxyz
    text equals the JAX package's for the same box (one domain)."""
    from ddcmd_tpu.io.restart import write_checkpoint as jwrite
    from ddcmd_tpu.models import load as j_load
    from ddcmd_tpu.run.simulate import Simulation as JSimulation
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.models import load, martini_water
    from ddcmd_tpu_torch.run.simulate import Simulation

    d = str(tmp_path / "w")
    os.makedirs(d)
    martini_water(d, n=400)
    sim = Simulation(*load(d), run_dir=d, device="cpu")
    jsim = JSimulation(*j_load(d), run_dir=d, engine="nlist",
                       dtype=jnp.float32)
    a = write_checkpoint(sim, str(tmp_path / "t"))
    os.makedirs(str(tmp_path / "j"))
    b = jwrite(jsim, str(tmp_path / "j"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert "pxyz" in os.listdir(a)
    with open(os.path.join(a, "pxyz")) as f, \
            open(os.path.join(b, "pxyz")) as g:
        assert f.read() == g.read()
    torch.testing.assert_close(sim.ss.box.lengths.double(),
                               torch.as_tensor(np.asarray(
                                   jsim.ss.box.lengths, np.float64)))


def test_orcb_reach_is_checked():
    """With four bricks on y, ORCB y walls whose slabs sit two bricks apart
    put a brick within rlist of one two indices away, beyond the staged
    exchange's reach: check_orcb_reach raises; the same walls with one
    brick of offset, and any plan of <= 3 bricks an axis, pass."""
    wx = np.array([0.0, 0.5, 1.0])
    wz = np.tile(np.array([0.0, 1.0]), (2, 4, 1))
    near = np.array([[0.0, 0.25, 0.5, 0.75, 1.0],
                     [0.0, 0.3, 0.55, 0.8, 1.0]])
    far = np.array([[0.0, 0.25, 0.5, 0.75, 1.0],
                    [0.0, 0.05, 0.1, 0.15, 1.0]])
    rf = (0.02, 0.02, 0.02)
    tbrick.check_orcb_reach((wx, near, wz), (2, 4, 1), rf)
    with pytest.raises(ValueError, match="cannot reach"):
        tbrick.check_orcb_reach((wx, far, wz), (2, 4, 1), rf)
    tbrick.check_orcb_reach((wx, far[:, [0, 1, 2, 4]], wz[:, :3]), (2, 3, 1),
                            rf)
