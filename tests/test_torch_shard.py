"""The port's extended-grid cell engine (parallel/shard_cells) against the
JAX package's parallel/pallas_shard.py.

Plans are compared exactly; binning and packing on one brick's pool of a
(2,2,2) plan; the kernel modules (TPU kernels #6 and #7, run here as
their plain PyTorch versions) against make_shard_pallas_kernel /
make_shard_eam_kernels in interpret mode, on the same extended-grid
inputs.  Tolerances are those of tests/test_pallas_cellpair.py and
tests/test_pallas_shard.py: LJ/RF force 2e-5 of the force scale, energy
rel 1e-4; EAM density and energy rel 2e-5, force 5e-5 of the scale,
virial rel 5e-3 abs 1.0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddcmd_tpu.core.system import build_system as j_build_system
from ddcmd_tpu.models import eam_crystal as j_eam_crystal
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu.parallel import pallas_shard as jps
from ddcmd_tpu.potentials import eam as jeam
from ddcmd_tpu_torch.objects import units as U
from ddcmd_tpu_torch.ops.eam_half import eam_kernel_tables
from ddcmd_tpu_torch.parallel import shard_cells as tsc
from ddcmd_tpu_torch.potentials import eam as team

torch.set_num_threads(2)

CU = 0.3615                      # nm, the copper lattice constant
SYSTEMS = {                      # box, rcut, skin, particles
    "water": ([9.4] * 3, 1.1, 0.4, 6173),
    "crystal": ([32 * CU] * 3, 0.55, 0.1, 131072),
}
PLAN_FIELDS = ("ncore", "cap", "next3", "n_prog", "n_slot", "ext2slot",
               "slot2ext", "stencil_packed", "alias_groups", "center_frac")


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (4, 1, 1),
                                   (2, 2, 1)])
@pytest.mark.parametrize("system", list(SYSTEMS))
def test_plan_matches_jax(system, shape):
    L, rcut, skin, n = SYSTEMS[system]
    jp = jps.plan_shard_cells(L, shape, rcut, skin, n)
    tp = tsc.plan_shard_cells(L, shape, rcut, skin, n)
    for name in PLAN_FIELDS:
        a, b = getattr(tp, name), getattr(jp, name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert tp.sentinel_cell == jp.sentinel_cell
    if shape == (1, 1, 1):
        assert tp.n_slot == tp.n_prog + 1


def _lattice(L, density, seed, jitter=0.2):
    """A jittered lattice at `density` (per nm^3) filling box L."""
    L = np.asarray(L, dtype=np.float64)
    m = np.maximum(1, np.round(L * density ** (1 / 3))).astype(int)
    g = np.stack(np.meshgrid(*[np.arange(k) for k in m], indexing="ij"),
                 -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    return (((g + 0.5) / m - 0.5) * L
            + (rng.random(g.shape) - 0.5) * jitter * L / m), rng


def _fcc(nc, seed):
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    r = ((cells[:, None, :] + base).reshape(-1, 3) * CU - nc * CU / 2
         + rng.standard_normal((4 * nc ** 3, 3)) * 0.006)
    return r, rng


class Brick:
    """One brick's extended-grid pool through both packages: the same
    positions (the whole box, masked to the brick's core and halo shell)
    made into brick-frame fractions, binned and packed by each."""

    def __init__(self, r, L, shape, idx3, rcut, skin):
        self.n = len(r)
        self.jp = jps.plan_shard_cells(L, shape, rcut, skin, self.n)
        self.tp = tsc.plan_shard_cells(L, shape, rcut, skin, self.n)
        Lj = jnp.asarray(L, jnp.float32)
        idx = tuple(jnp.asarray(i, jnp.int32) for i in idx3)
        self.jgeom = jps.dev_geom(self.jp, idx, jnp.float32)
        self.ju = jps.brick_frame_frac(jnp.asarray(r, jnp.float32), Lj,
                                       self.jp, idx, geom=self.jgeom)
        Lt = torch.tensor(L, dtype=torch.float32)
        self.tgeom = tsc.dev_geom(self.tp, idx3, "cpu")
        self.tu = tsc.brick_frame_frac(torch.tensor(r, dtype=torch.float32),
                                       Lt, self.tp, self.tgeom)
        u = np.asarray(self.ju)
        inside = np.ones(self.n, bool)
        for a in range(3):
            if self.jp.open_axes[a]:
                h = 1.0 / self.jp.ncore[a]
                inside &= (u[:, a] >= -0.5 - h) & (u[:, a] < 0.5 + h)
        self.mask = inside
        self.jperm, self.jcounts, self.jov = jps.bin_pool_ext(
            self.ju, jnp.asarray(inside), self.jp)
        self.tperm, self.tcounts, self.tov = tsc.bin_pool_ext(
            self.tu, torch.as_tensor(inside), self.tp)
        self.jspan = self.jgeom[1] * Lj
        self.tspan = self.tgeom[1] * Lt


def test_bin_and_pack_match_jax():
    """bin_pool_ext and pack_slots_ext on one brick of a (2,2,2) plan,
    positions over the brick's whole extended range (halo shell filled):
    perm, the core counts and the overflow flag equal, every slot cell
    counted (halo cells included, the sentinel 0), slots within 1e-6."""
    r, rng = _lattice([9.4] * 3, 7.47, seed=3)
    b = Brick(r, [9.4] * 3, (2, 2, 2), (1, 0, 1), 1.1, 0.4)
    np.testing.assert_allclose(b.tu.numpy(), np.asarray(b.ju), atol=1e-6)
    np.testing.assert_array_equal(b.tperm.numpy(), np.asarray(b.jperm))
    assert bool(b.tov) == bool(b.jov) is False
    tp = b.tp
    counts = b.tcounts.numpy()
    assert counts.shape == (tp.n_slot,) and counts[-1] == 0
    np.testing.assert_array_equal(counts[:tp.n_prog], np.asarray(b.jcounts))
    assert counts[tp.n_prog:].sum() > 0
    assert counts.sum() == b.mask.sum()
    q = rng.choice([-1.0, 0.0, 1.0], size=b.n) * 0.3
    tidx = rng.integers(0, 2, size=b.n)
    js = jps.pack_slots_ext(b.ju, jnp.asarray(q, jnp.float32),
                            jnp.asarray(tidx), b.jperm, b.jspan, b.jp)
    ts = tsc.pack_slots_ext(b.tu, torch.tensor(q), torch.tensor(tidx),
                            b.tperm, b.tspan, tp)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def _lj_tables(T, rcut=1.1):
    """T = 1: the Martini water bead pair; T = 2: the JAX package's
    synthetic two-type LJ (tests/test_nbr_martini)."""
    if T == 1:
        sigma, eps = np.array([[0.47]]), np.array([[5.0]])
    else:
        sigma = np.array([[0.47, 0.57], [0.57, 0.47]])
        eps = np.array([[5.0, 5.6], [5.6, 5.0]])
    sr6 = (sigma / rcut) ** 6
    f32 = lambda x: float(np.float32(x))                       # noqa: E731
    return dict(sigma=sigma, eps=eps, shift=-4 * eps * (sr6 ** 2 - sr6),
                rcut2=f32(rcut ** 2), krf=f32(0.5 / rcut ** 3),
                crf=f32(1.5 / rcut), keR=f32(U.ke / 15.0))


def _close(got, ref, scale_tol, what):
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= scale_tol * scale, (what, err, scale)


PAIR_CASES = {   # name: (box, shape, brick, T, coulomb)
    "water_T1": ([6.2] * 3, (2, 2, 2), (1, 0, 1), 1, False),
    "charged_T2": ([6.2] * 3, (2, 2, 2), (0, 1, 1), 2, True),
    "two_cell_periodic": ([6.2, 3.2, 3.2], (2, 1, 1), (1, 0, 0), 2, True),
}


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_module_matches_pallas_interpret(case):
    """shard_pair_eval (the port's #6 plain version) against
    shard_pallas_eval with make_shard_pallas_kernel in interpret mode:
    per-pool-row forces and energies (ghost rows' reaction shares
    included) and the virial of one brick."""
    L, shape, idx3, T, coulomb = PAIR_CASES[case]
    r, rng = _lattice(L, 7.47, seed=7)
    b = Brick(r, L, shape, idx3, 1.1, 0.4)
    if case == "two_cell_periodic":
        assert b.tp.ncore[1:] == (2, 2) and len(b.tp.alias_groups) < 14
    q = (rng.choice([-1.0, 0.0, 1.0], size=b.n) * 0.3 if coulomb
         else np.zeros(b.n))
    tidx = rng.integers(0, T, size=b.n)
    tabs = _lj_tables(T)
    jt = dict(tabs, **{k: jnp.asarray(tabs[k], jnp.float32)
                       for k in ("sigma", "eps", "shift")})
    jf, jv, jpe = jps.shard_pallas_eval(
        b.ju, jnp.asarray(q, jnp.float32), jnp.asarray(tidx), b.jperm,
        b.jcounts, b.jspan, b.jp, jt,
        jps.make_shard_pallas_kernel(b.jp, jt, coulomb=coulomb,
                                     interpret=True))
    tt = dict(tabs, **{k: torch.tensor(tabs[k], dtype=torch.float32)
                       for k in ("sigma", "eps", "shift")})
    tf, tv, tpe = tsc.shard_pair_eval(
        b.tu, torch.tensor(q), torch.tensor(tidx), b.tperm, b.tcounts,
        b.tspan, b.tp, tt, tsc.make_shard_pair_kernel(b.tp, tt, coulomb,
                                                      "cpu"))
    _close(tf.numpy(), np.asarray(jf), 2e-5, "force")
    e_t, e_j = float(tpe.double().sum()), float(np.asarray(jpe,
                                                           np.float64).sum())
    assert e_t == pytest.approx(e_j, rel=1e-4, abs=1e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-3,
                               atol=0.5)


def test_ext_wrappers_contract():
    """The extended-grid wrappers on one brick of a (2,2,2) plan: counts
    span every slot cell (n_prog counts raise instead of reading past the
    array), the p side covers the core cells, the q side every slot cell,
    and the sentinel's q rows stay exactly 0."""
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh

    r, rng = _lattice([6.2] * 3, 7.47, seed=9)
    b = Brick(r, [6.2] * 3, (2, 2, 2), (0, 0, 1), 1.1, 0.4)
    tp = b.tp
    q = rng.choice([-1.0, 0.0, 1.0], size=b.n) * 0.3
    slots = tsc.pack_slots_ext(b.tu, torch.tensor(q), torch.zeros(b.n),
                               b.tperm, b.tspan, tp)
    stencil = torch.as_tensor(tp.stencil_packed)
    L8 = tsc.ext_L8(b.tspan, tp, 1.21)
    tabs = _lj_tables(1)
    t3 = [torch.tensor(tabs[k], dtype=torch.float32)
          for k in ("sigma", "eps", "shift")]
    kw = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
              coulomb=True)
    with pytest.raises(ValueError, match="counts"):
        ch.cellpair_half_ext(slots, stencil, L8, b.tcounts[:tp.n_prog], *t3,
                             **kw)
    out_p, out_q, out_cell = ch.cellpair_half_ext(slots, stencil, L8,
                                                  b.tcounts, *t3, **kw)
    assert out_p.shape == (tp.n_prog * tp.cap, 4)
    assert out_q.shape == (tp.n_slot, 8, tp.cap)
    assert out_cell.shape == (tp.n_prog, 8)
    assert not out_q[-1].any() and out_q[tp.n_prog:-1].any()
    et = eam_kernel_tables(team.eam_device_tables(_alloy_parms()))
    eam = dict(form="FS", T=2, degree=et["degree"])
    L8 = tsc.ext_L8(b.tspan, tp, et["rcut2"])
    rho_p, rho_q = eh.eam_rho_half_ext(slots, stencil, L8, b.tcounts,
                                       et["params"], **eam)
    f_p, f_q, f_cell = eh.eam_force_half_ext(slots, stencil, L8, b.tcounts,
                                             et["params"], **eam)
    assert rho_p.shape == (tp.n_prog * tp.cap, 2)
    assert f_p.shape == (tp.n_prog * tp.cap, 3)
    assert f_cell.shape == (tp.n_prog, 8)
    for oq in (rho_q, f_q):
        assert oq.shape == (tp.n_slot, 8, tp.cap)
        assert not oq[-1].any() and oq[tp.n_prog:-1].any()


def _crystal_parms(tmp_path):
    """The eam_crystal deck's RATIONAL parameters (JAX package)."""
    d = str(tmp_path)
    j_eam_crystal(d, nc=4)
    return j_build_system(j_load(d)[0], d).potentials[0][2]


def _alloy_parms():
    """The T = 2 FS alloy with an asymmetric density (b) of
    tests/test_pallas_cellpair.py: tells rho(t_p, t_q) from rho(t_q, t_p)."""
    eV, Ang, rcut = U.unit_scale("eV"), U.unit_scale("Angstrom"), 0.55
    return jeam.EamParms(
        form="FS", n_species=2, rcut=rcut,
        pair_tables=dict(a=np.array([[0.8, 0.7], [0.7, 0.9]]) * eV,
                         b=np.array([[2.0, 3.5], [1.2, 2.6]]) * eV * eV,
                         c=np.array([[1.5, 1.4], [1.4, 1.6]]) * Ang,
                         m=np.full((2, 2), 5.0), n=np.full((2, 2), 7.0),
                         ro=np.full((2, 2), 1.0) * Ang,
                         x=np.full((2, 2), rcut)),
        embed_tables={})


@pytest.mark.parametrize("case", ["rational", "fs_alloy"])
def test_eam_modules_match_pallas_interpret(case, tmp_path):
    """shard_eam_rho / shard_eam_force (the port's #7 plain versions)
    against the JAX package's with make_shard_eam_kernels in interpret
    mode, on one brick of a (2,2,2) plan of an nc = 8 crystal: per-row
    density and pair energy, then forces and virial from the same dF."""
    parms = _crystal_parms(tmp_path) if case == "rational" else \
        _alloy_parms()
    T = parms.n_species
    r, rng = _fcc(8, seed=11)
    L = [8 * CU] * 3
    b = Brick(r, L, (2, 2, 2), (1, 1, 0), 0.55, 0.1)
    tidx = rng.integers(0, T, size=b.n)
    jt = jeam.eam_device_tables(parms, dtype=jnp.float32)
    jrho, jforce = jps.make_shard_eam_kernels(b.jp, jt, interpret=True)
    j_rp, jslots, jL8 = jps.shard_eam_rho(b.ju, jnp.asarray(tidx), b.jperm,
                                          b.jspan, b.jp, jt, jrho)
    tt = eam_kernel_tables(team.eam_device_tables(parms))
    trho, tforce = tsc.make_shard_eam_kernels(b.tp, tt, "cpu")
    t_rp, tslots, tL8 = tsc.shard_eam_rho(b.tu, torch.tensor(tidx), b.tperm,
                                          b.tcounts, b.tspan, b.tp, tt, trho)
    j_rp = np.asarray(j_rp)
    rho_scale = float(np.abs(j_rp[:, 0]).max())
    assert float(np.abs(t_rp[:, 0].numpy() - j_rp[:, 0]).max()) <= \
        2e-5 * rho_scale
    assert float(t_rp[:, 1].double().sum()) == pytest.approx(
        float(j_rp[:, 1].astype(np.float64).sum()), rel=2e-5)
    dF = rng.standard_normal(b.n) * 0.05
    jf, jv = jps.shard_eam_force(jslots, jL8, jnp.asarray(dF, jnp.float32),
                                 b.jperm, b.jp, jforce)
    tf, tv = tsc.shard_eam_force(tslots, tL8, b.tcounts, torch.tensor(dF),
                                 b.tperm, b.tp, tforce)
    _close(tf.numpy(), np.asarray(jf), 5e-5, "force")
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=5e-3,
                               atol=1.0)
