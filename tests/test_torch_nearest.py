"""K2/K2b, the nearest-sphere kernel, against the JAX package's Pallas kernel.

``rt_tpu.pallas_ops.sphere_nearest`` and ``sphere_nearest_packed`` run in
interpret mode, as tests/test_pallas_ops.py runs them, on inputs drawn from
a seeded numpy generator.  Tolerances:
- the winner (idx, -1 on a miss) must be equal on every ray: it feeds every
  later decision of a path;
- t must be BIG on every miss and agree on every hit at rtol 1e-4.  Both
  sides compute the same f32 operations in the same order, but XLA:CPU
  fuses multiply-adds where PyTorch rounds each product, and the
  discriminant h*h - a*c cancels near grazing hits: over 20,000 rays of
  this distribution the largest relative difference was 5.9e-5.
The CUDA kernel is held against the plain version by the ``cuda`` test at
the end, which runs only where a card is present: built without fused
multiply-adds, it must agree bit for bit.  ``rt_tpu`` is imported inside
the CPU tests, so that the ``cuda`` test also runs on a machine without
the JAX package's dependencies.  Serial CPU time of this file: ~6 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu_torch import nearest_ops

torch.set_num_threads(2)

T_MIN, T_MAX = 1e-3, 1e9


def _rays_and_spheres(n, s, seed):
    """tests/test_pallas_ops.py's distribution, plus a duplicated sphere
    (exact ties: the lower id must win)."""
    rs = np.random.default_rng(seed)
    org = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    dirn = rs.normal(size=(n, 3)).astype(np.float32)
    centers = rs.uniform(-4, 4, (s, 3)).astype(np.float32)
    radius = rs.uniform(0.2, 1.5, (s,)).astype(np.float32)
    centers[s - 1], radius[s - 1] = centers[3], radius[3]
    return org, dirn, centers, radius


def _pallas_ops():
    from rt_tpu import pallas_ops

    return pallas_ops


def _assert_same(got, ref):
    t, i = (x.numpy() for x in got)
    t_ref, i_ref = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(i, i_ref)
    hit = i >= 0
    assert (hit == (t < 1e30)).all() and (t[~hit] == np.float32(3e38)).all()
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-4, atol=0)


def test_plain_matches_pallas_interpret():
    org, dirn, centers, radius = _rays_and_spheres(300, 37, 21)  # not tile multiples
    ref = _pallas_ops().sphere_nearest(*map(jnp.asarray, (org, dirn, centers, radius)),
                                    T_MIN, T_MAX, interpret=True)
    got = nearest_ops.sphere_nearest(*map(torch.from_numpy, (org, dirn, centers, radius)),
                                     T_MIN, T_MAX)
    _assert_same(got, ref)
    assert 0 < (got[1] >= 0).sum() < 300  # both hits and misses
    # The explicit plain version is what the wrapper ran on the CPU.
    again = nearest_ops.sphere_nearest_plain(*map(torch.from_numpy, (org, dirn, centers, radius)),
                                             T_MIN, T_MAX)
    _assert_same(again, ref)


def test_zero_radius_padding_never_wins():
    """tests/test_pallas_ops.py:42-53: an r=0 sphere in front never wins."""
    org = np.zeros((4, 3), np.float32)
    dirn = np.tile(np.array([[0, 0, 1.0]], np.float32), (4, 1))
    centers = np.array([[0, 0, 2.0], [0, 0, 1.0]], np.float32)
    radius = np.array([0.5, 0.0], np.float32)
    args = (org, dirn, centers, radius)
    ref = _pallas_ops().sphere_nearest(*map(jnp.asarray, args), T_MIN, T_MAX, interpret=True)
    got = nearest_ops.sphere_nearest(*map(torch.from_numpy, args), T_MIN, T_MAX)
    _assert_same(got, ref)
    assert (got[1] == 0).all()
    np.testing.assert_array_equal(got[0].numpy(), np.float32(1.5))


def test_packed_entry_matches_pallas_interpret():
    """K2b: rays in the kernel layout f32[8, 512] and a padded sphere table
    f32[128, 4], as scene.sph_packed holds it."""
    org, dirn, centers, radius = _rays_and_spheres(512, 37, 22)
    rays = np.zeros((8, 512), np.float32)
    rays[0:3], rays[3:6] = org.T, dirn.T
    sph = np.zeros((128, 4), np.float32)
    sph[:37, 0:3], sph[:37, 3] = centers, radius
    ref = _pallas_ops().sphere_nearest_packed(jnp.asarray(rays), jnp.asarray(sph), T_MIN, T_MAX,
                                           interpret=True)
    got = nearest_ops.sphere_nearest_packed(torch.from_numpy(rays), torch.from_numpy(sph), T_MIN, T_MAX)
    _assert_same(got, ref)
    # The same rays through K2's entry give the same answer.
    _assert_same(nearest_ops.sphere_nearest(*map(torch.from_numpy, (org, dirn, centers, radius)),
                                            T_MIN, T_MAX), ref)
    with pytest.raises(ValueError, match="sphere_nearest_packed"):
        nearest_ops.sphere_nearest_packed(torch.from_numpy(rays[:, :300]), torch.from_numpy(sph),
                                          T_MIN, T_MAX)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Both entries of the CUDA kernel against the plain version on the
    card, t and idx bit for bit: random rays and spheres, the tie scene of
    tests/torch_brute_cases.py at t_max 1e9, 3e38 and inf, 90,000 rays
    against the bench scene's 447 spheres, and 2,500 spheres (a table the
    kernel stages in tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from torch_brute_cases import tie_rays, tie_scene

    from rt_tpu_torch.scenes import bench_cover_config

    org, dirn, centers, radius = (torch.from_numpy(x).cuda() for x in _rays_and_spheres(1000, 37, 23))
    before = nearest_ops.LAUNCHES["sphere_nearest"]
    got = nearest_ops.sphere_nearest(org, dirn, centers, radius, T_MIN, T_MAX)
    assert nearest_ops.LAUNCHES["sphere_nearest"] == before + 1
    ref = nearest_ops.sphere_nearest_plain(org, dirn, centers, radius, T_MIN, T_MAX)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    rays = torch.zeros((8, 1024), device="cuda")
    rays[0:3, :1000], rays[3:6, :1000], rays[3:6, 1000:] = org.T, dirn.T, 1.0
    sph = torch.zeros((128, 4), device="cuda")
    sph[:37, 0:3], sph[:37, 3] = centers, radius
    got = nearest_ops.sphere_nearest_packed(rays, sph, T_MIN, T_MAX)
    ref = nearest_ops.sphere_nearest_packed_plain(rays, sph, T_MIN, T_MAX)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    scene, rays = tie_scene().to("cuda"), tie_rays().cuda()
    ns = scene.num_spheres
    for t_max in (1e9, 3.0e38, float("inf")):
        args = (rays[0:3].T, rays[3:6].T, scene.sph_center[:ns], scene.sph_radius[:ns], T_MIN, t_max)
        for got, ref in ((nearest_ops.sphere_nearest(*args), nearest_ops.sphere_nearest_plain(*args)),
                         (nearest_ops.sphere_nearest_packed(rays, scene.sph_packed, T_MIN, t_max),
                          nearest_ops.sphere_nearest_packed_plain(rays, scene.sph_packed, T_MIN,
                                                                  t_max))):
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), t_max
    bench = bench_cover_config()[0].to("cuda")
    ns = bench.num_spheres
    rs = np.random.default_rng(24)
    org = torch.from_numpy(rs.uniform((-8, -8, 0), (8, 8, 2), (90_000, 3)).astype(np.float32)).cuda()
    dirn = torch.from_numpy(rs.normal(size=(90_000, 3)).astype(np.float32)).cuda()
    args = (org, dirn, bench.sph_center[:ns], bench.sph_radius[:ns], T_MIN, 3.0e38)
    got, ref = nearest_ops.sphere_nearest(*args), nearest_ops.sphere_nearest_plain(*args)
    assert ns == 447 and torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert 0 < int((ref[1] >= 0).sum()) < 90_000
    # A table over the kernel's 1,024 shared-memory rows, with a tie across its tiles.
    org, dirn, centers, radius = _rays_and_spheres(5000, 2500, 25)
    radius *= 0.1
    centers[2000], radius[2000] = centers[7], radius[7]
    org[:500] = centers[7]  # from inside sphere 7 and its copy: both exits at one t
    args = (*(torch.from_numpy(x).cuda() for x in (org, dirn, centers, radius)), T_MIN, T_MAX)
    got, ref = nearest_ops.sphere_nearest(*args), nearest_ops.sphere_nearest_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert int((ref[1] == 7).sum()) >= 500 and int((ref[1] >= 1024).sum()) > 500
