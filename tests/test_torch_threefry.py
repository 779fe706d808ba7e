"""``jax.random``'s threefry stream in the port (rt_tpu_torch.rng) and the
draws built on it (sampling.random_unit / random_in_unit_disc, the
defocused ``camera.generate_rays_keyed``), against JAX 0.9's defaults
(partitionable threefry) on the CPU.

Tolerances: ``random_bits``, ``random_uniform`` and ``split`` bit for bit
on >= 1e5 draws per key and shape, at the bounds the renderers draw with
((0, 1), (-1, 1), (0, 2 pi)).  XLA:CPU fuses uniform's f * (hi - lo) + lo
into one FMA; at those bounds the product or the sum is exact, so one
rounding or two give the same bits.  At other bounds the port rounds twice
and the two may differ by an ulp of the product (2.4e-7 below 4), which
the last uniform test allows.  ``random_unit`` within 2.5e-7 absolute (two
ulps of 1; XLA fuses the norm's squares into FMAs); the disc and the
defocused rays within 1e-6 absolute (origins) and 1e-5
(directions, up to 8 units long), since torch's and XLA's cos and sin may
differ in the last place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import sampling as jsampling
from rt_tpu import scenes as jscenes
from rt_tpu.config import CompatConfig as JCompat
from rt_tpu_torch import convert, rng, sampling, scenes
from rt_tpu_torch.camera import generate_rays_keyed
from rt_tpu_torch.config import CompatConfig

torch.set_num_threads(2)
SEEDS = [0, 7, 2**31 - 1, 2**32 - 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_bit_exact(seed):
    k = jax.random.key(seed)
    want = np.asarray(jax.random.bits(k, (100_003,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(rng.random_bits(rng.key(seed), 100_003).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((100_000,), 0.0, 1.0), ((40_000, 3), -1.0, 1.0),
                                         ((100_000,), 0.0, 2.0 * np.pi), ((317, 331), 0.0, 1.0)])
def test_random_uniform_bit_exact(seed, shape, lo, hi):
    k = jax.random.fold_in(jax.random.key(seed), 0x52)
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi))
    got = rng.random_uniform(rng.fold_in(rng.key(seed), 0x52), shape, lo, hi).numpy()
    assert got.shape == shape
    np.testing.assert_array_equal(got, want)
    assert (got >= np.float32(lo)).all() and (got < np.float32(hi)).all()


def test_random_uniform_other_bounds_within_an_ulp():
    k = jax.random.key(5)
    want = np.asarray(jax.random.uniform(k, (100_000,), jnp.float32, -2.5, 0.75))
    got = rng.random_uniform(rng.key(5), (100_000,), -2.5, 0.75).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=float(np.spacing(np.float32(3.25))))
    assert (got == want).mean() > 0.5


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 5])
def test_split_bit_exact(seed, n):
    want = [np.asarray(jax.random.key_data(x)) for x in jax.random.split(jax.random.key(seed), n)]
    got = rng.split(rng.key(seed), n)
    assert len(got) == n and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("seed", [0, 3])
def test_random_unit_and_disc(seed):
    jk, tk = jax.random.fold_in(jax.random.key(seed), 1), rng.fold_in(rng.key(seed), 1)
    want = np.asarray(jsampling.random_unit(jk, (50_000,)))
    np.testing.assert_allclose(sampling.random_unit(tk, 50_000).numpy(), want, rtol=0, atol=2.5e-7)
    want = np.asarray(jsampling.random_in_unit_disc(jk, (50_000,)))
    got = sampling.random_in_unit_disc(tk, 50_000).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (np.linalg.norm(got, axis=-1) <= 1.0 + 1e-6).all() and (got[:, 2] == 0).all()


@pytest.mark.parametrize("scrambled", [False, True])
def test_defocused_generate_rays_keyed(scrambled):
    jcam = jscenes.cam2(40, 24)
    tcam = convert.camera_from_arrays(jax.tree.map(np.asarray, jcam))
    assert tcam.defocus_on and torch.equal(tcam.center, scenes.cam2(40, 24).center)
    rs = np.random.default_rng(4)
    px, py = rs.integers(0, 40, 2000), rs.integers(0, 24, 2000)
    sample = rs.integers(0, 64, 2000)
    key = jax.random.fold_in(jax.random.key(9), 0xCA0)
    o_ref, d_ref = jcam.generate_rays(jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32),
                                      jnp.asarray(sample, jnp.int32), key,
                                      JCompat(shared_halton_jitter=not scrambled))
    o, d = generate_rays_keyed(tcam, torch.from_numpy(px), torch.from_numpy(py),
                               torch.from_numpy(sample), rng.fold_in(rng.key(9), 0xCA0),
                               CompatConfig(shared_halton_jitter=not scrambled))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=1e-5)
    spread = o.numpy() - tcam.center.numpy()
    assert np.abs(spread).max() > 1e-3  # the lens moved the origins
