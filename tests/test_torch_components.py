"""Port parity of the building blocks: RNG, Halton, color, camera, sky.

Inputs are drawn from seeded numpy generators and fed to the JAX package
and to rt_tpu_torch.  Tolerances:
- hash, uniform and Halton values are compared bit for bit: they feed
  branch decisions, so the port must reproduce them exactly;
- camera rays, sky radiance and color at atol 1e-6 and rtol 1e-6 (f32
  transcendentals differ by an ulp between XLA and PyTorch), except the
  sky under the cos-as-angle quirk at rtol 1e-5: there cos(gamma) feeds
  exp() in the Perez terms and the XYZ -> sRGB sums cancel, which turns one
  ulp of cos into up to ~1e-5 relative in the radiance.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import color as jcolor
from rt_tpu import rng as jrng
from rt_tpu import sampling as jsampling
from rt_tpu import scenes as jscenes
from rt_tpu import sky as jsky
from rt_tpu.config import CompatConfig as JCompat
from rt_tpu_torch import color, fast_shade, megakernel, rng, sampling, scenes, sky
from rt_tpu_torch.camera import generate_rays
from rt_tpu_torch.config import CompatConfig

torch.set_num_threads(2)

TOL = dict(atol=1e-6, rtol=1e-6)


def _u32(rs, n):
    return rs.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def test_hash_and_uniform_bit_exact():
    rs = np.random.default_rng(7)
    seed, a, b, c = (_u32(rs, 4096) for _ in range(4))
    t = lambda x: torch.from_numpy(x.astype(np.int64))
    ref_bits = np.asarray(jrng.hash_u32(seed, a, b, c)).astype(np.int64)
    np.testing.assert_array_equal(rng.hash_u32(t(seed), t(a), t(b), t(c)).numpy(), ref_bits)
    np.testing.assert_array_equal(rng.mix(t(a)).numpy(), np.asarray(jrng.mix(a)).astype(np.int64))
    for purpose in (3, 10, 21):
        ref = np.asarray(jrng.uniform(seed[0], a, b, purpose))
        got = rng.uniform(int(seed[0]), t(a), t(b), purpose).numpy()
        np.testing.assert_array_equal(got, ref)


def test_hash_accepts_signed_work_ids():
    """Work ids wrap as int32 in the JAX package and are hashed as their
    u32 pattern; negative ints must hash like that pattern."""
    ids = np.array([-1, -(2**31), 2**31 - 1, 0, 12345], np.int32)
    ref = np.asarray(jrng.uniform(3, jnp.asarray(ids), 2, 9))
    got = rng.uniform(3, torch.from_numpy(ids), 2, 9).numpy()
    np.testing.assert_array_equal(got, ref)


def test_unit_vector_and_disc_close():
    rs = np.random.default_rng(8)
    a = _u32(rs, 1024)
    t = torch.from_numpy(a.astype(np.int64))
    np.testing.assert_allclose(
        rng.unit_vector(5, t, 1, 2).numpy(), np.asarray(jrng.unit_vector(5, a, 1, 2)), **TOL
    )
    np.testing.assert_allclose(
        rng.in_unit_disc(5, t, 0, 7).numpy(), np.asarray(jrng.in_unit_disc(5, a, 0, 7)), **TOL
    )


def test_halton_pair_bit_exact_to_2_20():
    idx = np.arange(1 << 20, dtype=np.int32)
    ru, rv = jsampling.halton_pair(jnp.asarray(idx))
    gu, gv = sampling.halton_pair(torch.from_numpy(idx))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    big = np.array([2**31 - 2, 2**32 - 2, 123456789], np.uint32)
    np.testing.assert_array_equal(
        sampling.radical_inverse(3, torch.from_numpy(big.astype(np.int64))).numpy(),
        np.asarray(jsampling.radical_inverse(3, jnp.asarray(big))),
    )


def test_color_pipeline_close():
    x = np.random.default_rng(9).uniform(-0.5, 12.0, (64, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(color.linear_to_gamma(t).numpy(), np.asarray(jcolor.linear_to_gamma(x)), **TOL)
    np.testing.assert_allclose(color.uncharted2(t).numpy(), np.asarray(jcolor.uncharted2(x)), **TOL)
    u = np.random.default_rng(10).uniform(-0.1, 1.1, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        color.to_u8_gamma(torch.from_numpy(u)).numpy(), np.asarray(jcolor.to_u8_gamma(u))
    )


def _pixels(w, h, n, seed):
    rs = np.random.default_rng(seed)
    pix = rs.integers(0, w * h, n).astype(np.int32)
    sample = rs.integers(0, 4096, n).astype(np.int32)
    return pix, sample


@pytest.mark.parametrize("shared", [True, False])
def test_camera_rays_match_jax_camera(shared):
    """cam1 (no defocus) against rt_tpu.camera.Camera.generate_rays, with
    shared and per-pixel scrambled Halton jitter."""
    w, h = 48, 27
    pix, sample = _pixels(w, h, 500, 11)
    jcam, tcam = jscenes.cam1(w, h), scenes.cam1(w, h)
    for name in ("center", "pixel00_loc", "pixel_du", "pixel_dv"):
        np.testing.assert_allclose(getattr(tcam, name).numpy(), np.asarray(getattr(jcam, name)), **TOL)
    key = jax.random.key(5)
    ref_o, ref_d = jcam.generate_rays(
        jnp.asarray(pix % w), jnp.asarray(pix // w), jnp.asarray(sample), key,
        JCompat(shared_halton_jitter=shared),
    )
    o, d, _ = generate_rays(
        tcam, torch.from_numpy(pix), torch.from_numpy(sample), 5,
        CompatConfig(shared_halton_jitter=shared),
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), **TOL)


def test_camera_rays_defocus_match_hash_disc():
    """cam2 with defocus: the thin-lens disc drawn from the counter hash on
    gwork (purposes 21/22), as rt_tpu.wavefront's camera_rays draws it."""
    w, h = 40, 30
    pix, sample = _pixels(w, h, 500, 12)
    jcam, tcam = jscenes.cam2(w, h), scenes.cam2(w, h)
    assert tcam.defocus_on
    seed = 9
    gwork = jnp.asarray(sample) * (w * h) + jnp.asarray(pix)
    off_u, off_v = jsampling.halton_pair(jnp.asarray(sample))
    fx = jnp.asarray(pix % w).astype(jnp.float32) + off_u
    fy = jnp.asarray(pix // w).astype(jnp.float32) + off_v
    target = jcam.pixel00_loc[None] + fx[:, None] * jcam.pixel_du[None] + fy[:, None] * jcam.pixel_dv[None]
    disk = jrng.in_unit_disc(seed, gwork, 0, 7)
    ref_o = jcam.center[None] + disk[:, 0:1] * jcam.defocus_disk_u[None] + disk[:, 1:2] * jcam.defocus_disk_v[None]
    o, d, g = generate_rays(tcam, torch.from_numpy(pix), torch.from_numpy(sample), seed)
    np.testing.assert_array_equal(g.numpy(), np.asarray(gwork).astype(np.uint32).astype(np.int64))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(target - ref_o), atol=1e-5, rtol=1e-6)


def _directions(n, seed):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


SKIES = {  # name: (JAX sky, port sky, quirk override, tolerance)
    "perez": (jsky.SkyParams.default, sky.SkyParams.default, False, TOL),
    "perez_quirk": (jsky.SkyParams.default, sky.SkyParams.default, True, dict(atol=1e-6, rtol=1e-5)),
    "hosek_reference": (jsky.SkyParams.hosek_reference, sky.SkyParams.hosek_reference, None, TOL),
}


@pytest.mark.parametrize("name", list(SKIES))
def test_sky_color_toward_close(name):
    jfn, tfn, quirk, tol = SKIES[name]
    jp, tp = jfn(), tfn()
    if quirk is not None:
        jp, tp = jp.replace(cos_gamma_as_angle=quirk), tp.replace(cos_gamma_as_angle=quirk)
    dirs = _directions(512, 13)
    ref = np.asarray(jsky.sky_color_toward(jp, jnp.asarray(dirs)))
    got = sky.sky_color_toward(tp, torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, ref, **tol)
    # The megakernel's per-frame scalars give the same sky, up to the
    # kernel's folding of the zenith normalization into one factor.
    rows = megakernel._mega_sky_rows(sky.frame_scalars(tp), *torch.from_numpy(dirs).T)
    np.testing.assert_allclose(torch.stack(rows, 1).numpy(), ref, atol=1e-5, rtol=1e-5)
    # So does the gradient path's sky on the live SkyParams tensors.
    rows = fast_shade._sky_rows(tp, *torch.from_numpy(dirs).T)
    np.testing.assert_allclose(torch.stack(rows, 1).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_kernel_params_match_jax_prep():
    """The CUDA kernel's per-frame float block against the JAX megakernel's
    packed scalars (rt_tpu.megakernel._mega_prep): camera, sun, Perez rows
    and zenith factors, and the Hosek rows."""
    from rt_tpu.megakernel import _P_HW, _P_ZYC, _mega_prep
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.megakernel import kernel_params

    for jfn, tfn in ((jsky.SkyParams.default, sky.SkyParams.default),
                     (jsky.SkyParams.hosek_reference, sky.SkyParams.hosek_reference)):
        jp, tp = jfn(), tfn()
        model = "hosek" if jp.hw_params is not None else "perez"
        pf_ref, _, _ = _mega_prep(
            jnp.zeros((40, 128), jnp.float32), None, jscenes.cam2(8, 6), jp,
            has_images=False, sky_model=model,
        )
        pf_ref = np.asarray(pf_ref)[0]
        pf = kernel_params(SimpleNamespace(sky=tp), scenes.cam2(8, 6), RenderConfig(), 1)
        np.testing.assert_allclose(pf[: _P_ZYC + 1], pf_ref[: _P_ZYC + 1], **TOL)
        np.testing.assert_array_equal(pf[_P_HW : _P_HW + 30], pf_ref[_P_HW : _P_HW + 30])
