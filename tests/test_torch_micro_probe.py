"""K6, the microbenchmark bodies (rt_tpu_torch.micro_probe), against the
TPU bodies of tools/micro_probe.py in Pallas interpret mode.

The TPU bodies leave their result in scratch that they never initialize,
so each is wrapped here in a kernel that writes the same initial planes
into the scratch, calls the body, and copies the scratch to extra outputs.
Inputs come from numpy generators with fixed seeds.  Tolerances:
- reduce: exact (integer state, int32 accumulator);
- gather "nomath": exact (bit patterns and wrapping int32 adds);
- gather "full", "nogather", "noslot", "unaligned": the winning lane of
  every row equal, and t decoded from ``key & ~127`` within rtol 2e-4.
  XLA:CPU may fuse the interpret-mode body's products into FMAs (the port
  rounds every product), which moves h*h - a*c by up to ~6e-5 relative;
  where the ray starts near or inside the sphere, h - sqrt(disc) cancels
  and carries that into t (measured: at most 1.1e-4, with 86-92% of the
  keys equal bit for bit; the test prints the share and asserts 75%);
- scatter: atol 1e-4 on the scratch and on the plane (f32 sums in another
  order than the interpret-mode dot's).
test_torch_walk_probe_cuda.py holds the kernels against the plain versions
on the card.

The scatter kernel's order of f32 adds is proved here on the CPU with the
two models of tests/torch_micro_cases.py: the kernel's masks, filled by
one scan of the destinations, then ordered sums, equal bit for bit the
parent loop that tests every destination against each column, on
destinations repeated across k and across s, chunks past the last column
block, nvrows 1, 2 and 8 and ch 512 and 2048; and within the card's limits
(1e-5 of max|scr|, and of the |scr| terms of the plane) of
``scatter_plain``'s matrix products.  Serial CPU time of this file: ~17 s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rt_tpu_torch import micro_probe as mp
from tools import micro_probe as tmp
from torch_micro_cases import repeated_dst, scatter_masked, scatter_sequential

torch.set_num_threads(2)
MODES = mp.MODES


def _spec(x):
    small_int = x.dtype == jnp.int32 and x.ndim == 2 and x.shape[0] == 1
    return pl.BlockSpec(memory_space=pltpu.SMEM if small_int else pltpu.VMEM)


def _call(body, inputs, inits, scratch):
    """Run ``body(ctl, *inputs, out, *scratch)`` in interpret mode with the
    scratch set to ``inits`` first; returns (out, *final scratch)."""
    n_in, n_s = 1 + len(inputs), len(scratch)

    def kernel(*refs):
        ins, init_refs = refs[:n_in], refs[n_in : n_in + n_s]
        out, outs, scr = refs[n_in + n_s], refs[n_in + n_s + 1 : n_in + 2 * n_s + 1], refs[-n_s:]
        for s, i in zip(scr, init_refs):
            s[...] = i[...]
        body(*ins, out, *scr)
        for o, s in zip(outs, scr):
            o[...] = s[...]

    def run(ctl):
        args = [ctl, *inputs, *inits]
        return pl.pallas_call(
            kernel,
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [_spec(x) for x in args[1:]],
            out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * (1 + n_s),
            out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32)]
            + [jax.ShapeDtypeStruct(i.shape, i.dtype) for i in inits],
            scratch_shapes=scratch,
            interpret=True,
        )(*args)

    return run


def _np(x):
    return np.asarray(x)


# -- reduce -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduce_case():
    rs = np.random.default_rng(11)
    n = 512
    rid = rs.integers(-3, mp.R, (1, mp.NI)).astype(np.int32)  # a few negative rays
    key = rs.integers(0, 40, (1, mp.NI)).astype(np.int32)  # many ties
    best = rs.integers(0, 50, (8, 128)).astype(np.int32)
    bi = rs.integers(-5, 5, (8, 128)).astype(np.int32)
    run = _call(functools.partial(tmp.reduce_kernel, unroll=8),
                [jnp.asarray(rid), jnp.asarray(key)], [jnp.asarray(best), jnp.asarray(bi)],
                [pltpu.SMEM((8, 128), jnp.int32)] * 2)
    ref = {reps: [_np(x) for x in run(jnp.asarray([[reps, n]], jnp.int32))] for reps in (1, 3)}
    return n, rid, key, best, bi, ref


@pytest.mark.parametrize("reps", [1, 3])
def test_reduce_matches_the_tpu_body(reduce_case, reps):
    n, rid, key, best, bi, ref = reduce_case
    out, b, i = mp.reduce(torch.from_numpy(rid), torch.from_numpy(key), reps, n,
                          best=torch.from_numpy(best), bi=torch.from_numpy(bi))
    np.testing.assert_array_equal(b.numpy(), ref[reps][1])
    np.testing.assert_array_equal(i.numpy(), ref[reps][2])
    np.testing.assert_array_equal(out.numpy(), ref[reps][0])
    assert (b.numpy() != best).any() and (ref[reps][0] != 0).all()


def test_reduce_default_state_is_a_sequential_loop():
    rs = np.random.default_rng(3)
    rid = rs.integers(0, mp.R, (1, 4096)).astype(np.int32)
    key = rs.integers(0, 1 << 30, (1, 4096)).astype(np.int32)
    out, best, bi = mp.reduce(torch.from_numpy(rid), torch.from_numpy(key), 2, 4096)
    want_b = np.full(mp.R, mp.INT32_MAX, np.int64)
    want_i = np.full(mp.R, -1, np.int64)
    for j, (r, k) in enumerate(zip(rid[0], key[0])):
        if k < want_b[r]:
            want_b[r], want_i[r] = k, j
    np.testing.assert_array_equal(best.numpy().ravel(), want_b)
    np.testing.assert_array_equal(bi.numpy().ravel(), want_i)
    acc = np.int32((want_b[0] + want_b[129] + 2**31) % 2**32 - 2**31)  # rr = 0, 1, wrapped
    assert (out.numpy() == np.float32(acc)).all()


# -- gather -----------------------------------------------------------------------

GATHER_NV, GATHER_NCL = 64, 24


@pytest.fixture(scope="module")
def gather_case():
    rs = np.random.default_rng(12)
    f32 = lambda *s: rs.standard_normal(s).astype(np.float32)
    rays_t = f32(mp.R, 8)
    rays_t[:, 3:6] *= 0.3  # some rays reach their spheres
    slots = f32(8, GATHER_NCL * 128)
    slots[3] = np.abs(slots[3]) + 0.2  # radii, a few zero below
    slots[3, ::17] = 0.0
    item = rs.integers(-2, mp.R + 2, (1, mp.NI)).astype(np.int32)  # out-of-range ids clamp
    vcl = rs.integers(0, GATHER_NCL + 3, (1, mp.NV)).astype(np.int32)
    res0 = rs.integers(-9, 9, (mp.NI, 1)).astype(np.int32)
    ref = {}
    for mode in MODES:
        run = _call(functools.partial(tmp.gather_kernel, unroll=4, mode=mode),
                    [jnp.asarray(x) for x in (rays_t, slots, np.maximum(np.minimum(item, mp.R - 1), 0), vcl)],
                    [jnp.asarray(res0)], [pltpu.VMEM((mp.NI, 1), jnp.int32)])
        out, res = run(jnp.asarray([[2, GATHER_NV]], jnp.int32))
        ref[mode] = (_np(out), _np(res)[:, 0])
    return rays_t, slots, item, vcl, res0, ref


def _decode_t(keys):
    return (keys & ~127).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_gather_matches_the_tpu_body(gather_case, mode):
    rays_t, slots, item, vcl, res0, ref = gather_case
    t = lambda x: torch.from_numpy(x)
    out, res = mp.gather(t(rays_t), t(slots), t(item), t(vcl), 2, GATHER_NV, mode=mode,
                         res=t(res0[:, 0]))
    ref_out, ref_res = ref[mode]
    got = res.numpy()
    written = got != res0[:, 0]
    assert written.sum() > GATHER_NV * 6
    if mode == "nomath":
        np.testing.assert_array_equal(got, ref_res)
        np.testing.assert_array_equal(out.numpy(), ref_out)
        return
    same = got == ref_res
    share = float(same[written].mean())
    print(f"gather[{mode}]: {share:.4%} of the written rows equal")
    assert share >= 0.75
    np.testing.assert_array_equal(got & 127, ref_res & 127)
    np.testing.assert_allclose(_decode_t(got[written]), _decode_t(ref_res[written]), rtol=2e-4)
    if same[:8].all():
        np.testing.assert_array_equal(out.numpy(), ref_out)


def test_unaligned_overlaps_keep_the_last_visit(gather_case):
    rays_t, slots, item, vcl, _, _ = gather_case
    t = lambda x: torch.from_numpy(x)
    _, res = mp.gather(t(rays_t), t(slots), t(item), t(vcl), 1, 16, mode="unaligned")
    _, aligned = mp.gather(t(rays_t), t(slots), t(item), t(vcl), 1, 16, mode="full")
    # Visit 1 starts at row 7 and overwrites visit 0's last row.
    assert res[7] == aligned[8] and res[6] == aligned[6] and res[14] == aligned[16]


# -- scatter --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scatter_case():
    rs = np.random.default_rng(13)
    vals = rs.standard_normal((64, 128)).astype(np.float32)
    dst = rs.integers(0, 2048, (32, 128)).astype(np.int32)
    dst[1] = dst[0]  # a destination named twice counts once
    scr0 = rs.standard_normal((8, mp.NI)).astype(np.float32)
    run = _call(functools.partial(tmp.scatter_kernel, nvrows=8, kk=4, ch=512),
                [jnp.asarray(vals), jnp.asarray(dst)], [jnp.asarray(scr0)],
                [pltpu.VMEM((8, mp.NI), jnp.float32)])
    out, scr = run(jnp.asarray([[3, 4]], jnp.int32))
    return vals, dst, scr0, (_np(out), _np(scr))


def test_scatter_matches_the_tpu_body(scatter_case):
    vals, dst, scr0, (ref_out, ref_scr) = scatter_case
    out, scr = mp.scatter(torch.from_numpy(vals), torch.from_numpy(dst), 3, 4,
                          scr=torch.from_numpy(scr0))
    np.testing.assert_allclose(scr.numpy(), ref_scr, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(scr.numpy()[:, 2048:], scr0[:, 2048:])  # untouched columns


def test_scatter_past_the_last_block_keeps_the_last_chunk():
    rs = np.random.default_rng(5)
    vals = torch.from_numpy(rs.standard_normal((16, 128)).astype(np.float32))
    dst = torch.from_numpy(rs.integers(0, mp.NI + 1024, (8, 128)).astype(np.int32))
    _, scr = mp.scatter(vals, dst, 1, 5, nvrows=2, kk=1, ch=2048)
    _, last = mp.scatter_plain(vals, dst - 2048, 1, 4, nvrows=2, kk=1, ch=2048)
    torch.testing.assert_close(scr[:, 6144:], last[:, 6144:], rtol=0, atol=0)


@pytest.mark.parametrize("nvrows, kk, ch, n_chunks", [(8, 4, 512, 16), (8, 4, 512, 18),
                                                   (2, 2, 2048, 4), (2, 1, 2048, 5),
                                                   (1, 3, 512, 20)])
def test_scatter_masks_keep_the_column_loop_order(nvrows, kk, ch, n_chunks):
    """The kernel's masks-then-ordered-sums equal the loop over every
    destination per column bit for bit (scr and the plane), from a random
    initial scr, and stay within the card's limits of the plain version."""
    rs = np.random.default_rng(20 + nvrows + kk)
    vals = torch.from_numpy(rs.standard_normal((8 * nvrows, 128)).astype(np.float32))
    dst = repeated_dst(kk, 30 + kk, high=mp.NI + 512)  # some land past every column
    scr0 = torch.from_numpy(rs.standard_normal((nvrows, mp.NI)).astype(np.float32))
    args = (vals, dst, 3, n_chunks)
    kw = dict(nvrows=nvrows, kk=kk, ch=ch, scr=scr0)
    got, seq = scatter_masked(*args, **kw), scatter_sequential(*args, **kw)
    assert torch.equal(got[1], seq[1]) and torch.equal(got[0], seq[0])
    out, scr = got
    p_out, p_scr = mp.scatter_plain(*args, **kw)
    rows = p_scr[0, :1024].abs().reshape(8, 128).sum(dim=1)
    terms = sum(float(rows[rr & 7]) for rr in range(3))
    assert float((scr - p_scr).abs().max()) <= 1e-5 * float(p_scr.abs().max())
    assert float((out - p_out).abs().max()) <= 1e-5 * terms
    written = min(n_chunks, mp.NI // ch) * ch
    assert not torch.equal(scr[:, :written], scr0[:, :written])
    assert torch.equal(scr[:, written:], scr0[:, written:])
    if n_chunks > mp.NI // ch:  # the last block holds the last chunk
        last = scatter_sequential(vals, dst - (n_chunks - mp.NI // ch) * ch, 3, mp.NI // ch,
                                  nvrows=nvrows, kk=kk, ch=ch, scr=scr0)[1]
        assert torch.equal(scr[:, mp.NI - ch :], last[:, mp.NI - ch :])


def test_repeated_destinations_count_once():
    """A lane that names a column under several k, or in several lanes
    of one s, adds each lane's value once."""
    vals = torch.ones((8, 128))
    dst = repeated_dst(4, 7)
    col = int(dst[3 * 4, 40])
    _, scr = scatter_masked(vals, dst, 1, mp.NI // 512, nvrows=1, kk=4, ch=512)
    named = {(s, lane) for s in range(8) for k in range(4) for lane in range(128)
             if int(dst[s * 4 + k, lane]) == col}
    assert {(3, lane) for lane in range(40, 48)} <= named
    assert float(scr[0, col]) == len(named)


# -- checks -------------------------------------------------------------------------


@pytest.mark.parametrize("body", ["reduce", "gather"])
def test_n_not_a_multiple_of_unroll_raises(body):
    z = torch.zeros((1, mp.NI), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of unroll"):
        if body == "reduce":
            mp.reduce(z, z, 1, 100, unroll=8)
        else:
            mp.gather(torch.zeros((mp.R, 8)), torch.zeros((8, 128)), z, z[:, : mp.NV], 1, 30)


def test_probe_cli_runs_the_plain_versions(capsys):
    res = mp.main(["scatter", "--device", "cpu", "--r1", "1", "--r2", "2"])
    assert set(res) == {"scatter"} and res["scatter"]["n"] == 16
    assert "ns/unit over n=16" in capsys.readouterr().out


def test_probe_inputs_follow_the_tpu_probe():
    rng = np.random.default_rng(0)
    rid = rng.integers(0, mp.R, (1, mp.NI))
    data = mp.inputs("all", "cpu")
    np.testing.assert_array_equal(data["reduce"]["rid"].numpy(), rid)
    assert set(data) == {"reduce", "gather", "scatter"}
    assert data["gather"]["slots"].shape == (8, mp.N_CL * 128)
    alone = mp.inputs("gather", "cpu")["gather"]["rays_t"]
    assert not torch.equal(alone, data["gather"]["rays_t"])  # drawn first when alone
