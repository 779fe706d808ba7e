"""The orders of K6's reduce and gather kernels (csrc/micro_probe.cu
``reduce_kernel``, ``gather_kernel``), proved on the CPU with the models
of tests/torch_micro_cases.py, as tests/test_torch_brute_order.py proves
K1-K3's.

Reduce: the kernel's scheme (per-block tables filled by two phases of
32-bit atomics, the least key then the first item that holds it, merged
per ray and taken only below the ray's state) equals the TPU body's loop
item by item, bit for bit, for 1, 2, 4 and 8 blocks: on keys drawn from
0-39 (many ties), initial planes from 0-49 (ties against the initial
value), rays outside [0, 1024), n 512, 1,024 and 8,192 and reps 1-3.

Gather: the kernel's root taken only where disc >= 0 and rad > 0 (every
other pair's key is bits(3e38) & ~127 | lane) and its lane-owner minimum
(a thread's least key per item over its lanes, the warp's, then the
visit's) equal ``gather_plain`` bit for bit in all five modes, for 1, 2
and 4 slot lanes a thread, on slot blocks
with negative and zero radii, centres off every ray, spheres behind the
origin and around it.  Exact: every model runs the same f32 operations in
the same order as the code it models.  And the parity phase's gather checks
repeat bit for bit on the CPU at one thread and at the machine's count.
Serial CPU time of this file: ~9 s.
"""

import os

import numpy as np
import pytest
import torch

from rt_tpu_torch import micro_probe as mp
from torch_micro_cases import (gather_hard_inputs, gather_lanes, gather_pairs,
                               gather_plain_repeats, reduce_sequential, reduce_tables,
                               tie_reduce_inputs)

torch.set_num_threads(2)


def _equal(got, ref) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.fixture(scope="module")
def ties():
    return tie_reduce_inputs(1)


@pytest.mark.parametrize("n", [512, 1024, mp.NI])
@pytest.mark.parametrize("reps", [1, 2, 3])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_reduce_tables_keep_the_loop_order(ties, n, reps, cluster):
    rid, key, best, bi = ties
    ref = reduce_sequential(rid, key, reps, n, best=best, bi=bi)
    assert _equal(reduce_tables(rid, key, reps, n, cluster=cluster, best=best, bi=bi), ref)
    assert _equal(mp.reduce(rid, key, reps, n, best=best, bi=bi), ref)  # the plain version


def test_reduce_ties_cover_every_rule(ties):
    """The tie inputs exercise each rule: a tie with the initial value kept,
    a later equal key losing to an earlier one, and skipped rays."""
    rid, key, best, bi = ties
    r, k = rid.reshape(-1).tolist(), key.reshape(-1).tolist()
    b0 = best.reshape(-1).tolist()
    assert any(not 0 <= x < mp.R for x in r)
    assert any(0 <= x < mp.R and y == b0[x] for x, y in zip(r, k))  # ties the initial value
    first = {}
    repeats = 0
    for x, y in zip(r, k):
        if 0 <= x < mp.R:
            repeats += (x, y) in first
            first.setdefault((x, y), True)
    assert repeats > 100
    _, b, i = reduce_sequential(rid, key, 1, mp.NI, best=best, bi=bi)
    kept = (b.reshape(-1) == best.reshape(-1)) & (i.reshape(-1) == bi.reshape(-1))
    assert 0 < int(kept.sum()) < mp.R


@pytest.mark.parametrize("cluster", [1, 8])
def test_reduce_tables_from_the_default_planes(cluster):
    rs = np.random.default_rng(4)
    rid = torch.from_numpy(rs.integers(0, mp.R, (1, mp.NI)).astype(np.int32))
    key = torch.from_numpy(rs.integers(0, 1 << 30, (1, mp.NI)).astype(np.int32))
    ref = reduce_sequential(rid, key, 3, mp.NI)
    assert _equal(reduce_tables(rid, key, 3, mp.NI, cluster=cluster), ref)


@pytest.fixture(scope="module")
def hard():
    return gather_hard_inputs(3)


def test_gather_inputs_hold_every_kind_of_pair(hard):
    """The slot blocks give marked and unmarked pairs of each kind: rad <= 0,
    disc < 0, both roots below 1e-3, and the far root."""
    h, disc, inv_a, rad = gather_pairs(*hard[:4], mp.NV)
    marked = (disc >= 0) & (rad > 0)
    sd = torch.sqrt(torch.clamp(disc, min=0))
    t0, t1 = (h - sd) * inv_a, (h + sd) * inv_a
    assert bool(((rad <= 0) & (disc >= 0)).any()) and bool((disc < 0).any())
    assert bool((marked & (t1 < 1e-3)).any())  # behind the origin
    assert bool((marked & (t0 < 1e-3) & (t1 >= 1e-3)).any())  # around it: the far root
    assert 0.02 < float(marked.float().mean()) < 0.5


@pytest.mark.parametrize("mode", mp.MODES)
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_gather_admitted_roots_keep_the_plain_keys(hard, mode, lanes):
    rays_t, slots, item, vcl, res0 = hard
    for reps, nv in ((1, 64), (3, mp.NV)):
        args = (rays_t, slots, item, vcl, reps, nv)
        got = gather_lanes(*args, mode=mode, lanes=lanes, res=res0)
        assert _equal(got, mp.gather_plain(*args, mode=mode, res=res0))
        assert not torch.equal(got[1], res0)


@pytest.mark.parametrize("threads", ["one", "all"])
def test_gather_plain_repeats_bit_identical(threads):
    """The parity phase's gather checks on the CPU (the plain version
    against itself), at one thread and at the machine's count."""
    assert gather_plain_repeats(1, 1 if threads == "one" else os.cpu_count() or 1) == []


def test_gather_admitted_roots_on_the_probe_inputs():
    g = mp.inputs("gather", "cpu")["gather"]
    args = (g["rays_t"], g["slots"], g["item"], g["vcl"], 2, mp.NV)
    assert _equal(gather_lanes(*args), mp.gather_plain(*args))


@pytest.mark.cuda
def test_cuda_reduce_and_gather_keep_the_models():
    """On the card: the kernels on the tie inputs and the hard slot blocks,
    bit for bit against the loop and the plain gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ (csrc/micro_probe.cu)")
    rid, key, best, bi = tie_reduce_inputs(1)
    hard = gather_hard_inputs(3)
    cuda = lambda xs: [x.cuda() for x in xs]
    for reps in (1, 2, 3):
        for n in (512, mp.NI):
            got = mp.reduce(*cuda((rid, key)), reps, n, best=best.cuda(), bi=bi.cuda())
            ref = reduce_sequential(rid, key, reps, n, best=best, bi=bi)
            assert _equal([x.cpu() for x in got], ref)
        for mode in mp.MODES:
            args = (*cuda(hard[:4]), reps, mp.NV)
            got = mp.gather(*args, mode=mode, res=hard[4].cuda())
            assert _equal(got, mp.gather_plain(*args, mode=mode, res=hard[4].cuda()))
