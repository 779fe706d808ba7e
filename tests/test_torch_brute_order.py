"""The orders of the brute-force kernels K3/K3b and K1, proved on the CPU.

K3/K3b (csrc/prim_nearest.cu) give each ray a group of ``G`` lanes: lane g
tests sphere rows g, g + G, ... and then triangle rows g, g + G, ..., with
a strict ``<`` scan from (BIG, -1), and the group's winner is the least
packed key (order(t), id) of an xor-shuffle reduction, the winning t
travelling with its key; a lane without a hit holds the key ~0.  A lane
takes its sphere rows in batches of 32 (csrc/brute_force.cuh
``sphere_batch``): the discriminants of the batch first, then the full test
of the rows they admit, in ascending order.
``group_nearest`` below is a plain-PyTorch model of exactly that,
vectorized over rays, built on the per-pair tests of the plain versions.
The tests hold it against ``prim_ops.prim_nearest_packed_plain`` (the
sequential scan the kernel was held against before), t and ids bit for
bit, with culling on and off, on the tie scene of tests/torch_brute_cases.py: spheres repeated
at later ids, in the same lane and in other lanes; a sphere and a triangle
that a ray meets at exactly equal t (the sphere at (x, y, 2) with radius 1
and a triangle in z = 1, for a ray up the z axis from (x, y, 0): t = 1 on
both); rays whose near root falls below t_min; and misses.

K2/K2b (csrc/nearest.cu) search the spheres alone in the same order, with
``K2_G`` lanes a ray, and read ray i's component k at base[i * ray_step +
k * comp_step] of each of the origins and directions, with the steps the
wrapper hands the kernel (``stride(0)``, ``stride(1)`` of K2's [N,3] views,
and of K2b's rows [0:3] and [3:6] of [8,N] transposed).  The tests read
the tie scene's rays that way and hold ``group_nearest`` with an empty
triangle table against ``sphere_nearest_plain`` and
``sphere_nearest_packed_plain``, bit for bit.

K1 (csrc/megakernel.cu) renders every sample of a launch at once: items
k = i * spp + s, claimed pixel-major by warps, write their radiance to a
ring of P pixel slots (``megakernel.ring_slots``).  Pixel i takes the slot
at place i of a queue of P cells, which the (i - P)-th pixel summed put
there; the lane that counts a pixel's last sample sums the slot in sample
order and hands it on.  ``ring_model`` below is a plain-PyTorch model of
that protocol, step by step: warps of lanes that claim, run each path for
a number of steps set by a completion policy (seeded random, or
adversarial), wait for their pixel's slot, store, count, sum and hand the
slot on.  The tests check that it gives ``render_megakernel_plain``'s
image bit for bit from ``trace_paths``' per-sample radiance, with caps that
send each slot round the queue many times; that it never stalls with one
or two slots under adversarial completion orders; and that P keeps the
scratch within the cap and the 64-bit item numbers decode past 2**31.

The kernels themselves are held against the plain versions on the card
(tests/test_torch_prim.py, tests/test_torch_megakernel.py, chip_smoke.py),
on this tie scene too.  Serial CPU time of this file: ~12 s.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import megakernel, prim_ops
from rt_tpu_torch.camera import generate_rays, make_camera
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.nearest_ops import (BIG, sphere_nearest_packed_plain, sphere_nearest_plain,
                                      _pack_spheres)
from rt_tpu_torch.scene import SceneBuilder
from rt_tpu_torch.sky import frame_scalars
from test_torch_walk_order import order_key  # the kernels' order(t), modelled
from torch_brute_cases import SPOTS, admitted, tie_rays, tie_scene  # tests/torch_brute_cases.py

torch.set_num_threads(2)

G = 8  # lanes a ray (csrc/prim_nearest.cu kGroup)
K2_G = 8  # lanes a ray of K2/K2b (csrc/nearest.cu kGroup)
NO_KEY = (1 << 63) - 1  # the key ~0 of a lane without a hit, shifted into int64
T_MIN = 1e-3


# -- the model ------------------------------------------------------------------


def packed_key(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """(order(t) << 32) | id as int64, less 1 << 63 so that it orders as the
    kernel's unsigned 64-bit key does."""
    return (order_key(t) - (1 << 31)) * (1 << 32) + i.to(torch.int64)


def pair_hits(rays, sph, tri, t_min, t_max, cull):
    """Every (row, ray) pair's t f32[R, N] and whether it is a hit, spheres
    then triangles, from the plain versions' own pair tests."""
    ts, hits = [], []
    for j in range(sph.shape[0]):
        t, i = sphere_nearest_packed_plain(rays, sph[j : j + 1], t_min, t_max)
        ts.append(t)
        hits.append(i >= 0)
    for j in range(tri.shape[0]):
        t, i = prim_ops._triangle_nearest_plain(rays, tri[j : j + 1], t_min, t_max, cull)
        ts.append(t)
        hits.append(i >= 0)
    return torch.stack(ts), torch.stack(hits)


def group_nearest(rays, sph, tri, n_spheres: int, t_min: float, t_max: float, cull: bool,
                  stats: dict | None = None, g_lanes: int = G):
    """K3b's order, with ``g_lanes`` lanes a ray, for every ray of ``rays``
    f32[>=6, N] over the packed tables: (t f32[N], id int32[N]); with an
    empty triangle table and K2's lanes, K2's order.  ``stats`` counts the
    equal-t decisions it makes ("lane_ties": rays whose least t two lanes
    hold; "kind_ties": rays whose nearest sphere and nearest triangle are
    at equal t)."""
    stats = {} if stats is None else stats
    t_all, hit_all = pair_hits(rays, sph, tri, t_min, t_max, cull)
    s_rows = sph.shape[0]
    # The second pass visits only the rows the first admits: no other row
    # is a hit, so a lane's scan over them is its scan over all its rows.
    marked = torch.cat([admitted(rays, sph), torch.ones_like(hit_all[s_rows:])])
    assert not (hit_all & ~marked).any()
    stats["admitted"] = stats.get("admitted", 0) + int(marked[:s_rows].sum())
    ids = torch.cat([torch.arange(s_rows), n_spheres + torch.arange(tri.shape[0])])
    rows = torch.cat([torch.arange(s_rows), torch.arange(tri.shape[0])])
    n = rays.shape[1]
    lane_t = torch.full((g_lanes, n), BIG)
    lane_i = torch.full((g_lanes, n), -1, dtype=torch.int32)
    for g in range(g_lanes):
        for r in torch.nonzero(rows % g_lanes == g)[:, 0].tolist():  # spheres, then triangles
            take = marked[r] & hit_all[r] & (t_all[r] < lane_t[g])
            lane_t[g] = torch.where(take, t_all[r], lane_t[g])
            lane_i[g] = torch.where(take, ids[r].to(torch.int32), lane_i[g])
    keys = torch.where(lane_i >= 0, packed_key(lane_t, lane_i), NO_KEY)
    least = keys.min(dim=0).values
    held = (lane_i >= 0) & (lane_t == torch.gather(lane_t, 0, keys.argmin(dim=0)[None]))
    stats["lane_ties"] = stats.get("lane_ties", 0) + int((held.sum(dim=0) > 1).sum())
    if tri.shape[0]:
        s_best = torch.where(hit_all[:s_rows], t_all[:s_rows], BIG).min(dim=0).values
        t_best = torch.where(hit_all[s_rows:], t_all[s_rows:], BIG).min(dim=0).values
        ties = int(((s_best == t_best) & (s_best < BIG)).sum())
        stats["kind_ties"] = stats.get("kind_ties", 0) + ties
    # The xor butterfly of the group, lane g taking lane g ^ off's key when less.
    t, i = lane_t.clone(), lane_i.clone()
    for off in [g_lanes >> k for k in range(1, g_lanes.bit_length())]:
        other = torch.arange(g_lanes) ^ off
        take = keys[other] < keys
        keys = torch.where(take, keys[other], keys)
        t = torch.where(take, t[other], t)
        i = torch.where(take, i[other], i)
    assert torch.equal(keys[0], least) and bool((keys == keys[0]).all())
    found = keys[0] != NO_KEY
    return torch.where(found, t[0], BIG), torch.where(found, i[0], -1)


# -- the tests ------------------------------------------------------------------------


@pytest.mark.parametrize("t_max", [1e9, 3.0e38, float("inf")])
@pytest.mark.parametrize("cull", [True, False])
def test_group_order_matches_sequential_scan(cull, t_max):
    scene, rays = tie_scene(), tie_rays()
    stats = {}
    args = (rays, scene.sph_packed, scene.tri_packed, scene.num_spheres, T_MIN, t_max, cull)
    got = group_nearest(*args, stats)
    ref = prim_ops.prim_nearest_packed_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # The data holds the cases the proof is about.
    i = ref[1]
    assert (i == -1).sum() > 64 and (i >= scene.num_spheres).sum() > 20
    assert stats["lane_ties"] >= 30 and stats["kind_ties"] >= 30, stats
    # Many admitted pairs are no hit (behind the origin, beyond t_max, ...).
    assert stats["admitted"] > 2 * int((i >= 0).sum()), stats


def kernel_reads(org: torch.Tensor, dirn: torch.Tensor) -> torch.Tensor:
    """Rays f32[6, N] as K2's kernel reads them: ray i's component k at
    storage[offset + i * stride(0) + k * stride(1)] of each tensor."""
    rows = []
    for x in (org, dirn):
        flat = torch.empty(0, dtype=x.dtype).set_(x.untyped_storage())
        i, k = torch.arange(x.shape[0])[None, :], torch.arange(3)[:, None]
        rows.append(flat[x.storage_offset() + i * x.stride(0) + k * x.stride(1)])
    return torch.cat(rows)


@pytest.mark.parametrize("t_max", [1e9, 3.0e38, float("inf")])
@pytest.mark.parametrize("entry", ["K2", "K2 strided views", "K2b"])
def test_k2_group_order_matches_plain(entry, t_max):
    """K2's lane split and key minimum over the tie scene's spheres, the
    rays read through the strides each entry hands the kernel, equal bit
    for bit to the plain versions (ties across lanes and in one lane, near
    roots below t_min, misses, radius-0 pad rows)."""
    scene, rays = tie_scene(), tie_rays()
    ns, n = scene.num_spheres, rays.shape[1]
    if entry == "K2b":
        org, dirn, sph = rays[0:3].T, rays[3:6].T, scene.sph_packed  # sphere_nearest_packed's views
        ref = sphere_nearest_packed_plain(rays, sph, T_MIN, t_max)
        assert sph.shape[0] > ns and bool((sph[ns:, 3] == 0).all())
    else:
        centers, radius = scene.sph_center[:ns], scene.sph_radius[:ns]
        org, dirn = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        if entry == "K2 strided views":
            wide = torch.zeros((n, 11))
            wide[:, 2:5] = org
            org = wide[:, 2:5]  # ray step 11
            dirn = rays[3:6].clone().T  # ray step 1, component step n
            assert org.stride() == (11, 1) and dirn.stride() == (1, n)
        sph = _pack_spheres(centers, radius)
        ref = sphere_nearest_plain(org, dirn, centers, radius, T_MIN, t_max)
    read = kernel_reads(org, dirn)
    assert torch.equal(read, rays[0:6])
    stats = {}
    got = group_nearest(read, sph, scene.tri_packed[:0], sph.shape[0], T_MIN, t_max, True, stats,
                        g_lanes=K2_G)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    i = ref[1]
    assert (i == -1).sum() > 64 and stats["lane_ties"] >= 30, stats
    assert not ((i >= len(SPOTS) + 40) | (i == len(SPOTS) + 8)).any()  # later copies never win
    assert stats["admitted"] > 2 * int((i >= 0).sum()), stats


def test_tie_scene_winners_are_the_first_copies():
    """Ties go to the lowest id: the spot spheres' second copies never win,
    nor the repeated random sphere, nor the repeated triangles; a ray up a
    spot's axis takes the sphere over the triangle at equal t."""
    scene, rays = tie_scene(), tie_rays()
    t, i = prim_ops.prim_nearest_packed_plain(rays, scene.sph_packed, scene.tri_packed,
                                              scene.num_spheres, T_MIN, 3.0e38, True)
    k, ns = len(SPOTS), scene.num_spheres
    won = i.to(torch.int64)
    assert not (((won >= k + 40) & (won < ns)) | (won == k + 8) | (won >= ns + k)).any()
    assert (won == k).any()  # the repeated random sphere's first copy is hit
    assert torch.equal(won[:k], torch.arange(k)) and bool((t[:k] == 1.0).all())
    assert torch.equal(won[k : 2 * k], torch.arange(k)) and bool((t[k : 2 * k] == 0.5).all())
    assert bool((t[2 * k : 3 * k] == 2.0).all())  # the far root from the bottom point


def test_order_key_packs_ties_by_id():
    t = torch.tensor([1.0, 1.0, 0.5, -0.0, 0.0, 2.0])
    i = torch.tensor([7, 3, 9, 5, 4, 0])
    keys = packed_key(t, i)
    assert int(keys.argmin()) == 4 and keys[3] > keys[4]  # -0 ties +0, the lower id first
    assert keys[1] < keys[0] < keys[5] and int(keys.max()) < NO_KEY


def _ring_case():
    b = SceneBuilder()
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
    b.add_sphere((0, 0, 1), 1, b.dielectric(1.5))
    b.add_sphere((1.5, 1.0, 0.6), 0.6, b.metal(b.solid_color((0.8, 0.7, 0.6)), 0.2))
    b.add_triangle((-1, -1, 0.5), (2, -1, 0.5), (0, 1, 2.5), b.lambertian(b.solid_color((0.2, 0.4, 0.8))))
    camera = make_camera((6, 0, 2), (0, 0, 1), (0, 0, 1), focus_distance=6.0, defocus_angle=0.6,
                         image_width=32, image_height=24, vertical_fov=30.0)
    cfg = RenderConfig(width=32, height=24, samples_per_pixel=2, max_depth=8)
    return b.build(), camera, cfg


def _duration(policy: str, rng, i: int, s: int, n_slots: int) -> int:
    """Steps a path runs under a completion policy: seeded random lengths;
    every pixel's first sample held back; or the paths of every P-th pixel
    held back (under a fixed slot i % P, each would block the next)."""
    if policy == "random":
        return int(rng.integers(1, 9))
    if policy == "first_held":
        return 40 if s == 0 else 1
    return 40 if i % n_slots == 0 else int(rng.integers(1, 3))


IDLE, LIVE, STORE, HAND_ON, DONE = range(5)  # a lane's states (csrc/megakernel.cu)


def ring_model(rad: torch.Tensor, n_slots: int, policy: str = "random", warps: int = 4,
               lanes: int = 8, seed: int = 0) -> tuple[torch.Tensor, int]:
    """K1's ring over the items' radiance ``rad`` f32[n, spp, 3]: (the image
    f32[n, 3], the steps lanes waited for a slot or to hand one on).  Each
    step, the warps in a seeded order, each as the kernel's step loop: lanes
    without an item claim the next ones in lane order (pixel-major, k = i *
    spp + s) and start their paths; a warp whose lanes are all done exits;
    live paths advance one step; a lane whose path has ended stores it once
    its pixel has a slot, the slot at place i of the queue (cell i % P,
    round i // P; round 0 holds slot i % P), taken by the first lane that
    finds it; the lane that counts a pixel's last sample sums the slot in
    sample order from 0, writes the pixel, and hands the slot on to place t
    + P, t the pixels summed before it, once pixel t has taken that cell.
    Fails on a slot taken while another pixel holds it, a store into a slot
    the pixel does not hold, and a step that changes nothing (a stall)."""
    n, spp, _ = rad.shape
    n_items = n * spp
    rng = np.random.default_rng(seed)
    inv_spp = float(np.float32(1.0 / spp))
    scratch = torch.full((n_slots, spp, 3), float("nan"))
    holder = np.full((n_slots, spp), -1)  # the pixel whose sample each row holds
    owner = np.full(n_slots, -1)  # the pixel holding each slot, -1: free or in the queue
    stored = np.zeros(n_slots, np.int64)
    turn = np.zeros(n_slots, np.int64)  # per cell: 2r holds round r's slot, 2r + 1 taken
    cell = np.zeros(n_slots, np.int64)
    slot_of = np.zeros(n, np.int64)  # per pixel: its slot + 1
    out = torch.full((n, 3), float("nan"))
    state = np.full((warps, lanes), IDLE)
    item = np.zeros((warps, lanes), np.int64)
    left = np.zeros((warps, lanes), np.int64)  # steps the live path still runs
    freed = np.zeros((warps, lanes), np.int64)  # a summed pixel's slot, to hand on ...
    place = np.zeros((warps, lanes), np.int64)  # ... to place + P
    next_item = summed = waits = 0
    while (state != DONE).any():
        moved = False
        for w in rng.permutation(warps):
            if (state[w] == DONE).all():
                continue
            for ln in range(lanes):  # one counter add a warp, in lane order
                if state[w, ln] == IDLE:
                    if next_item < n_items:
                        item[w, ln], next_item = next_item, next_item + 1
                        i, s = divmod(int(item[w, ln]), spp)
                        state[w, ln], left[w, ln] = LIVE, _duration(policy, rng, i, s, n_slots)
                    else:
                        state[w, ln] = DONE
                    moved = True
            live = state[w] == LIVE
            left[w] -= live
            state[w][live & (left[w] == 0)] = STORE
            moved = moved or bool(live.any())
            for ln in rng.permutation(lanes):
                if state[w, ln] == STORE:
                    i, s = divmod(int(item[w, ln]), spp)
                    if slot_of[i] == 0:
                        c, r = i % n_slots, i // n_slots
                        if turn[c] == 2 * r:
                            slot = c if r == 0 else int(cell[c])
                            assert owner[slot] == -1, "a slot taken while another pixel holds it"
                            owner[slot], slot_of[i], turn[c] = i, slot + 1, 2 * r + 1
                    if slot_of[i] == 0:
                        waits += 1
                        continue
                    slot = int(slot_of[i]) - 1
                    assert owner[slot] == i, "a path stored into a slot its pixel does not hold"
                    scratch[slot, s], holder[slot, s] = rad[i, s], i
                    state[w, ln], stored[slot], moved = IDLE, stored[slot] + 1, True
                    if stored[slot] == spp:
                        assert (holder[slot] == i).all()
                        acc = torch.zeros(3)
                        for k in range(spp):
                            acc = acc + scratch[slot, k]
                        out[i] = acc * inv_spp
                        stored[slot] = 0
                        state[w, ln], freed[w, ln], place[w, ln] = HAND_ON, slot, summed
                        summed += 1
                if state[w, ln] == HAND_ON:
                    t = int(place[w, ln])
                    c, r = t % n_slots, t // n_slots + 1
                    if turn[c] == 2 * r - 1:
                        owner[freed[w, ln]] = -1
                        cell[c], turn[c], state[w, ln], moved = freed[w, ln], 2 * r, IDLE, True
                    else:
                        waits += 1
        assert moved, "the ring stalled: lanes wait and no path runs"
    assert summed == n and next_item == n_items
    return out, waits


def _per_sample_radiance(scene, camera, cfg, spp, offset, seed, base, n):
    """f32[n, spp, 3]: trace_paths' radiance of every (pixel, sample) item."""
    sky_k = frame_scalars(scene.sky)
    pix = torch.arange(base, base + n)
    rows = []
    for s in range(spp):
        sample = torch.full_like(pix, offset + s)
        org, dirn, gwork = generate_rays(camera, pix, sample, seed, cfg.compat)
        rows.append(megakernel.trace_paths(scene, cfg, seed, sky_k, org, dirn, gwork))
    return torch.stack(rows, dim=1)


@pytest.mark.parametrize("cap_slots", [1, 7, 1 << 20])
@pytest.mark.parametrize("spp", [1, 3, 17])
def test_ring_sum_is_the_plain_image(spp, cap_slots, monkeypatch):
    """K1's ring, as ``ring_model`` runs it with seeded random completion,
    gives the plain version's image bit for bit (a pixel range, defocus,
    sample offset 2), with the scratch cap lowered to ``cap_slots`` pixels'
    samples: one slot (300 rounds of the queue), 7 (43), or every pixel
    (1)."""
    scene, camera, cfg = _ring_case()
    base, n, offset, seed = 100, 300, 2, 5
    monkeypatch.setattr(megakernel, "SCRATCH_CAP", 12 * spp * cap_slots)
    n_slots = megakernel.ring_slots(n, spp)
    assert n_slots == min(n, cap_slots)
    rad = _per_sample_radiance(scene, camera, cfg, spp, offset, seed, base, n)
    got, waits = ring_model(rad, n_slots, seed=spp * cap_slots)
    ref = megakernel.render_megakernel_plain(scene, camera, cfg, spp, offset, seed,
                                             pixel_base=base, n_pixels=n)
    assert torch.equal(got, ref) and ref.abs().max() > 0.05
    if n_slots * spp < 32:  # the 32 lanes claim more samples than the ring holds
        assert waits > 0


@pytest.mark.parametrize("policy", ["random", "first_held", "slot_held"])
@pytest.mark.parametrize("n_slots", [1, 2])
def test_ring_makes_progress(n_slots, policy):
    """With one or two slots, under completion orders that hold back every
    pixel's first sample or every P-th pixel's paths, the ring never
    stalls, writes every pixel once, and each pixel is its samples' in-order
    sum."""
    n, spp = 40, 3
    rad = torch.from_numpy(np.random.default_rng(7).random((n, spp, 3), dtype=np.float32))
    got, waits = ring_model(rad, n_slots, policy, seed=n_slots)
    acc = torch.zeros((n, 3))
    for s in range(spp):
        acc = acc + rad[:, s]
    assert torch.equal(got, acc * float(np.float32(1.0 / spp))) and waits > 0


@pytest.mark.parametrize("n_pixels, spp", [(90_000, 640), (1_440_000, 10), (768, 7_000),
                                           (5_000_000, 64), (8_294_400, 3), (8_294_400, 1_024)])
def test_ring_slots_bound_scratch(n_pixels, spp):
    """The ring's scratch f32[P, spp, 3] stays under the cap, or is one
    pixel's where one pixel's samples alone pass it, with as many slots as
    fit and no more than the pixels; the generations cover the pixels; and
    the 64-bit item numbers k = i * spp + s decode to a pixel of the range
    and a row of the ring, past 2**31 too (4K at 1,024 spp: 8.5e9 items)."""
    cap = megakernel.SCRATCH_CAP
    p = megakernel.ring_slots(n_pixels, spp)
    assert 1 <= p <= n_pixels
    assert p * spp * 12 <= max(cap, 12 * spp)
    assert p == n_pixels or p == 1 or (p + 1) * spp * 12 > cap  # as many slots as fit
    generations = -(-n_pixels // p)
    assert (generations - 1) * p < n_pixels <= generations * p
    n_items = n_pixels * spp
    ks = torch.tensor(sorted({k for k in (0, p * spp - 1, p * spp, 2**31 - 1, 2**31, n_items - 1)
                              if k < n_items}), dtype=torch.int64)
    i = ks // spp
    s = ks - i * spp
    assert bool(((0 <= i) & (i < n_pixels) & (0 <= s) & (s < spp)).all())
    assert torch.equal(i * spp + s, ks)
    assert bool(((i % p) * spp + s < p * spp).all())
    if (n_pixels, spp) == (8_294_400, 1_024):
        assert n_items > 2**31 and int(ks.max()) == n_items - 1
