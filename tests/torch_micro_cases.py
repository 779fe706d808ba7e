"""Shared by the port's tests of K6's scatter (csrc/micro_probe.cu
``scatter_kernel``) and by chip_smoke.py: two plain-PyTorch models of
the kernel's f32 order, and destinations that repeat.

``scatter_sequential`` models a thread that owns one output column and
tests every (s, k, lane) destination against it, adding a lane's value
when any k names the column: for each s, the lanes in ascending order
from 0.0, and the s in ascending order.  ``scatter_masked`` models the
kernel: a block of ``COLS`` columns of one chunk scans the destinations
once and sets, for each that lands in its columns, the lane's bit in the
lane mask of (s, column), an OR that does not depend on the scan's order;
then each output adds its set lanes' values in ascending lane within each
s, and s in ascending order.  Both fill the plane as ``scatter_finish``
does: the 128 values of each of scr's first 8 column groups summed in
order, then those sums over the reps.  Every add is one f32 add, so the
two agree bit for bit exactly when the masks are the compares' OR.
"""

import numpy as np
import torch

from rt_tpu_torch import micro_probe as mp

COLS = 16  # columns a block (csrc/micro_probe.cu kScatterCols)


def _ordered_sum(hits, vals, nvrows: int):
    """tot f32[B, nvrows, ch] from hits bool[B, 8, 128, ch] (lane l of
    plane s names the column): per s, the set lanes' values added in
    ascending lane from 0.0; then the s added in ascending order."""
    b, _, _, ch = hits.shape
    tot = None
    for s in range(8):
        part = torch.zeros((b, nvrows, ch), device=vals.device)
        for lane in range(128):
            v = vals[s * nvrows : (s + 1) * nvrows, lane][None, :, None]
            part = torch.where(hits[:, s, lane][:, None, :], part + v, part)
        tot = part if tot is None else tot + part
    return tot


def _wrapped(dst, base):
    """(dst - base) mod 2**32 as int64, the kernel's unsigned difference."""
    return (dst.to(torch.int64) - base) & 0xFFFFFFFF


def _finish(scr, reps: int):
    """scatter_finish's plane: sums[i] of scr[0, i*128 : +128] in order, then
    acc over the reps in order."""
    sums = []
    for i in range(8):
        s = torch.zeros((), device=scr.device)
        for l in range(128):
            s = s + scr[0, i * 128 + l]
        sums.append(s)
    acc = torch.zeros((), device=scr.device)
    for rr in range(max(reps, 0)):
        acc = acc + sums[rr & 7]
    return acc.expand(8, 128).clone()


def _scr0(scr, nvrows: int, device):
    return (torch.zeros((nvrows, mp.NI), device=device) if scr is None
            else scr.reshape(nvrows, mp.NI).to(torch.float32).clone())


def scatter_sequential(vals, dst, reps: int, n_chunks: int, *, nvrows: int = 8, kk: int = 4,
                       ch: int = 512, scr=None):
    """(out, scr) of the loop that tests every destination against each
    column; the arguments are micro_probe.scatter's."""
    scr_out = _scr0(scr, nvrows, vals.device)
    writers = mp._chunk_writers(n_chunks, ch)
    if reps > 0 and writers:
        j = torch.arange(ch, device=vals.device)
        hits = torch.zeros((len(writers), 8, 128, ch), dtype=torch.bool, device=vals.device)
        for w, (_, c) in enumerate(writers):
            for s in range(8):
                for k in range(kk):
                    hits[w, s] |= _wrapped(dst[s * kk + k], c * ch)[:, None] == j[None, :]
        tot = _ordered_sum(hits, vals, nvrows)
        for w, (cc, _) in enumerate(writers):
            scr_out[:, cc * ch : (cc + 1) * ch] = tot[w]
    return _finish(scr_out, reps), scr_out


def scatter_masked(vals, dst, reps: int, n_chunks: int, *, nvrows: int = 8, kk: int = 4,
                   ch: int = 512, scr=None):
    """(out, scr) of the kernel's two steps, block by block: the masks from
    one scan of the destinations, then the ordered sums."""
    scr_out = _scr0(scr, nvrows, vals.device)
    writers = mp._chunk_writers(n_chunks, ch)
    if reps > 0 and writers:
        e = torch.arange(8 * kk * 128, device=vals.device)
        s_of, lane_of = e // (kk * 128), e % 128
        flat = dst.reshape(-1)
        masks = torch.zeros((len(writers), 8, 128, ch), dtype=torch.bool, device=vals.device)
        for w, (_, c) in enumerate(writers):
            for col0 in range(0, ch, COLS):
                cols = min(COLS, ch - col0)
                j = _wrapped(flat, c * ch + col0)
                land = j < cols
                masks[w].index_put_((s_of[land], lane_of[land], col0 + j[land]),
                                    torch.ones((), dtype=torch.bool, device=vals.device))
        tot = _ordered_sum(masks, vals, nvrows)
        for w, (cc, _) in enumerate(writers):
            scr_out[:, cc * ch : (cc + 1) * ch] = tot[w]
    return _finish(scr_out, reps), scr_out


def repeated_dst(kk: int, seed: int, high: int = mp.NI) -> torch.Tensor:
    """dst int32[8*kk, 128] from a seeded numpy generator in [0, high), with
    destinations that repeat: in every s, plane k = 1 repeats plane 0 (a
    lane names a column under two k), plane 0 of s = 5 repeats that of
    s = 2 (the same lane and column in two s), and lanes 40-47 of s = 3
    all name one column, with lane 44 naming it under every k."""
    rs = np.random.default_rng(seed)
    d = rs.integers(0, high, (8, kk, 128))
    if kk > 1:
        d[:, 1] = d[:, 0]
    d[5, 0] = d[2, 0]
    d[3, 0, 40:48] = d[3, 0, 40]
    d[3, :, 44] = d[3, 0, 40]
    return torch.from_numpy(d.reshape(8 * kk, 128).astype(np.int32))


# -- reduce and gather (csrc/micro_probe.cu reduce_kernel, gather_kernel) -----------

INT32_MAX = 2**31 - 1


def _wrap(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def reduce_sequential(rid, key, reps: int, n: int, *, best=None, bi=None):
    """(out, best, bi) of the TPU body's loop, item by item in order: the
    reference the kernel's scheme is held to.  Items whose ray lies outside
    [0, 1024) are skipped."""
    r, k = rid.reshape(-1)[:n].tolist(), key.reshape(-1)[:n].tolist()
    b = [INT32_MAX] * mp.R if best is None else best.reshape(-1).tolist()
    x = [-1] * mp.R if bi is None else bi.reshape(-1).tolist()
    acc = 0
    for rr in range(reps):
        for i in range(n):
            if 0 <= r[i] < mp.R and k[i] < b[r[i]]:
                b[r[i]], x[r[i]] = k[i], i
        acc = _wrap(acc + b[(rr & 7) * 128 + (rr & 127)])
    plane = lambda v: torch.tensor(v, dtype=torch.int32).reshape(8, 128)
    return torch.full((8, 128), float(acc)), plane(b), plane(x)


def reduce_tables(rid, key, reps: int, n: int, *, cluster: int = 1, best=None, bi=None):
    """(out, best, bi) of the kernel's scheme, step by step: the items cut
    into ``cluster`` equal ranges, one a block; each rep, each block's table
    from fresh entries (INT32_MAX, INT32_MAX) takes, per ray, its least key
    (phase 1, atomicMin), then the first item that holds it (phase 2,
    atomicMin of the index over the items whose key equals the table's);
    then each ray takes the least (key, item) over the blocks' tables and
    replaces its state only when that key is below the state's; the owner
    of ray (rr & 7, rr & 127) adds the state to its partial sum, and the
    partials are summed in wrapping int32 at the end."""
    r = rid.reshape(-1)[:n].to(torch.int64)
    k = key.reshape(-1)[:n].to(torch.int64)
    b = (torch.full((mp.R,), INT32_MAX, dtype=torch.int64) if best is None
         else best.reshape(-1).to(torch.int64).clone())
    x = (torch.full((mp.R,), -1, dtype=torch.int64) if bi is None
         else bi.reshape(-1).to(torch.int64).clone())
    per = -(-n // cluster)
    partial = [0] * mp.R
    for rr in range(reps):
        tabs_k, tabs_i = [], []
        for blk in range(cluster):
            lo = min(blk * per, n)
            hi = min(lo + per, n)
            i = torch.arange(lo, hi)
            rb, kb = r[lo:hi], k[lo:hi]
            ok = (rb >= 0) & (rb < mp.R)
            rb, kb, i = rb[ok], kb[ok], i[ok]
            tk = torch.full((mp.R,), INT32_MAX, dtype=torch.int64).scatter_reduce(0, rb, kb, "amin")
            hit = kb == tk[rb]
            ti = torch.full((mp.R,), INT32_MAX, dtype=torch.int64).scatter_reduce(
                0, rb[hit], i[hit], "amin")
            tabs_k.append(tk)
            tabs_i.append(ti)
        tk, ti = torch.stack(tabs_k), torch.stack(tabs_i)  # [cluster, R]
        kmin = tk.amin(dim=0)
        imin = torch.where(tk == kmin, ti, INT32_MAX).amin(dim=0)
        better = kmin < b
        b = torch.where(better, kmin, b)
        x = torch.where(better, imin, x)
        owner = (rr & 7) * 128 + (rr & 127)
        partial[owner] = _wrap(partial[owner] + int(b[owner]))
    acc = 0
    for p in partial:
        acc = _wrap(acc + p)
    return (torch.full((8, 128), float(acc)), b.to(torch.int32).reshape(8, 128),
            x.to(torch.int32).reshape(8, 128))


def tie_reduce_inputs(seed: int, n: int = mp.NI):
    """rid int32[1, n] in [-3, 1027) (some outside the plane), key int32[1,
    n] in [0, 40) (many ties), and initial planes best in [0, 50) (ties
    against items) and bi in [-5, 5)."""
    rs = np.random.default_rng(seed)
    i32 = lambda x: torch.from_numpy(x.astype(np.int32))
    return (i32(rs.integers(-3, mp.R + 3, (1, n))), i32(rs.integers(0, 40, (1, n))),
            i32(rs.integers(0, 50, (8, 128))), i32(rs.integers(-5, 5, (8, 128))))


def gather_pairs(rays_t, slots, item, vcl, nv: int, *, mode: str = "full"):
    """The gather's pair tests, tools/micro_probe.py:100-108 operation for
    operation, for the visits v < min(nv, 1024) in a mode other than
    "nomath": (h, disc, 1 / a, rad), h and disc [V, 8 items, 128 lanes],
    1 / a [V, 8, 1] and rad [V, 1, 128]."""
    nvis = min(nv, mp.NV)
    n_cl = slots.shape[1] // 128
    vc = torch.arange(nvis, device=slots.device)
    ci = torch.clamp(vcl.reshape(-1)[vc].to(torch.int64), 0, n_cl - 1)
    lane_ids = torch.arange(128, device=slots.device)
    cols = lane_ids[None, :].expand(nvis, 128) if mode == "noslot" else ci[:, None] * 128 + lane_ids
    block = slots[:, cols].permute(1, 0, 2)  # [V, 8 rows, 128 lanes]
    if mode == "nogather":
        itm = block[:, :, 0:8] * 0.5
    else:
        rj = torch.clamp(item.reshape(-1)[vc[:, None] * 8 + torch.arange(8, device=slots.device)]
                         .to(torch.int64), 0, mp.R - 1)
        itm = rays_t[rj]
    ox, oy, oz, dx, dy, dz = (itm[:, :, k : k + 1] for k in range(6))  # [V, 8, 1]
    a = dx * dx + dy * dy + dz * dz
    cx, cy, cz, rad = (block[:, k][:, None, :] for k in range(4))  # [V, 1, 128]
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    return h, h * h - a * c, torch.full_like(a, 1.0) / a, rad


def gather_lanes(rays_t, slots, item, vcl, reps: int, nv: int, *, mode: str = "full",
                 lanes: int = 1, res=None):
    """(out, res) of the kernel's scheme, step by step: a thread owns
    ``lanes`` adjacent slot lanes of a visit and tests them against its 8
    items; a pair takes its square root and roots only where disc >= 0 and
    rad > 0 (computed here on those pairs alone), every other pair's key
    is bits(3e38) & ~127 | lane; per item, each thread's least key over its
    lanes, then each warp's (__reduce_min_sync), then the least over the
    visit's 4 / ``lanes`` warps.  The rows and the plane as the kernel
    writes them; modes as ``micro_probe.gather``."""
    if mode == "nomath":
        return mp.gather_plain(rays_t, slots, item, vcl, reps, nv, mode=mode, res=res)
    res_out = (torch.zeros((mp.NI,), dtype=torch.int32) if res is None
               else res.reshape(-1).to(torch.int32).clone())
    nvis = min(nv, mp.NV)
    if reps <= 0 or nvis <= 0:
        return mp._gather_acc(res_out, max(reps, 0)), res_out
    h, disc, inv_a, rad = gather_pairs(rays_t, slots, item, vcl, nv, mode=mode)
    marked = (disc >= 0.0) & (rad > 0.0)
    none = int(torch.tensor(3e38, dtype=torch.float32).view(torch.int32)) & ~127
    bits = torch.full(disc.shape, none, dtype=torch.int64)
    hm, dm, im = h[marked], disc[marked], inv_a.expand_as(disc)[marked]
    sd = torch.sqrt(torch.clamp(dm, min=0.0))
    t0 = (hm - sd) * im
    t1 = (hm + sd) * im
    t = torch.where(t0 >= 1e-3, t0, t1)
    bits[marked] = torch.where(t >= 1e-3, t.view(torch.int32).to(torch.int64) & ~127, none)
    key = bits | torch.arange(128)  # [V, 8, 128]
    warps = 4 // lanes
    per_thread = key.reshape(nvis, 8, warps, 32, lanes).amin(dim=-1)
    per_warp = per_thread.amin(dim=-1)  # [V, 8, warps]: __reduce_min_sync
    item_key = per_warp.amin(dim=-1)  # the visit's warps, through shared memory
    vc = torch.arange(nvis)
    start = mp._start_rows(vc, mode)
    rows = start[:, None] + torch.arange(8)
    nxt = torch.cat([start[1:], torch.full((1,), 2**40, dtype=torch.int64)])
    own = rows < nxt[:, None]
    res_out[rows[own]] = item_key[own].to(torch.int32)
    return mp._gather_acc(res_out, reps), res_out


def gather_hard_inputs(seed: int, n_cl: int = 24):
    """Gather inputs from a seeded numpy generator whose slot blocks hold
    rows of every kind: radii negative, zero and positive; centres far off
    every ray (disc < 0); spheres behind the origin (both roots below
    1e-3) and around it (the far root); item ids out of range and vcl past
    the table."""
    rs = np.random.default_rng(seed)
    rays_t = rs.standard_normal((mp.R, 8)).astype(np.float32)
    rays_t[:, 3:6] *= 0.3
    slots = rs.standard_normal((8, n_cl * 128)).astype(np.float32)
    slots[3, ::7] = 0.0
    slots[3, 3::11] = -np.abs(slots[3, 3::11])
    slots[0:3, 5::13] *= 100.0  # far off every ray
    slots[3, 6::9] = 4.0  # large: origins inside
    item = rs.integers(-2, mp.R + 2, (1, mp.NI)).astype(np.int32)
    vcl = rs.integers(0, n_cl + 3, (1, mp.NV)).astype(np.int32)
    res0 = rs.integers(-9, 9, (mp.NI,)).astype(np.int32)
    return tuple(torch.from_numpy(x) for x in (rays_t, slots, item, vcl, res0))


def gather_plain_repeats(rounds: int, threads: int) -> list:
    """The gather checks of chip_smoke.py's parity phase as PR 8 ran them,
    on the CPU, where ``micro_probe.gather`` runs the plain version: each
    round, for reps 1-3 (from random initial rows), every mode and 256 and
    1,024 visits, the wrapper's result against ``gather_plain``'s, with
    ``torch.set_num_threads(threads)``.  Returns the (round, reps, mode,
    visits) whose results differ."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        g = mp.inputs("all", "cpu")["gather"]
        rs = np.random.default_rng(1)
        differ = []
        for rnd in range(rounds):
            for reps in (1, 2, 3):
                res0 = torch.from_numpy(rs.integers(-9, 9, (mp.NI,)).astype(np.int32))
                for mode in mp.MODES:
                    for nv in (256, mp.NV):
                        args = (g["rays_t"], g["slots"], g["item"], g["vcl"], reps, nv)
                        got = mp.gather(*args, mode=mode, res=res0)
                        want = mp.gather_plain(*args, mode=mode, res=res0)
                        if not all(torch.equal(a, b) for a, b in zip(got, want)):
                            differ.append((rnd, reps, mode, nv))
        return differ
    finally:
        torch.set_num_threads(before)
