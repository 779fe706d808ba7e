#!/usr/bin/env python
"""K6: microbenchmarks of the primitives of K5's expansion sweep
(tools/micro_probe.py), with hand-written CUDA kernels.

Three primitive costs decide how a clustered walk should expand rays into
(ray, cluster) items and back:

  reduce   per-item cost of the item -> ray winner reduction: the smallest
           key per ray, and the first item that holds it;
  gather   per-visit cost of gathering 8 rays and intersecting them with a
           128-lane block of cluster slots (sphere test, a key per lane,
           the minimum per ray), in five modes that take parts away:
           "nomath" (no intersect), "nogather" (rays from the slot block),
           "noslot" (always block 0), "unaligned" (rows written at an
           offset, later visits overwriting earlier ones);
  scatter  per-chunk cost of the byte-plane OR-scatter: per chunk of ch
           columns, 8 products vals[s] @ onehot_s^T, where onehot_s marks
           the columns any of K destination rows names.

Each body takes a rep count and repeats its work that many times in one
launch; the cost is the slope between two counts, (t(r2) - t(r1)) / (r2 -
r1) / n, best of 3, as the TPU probe measures it.

``reduce``, ``gather`` and ``scatter`` compute what the TPU bodies compute:
the (8, 128) f32 plane filled with ``acc``, and the state the body leaves
in its scratch.  The TPU bodies never initialize their scratch (it starts
as garbage on the TPU, as zeros in interpret mode), so here the initial
state is an argument, by default ``best = INT32_MAX``, ``bi = -1`` and
zeros, and the final state is returned.  On a CUDA tensor each launches
its kernel of csrc/micro_probe.cu (or raises); on a CPU tensor it runs its
plain PyTorch version (``*_plain``).  The bodies' unrolled loops have no
per-item guard, so ``n % unroll != 0`` raises here.

Run: ``python -m rt_tpu_torch.micro_probe [reduce|gather|scatter|all]
[--r1 8] [--r2 32] [--unroll 8] [--mode full|nomath|nogather|noslot|
unaligned|sweep] [--device cuda|cpu]``.  ``--device cpu`` times the plain
versions on the host (the TPU probe's ``--interpret``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rt_tpu_torch import _build
from rt_tpu_torch.elementwise import div

NI = 8192  # items
NV = NI // 8  # visits
R = 1024  # rays: one (8, 128) plane
N_CL = 832  # clusters of the gather's slot table
INT32_MAX = 2**31 - 1
MODES = ("full", "nomath", "nogather", "noslot", "unaligned")
SWEEP = ("full", "nomath", "nogather", "noslot")  # the TPU probe's --mode sweep
GATHER_UNROLL = 4  # visits per step of the TPU gather body
SCATTER_SHAPE = dict(nvrows=8, kk=4, ch=512)

# Launches of each kernel since the last reset.  Only the wrappers change
# them, once per call (a call launches the body and a one-block pass that
# fills the plane); callers read and reset them.
LAUNCHES = {"micro_reduce": 0, "micro_gather": 0, "micro_scatter": 0}


def _check_unroll(name: str, n: int, unroll: int) -> None:
    if unroll < 1 or n % unroll:
        raise ValueError(f"{name}: n = {n} is not a multiple of unroll = {unroll}; the body's "
                         "unrolled loop has no per-item guard")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with int32 wraparound."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(torch.int32)


def _acc_plane(acc: torch.Tensor) -> torch.Tensor:
    return acc.to(torch.float32).expand(8, 128).clone()


def _plane(x, fill: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((8, 128), fill, dtype=torch.int32, device=device)
    return x.reshape(8, 128).to(torch.int32)


# -- reduce ---------------------------------------------------------------------


def reduce_plain(rid, key, reps: int, n: int, *, unroll: int = 8, best=None, bi=None):
    """The reduce body's plain version: (out f32[8,128], best int32[8,128],
    bi int32[8,128]).  Items i < n in order: ray r = rid[i] (items with r
    outside [0, 1024) are skipped, where the TPU body would read or write
    out of its plane), key k = key[i]; when k < best[r], best[r] = k and
    bi[r] = i.  After each rep rr, acc += best[rr & 7, rr & 127] in
    wrapping int32.  Vectorized: per ray the smallest key, among equal
    keys the first item, replacing the initial value only when smaller."""
    _check_unroll("reduce", n, unroll)
    device = rid.device
    best0, bi0 = _plane(best, INT32_MAX, device).flatten(), _plane(bi, -1, device).flatten()
    if reps <= 0:
        return torch.zeros((8, 128), device=device), best0.reshape(8, 128), bi0.reshape(8, 128)
    r = rid.reshape(-1)[:n].to(torch.int64)
    k = key.reshape(-1)[:n].to(torch.int64)
    i = torch.arange(n, device=device)
    ok = (r >= 0) & (r < R)
    r, k, i = r[ok], k[ok], i[ok]
    none = 2**40
    kmin = torch.full((R,), none, dtype=torch.int64, device=device).scatter_reduce(
        0, r, k, "amin")
    first = k == kmin[r]
    imin = torch.full((R,), none, dtype=torch.int64, device=device).scatter_reduce(
        0, r[first], i[first], "amin")
    better = kmin < best0.to(torch.int64)
    best_out = torch.where(better, kmin, best0.to(torch.int64)).to(torch.int32)
    bi_out = torch.where(better, imin, bi0.to(torch.int64)).to(torch.int32)
    rr = torch.arange(reps, device=device)
    acc = _wrap32(best_out[(rr & 7) * 128 + (rr & 127)].to(torch.int64).sum())
    return _acc_plane(acc), best_out.reshape(8, 128), bi_out.reshape(8, 128)


def reduce(rid, key, reps: int, n: int, *, unroll: int = 8, best=None, bi=None):
    """K6 reduce (tools/micro_probe.py:41): ``rid``, ``key`` int32[1, >= n];
    returns (out, best, bi) as ``reduce_plain``."""
    _check_unroll("reduce", n, unroll)
    if n > rid.numel() or n > key.numel():
        raise ValueError(f"reduce: n = {n} items, but rid and key hold {rid.numel()}, {key.numel()}")
    device = rid.device
    if device.type == "cpu":
        return reduce_plain(rid, key, reps, n, unroll=unroll, best=best, bi=bi)
    _cuda(device, "reduce")
    i32 = torch.int32
    rid = _build.require(rid.contiguous(), "reduce: rid", device, i32)
    key = _build.require(key.contiguous(), "reduce: key", device, i32)
    best0 = _build.require(_plane(best, INT32_MAX, device).contiguous(), "reduce: best", device, i32)
    bi0 = _build.require(_plane(bi, -1, device).contiguous(), "reduce: bi", device, i32)
    out = torch.empty((8, 128), device=device)
    best_out, bi_out = torch.empty_like(best0), torch.empty_like(bi0)
    _call(device, "micro_reduce", _build.library().rt_micro_reduce,
          rid.data_ptr(), key.data_ptr(), int(reps), int(n), int(unroll), best0.data_ptr(),
          bi0.data_ptr(), out.data_ptr(), best_out.data_ptr(), bi_out.data_ptr())
    return out, best_out, bi_out


# -- gather ---------------------------------------------------------------------


def _start_rows(vc: torch.Tensor, mode: str) -> torch.Tensor:
    return vc * 8 - (vc & 7) if mode == "unaligned" else vc * 8


def gather_plain(rays_t, slots, item, vcl, reps: int, nv: int, *, mode: str = "full",
                 unroll: int = GATHER_UNROLL, res=None):
    """The gather body's plain version: (out f32[8,128], res int32[8192]).
    Visits v < nv take vc = min(v, 1023) and the slot block of cluster
    ci = min(vcl[vc], n_cl - 1) (block 0 in "noslot"); its 8 items are
    the rays rays_t[item[vc*8 + j]] (ids clamped into [0, 1024); in
    "nogather" the block's [0:8, 0:8] * 0.5).  Per item, the minimum over
    the 128 lanes of (bits(t) & ~127) | lane, t the sphere candidate of
    tools/micro_probe.py:100-114 ("nomath": bits(ox+dx) + bits(oy+dy)), is
    written to res row start(vc) + j, the later visit winning a shared row;
    after each rep acc += res[rr & 7] in wrapping int32."""
    _check_mode(mode)
    _check_unroll("gather", nv, unroll)
    device = rays_t.device
    res_out = (torch.zeros((NI,), dtype=torch.int32, device=device) if res is None
               else res.reshape(-1).to(torch.int32).clone())
    nvis = min(nv, NV)
    if reps <= 0 or nvis <= 0:
        return _gather_acc(res_out, max(reps, 0)), res_out
    n_cl = slots.shape[1] // 128
    vc = torch.arange(nvis, device=device)
    ci = torch.clamp(vcl.reshape(-1)[vc].to(torch.int64), 0, n_cl - 1)
    lanes = torch.arange(128, device=device)
    cols = lanes[None, :].expand(nvis, 128) if mode == "noslot" else ci[:, None] * 128 + lanes
    block = slots[:, cols].permute(1, 0, 2)  # [V, 8 rows, 128 lanes]
    if mode == "nogather":
        itm = block[:, :, 0:8] * 0.5  # [V, 8 items, 8]
    else:
        rj = torch.clamp(item.reshape(-1)[vc[:, None] * 8 + torch.arange(8, device=device)]
                         .to(torch.int64), 0, R - 1)
        itm = rays_t[rj]  # [V, 8 items, 8]
    ox, oy, oz, dx, dy, dz = (itm[:, :, k : k + 1] for k in range(6))  # [V, 8, 1]
    if mode == "nomath":
        bits = lambda x: x.view(torch.int32).to(torch.int64)
        kmin = _wrap32(bits(ox + dx) + bits(oy + dy))[:, :, 0]
    else:
        cx, cy, cz, rad = (block[:, k : k + 1, :] for k in range(4))  # [V, 1, 128]
        a = dx * dx + dy * dy + dz * dz
        inv_a = div(1.0, a)
        ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
        h = dx * ocx + dy * ocy + dz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = h * h - a * c
        sd = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (h - sd) * inv_a
        t1 = (h + sd) * inv_a
        t = torch.where(t0 >= 1e-3, t0, t1)
        valid = (disc >= 0.0) & (rad > 0.0) & (t >= 1e-3)
        t = torch.where(valid, t, 3e38)
        kmin = ((t.view(torch.int32) & ~127) | lanes.to(torch.int32)).amin(dim=-1)  # [V, 8]
    start = _start_rows(vc, mode)
    rows = start[:, None] + torch.arange(8, device=device)
    nxt = torch.cat([start[1:], torch.full((1,), 2**40, dtype=torch.int64, device=device)])
    own = rows < nxt[:, None]  # no later visit writes the row
    res_out[rows[own]] = kmin[own].to(torch.int32)
    return _gather_acc(res_out, reps), res_out


def _gather_acc(res: torch.Tensor, reps: int) -> torch.Tensor:
    rr = torch.arange(reps, device=res.device)
    return _acc_plane(_wrap32(res[rr & 7].to(torch.int64).sum()))


def gather(rays_t, slots, item, vcl, reps: int, nv: int, *, mode: str = "full",
           unroll: int = GATHER_UNROLL, res=None):
    """K6 gather (tools/micro_probe.py:66): rays_t f32[1024, 8], slots
    f32[8, n_cl*128], item int32[1, 8192], vcl int32[1, 1024]; returns
    (out, res) as ``gather_plain``."""
    _check_mode(mode)
    _check_unroll("gather", nv, unroll)
    if rays_t.shape != (R, 8) or slots.dim() != 2 or slots.shape[0] != 8 or slots.shape[1] % 128:
        raise ValueError(f"gather: need rays_t [{R}, 8] and slots [8, k*128], got "
                         f"{tuple(rays_t.shape)}, {tuple(slots.shape)}")
    if item.numel() < NI or vcl.numel() < NV:
        raise ValueError(f"gather: need item [{NI}] and vcl [{NV}]")
    device = rays_t.device
    if device.type == "cpu":
        return gather_plain(rays_t, slots, item, vcl, reps, nv, mode=mode, unroll=unroll, res=res)
    _cuda(device, "gather")
    f32, i32 = torch.float32, torch.int32
    rays_t = _build.require(rays_t.contiguous(), "gather: rays_t", device, f32)
    slots = _build.require(slots.contiguous(), "gather: slots", device, f32)
    item = _build.require(item.contiguous(), "gather: item", device, i32)
    vcl = _build.require(vcl.contiguous(), "gather: vcl", device, i32)
    res_out = (torch.zeros((NI,), dtype=i32, device=device) if res is None
               else _build.require(res.reshape(-1).to(i32).clone(), "gather: res", device, i32))
    out = torch.empty((8, 128), device=device)
    _call(device, "micro_gather", _build.library().rt_micro_gather,
          rays_t.data_ptr(), slots.data_ptr(), slots.shape[1] // 128, item.data_ptr(),
          vcl.data_ptr(), int(reps), min(int(nv), NV), MODES.index(mode), res_out.data_ptr(),
          out.data_ptr())
    return out, res_out


# -- scatter --------------------------------------------------------------------


def _chunk_writers(n_chunks: int, ch: int) -> list[tuple[int, int]]:
    """(column block, chunk) pairs: chunk c writes block min(c, NI/ch - 1),
    so the last block holds the last chunk that writes it."""
    n_blocks = NI // ch
    return [(cc, cc if cc < n_blocks - 1 else n_chunks - 1)
            for cc in range(min(n_chunks, n_blocks))]


def scatter_plain(vals, dst, reps: int, n_chunks: int, *, nvrows: int = 8, kk: int = 4,
                  ch: int = 512, scr=None):
    """The scatter body's plain version: (out f32[8,128], scr
    f32[nvrows, 8192]).  Per chunk c < n_chunks, base = c*ch:
    tot[r, j] = sum over s < 8 and lanes of vals[s*nvrows + r, lane] where
    some k < kk has dst[s*kk + k, lane] - base == j, written to
    scr[:, min(c, NI/ch - 1)*ch : +ch]; after each rep acc += the sum of
    scr[0, (rr & 7)*128 : +128].  The products are f32 matrix products
    here (the TPU body's are DEFAULT-precision dots)."""
    _check_scatter(nvrows, ch)
    device = vals.device
    scr_out = (torch.zeros((nvrows, NI), device=device) if scr is None
               else scr.reshape(nvrows, NI).to(torch.float32).clone())
    if reps > 0:
        iota = torch.arange(ch, device=device)[:, None]
        for cc, c in _chunk_writers(n_chunks, ch):
            base = c * ch
            tot = None
            for s in range(8):
                pm = torch.zeros((ch, 128), device=device)
                for k in range(kk):
                    d = dst[s * kk + k].to(torch.int64)[None, :] - base
                    pm = torch.maximum(pm, (iota == d).to(torch.float32))
                part = vals[s * nvrows : (s + 1) * nvrows] @ pm.T  # [nvrows, ch]
                tot = part if tot is None else tot + part
            scr_out[:, cc * ch : (cc + 1) * ch] = tot
    acc = torch.zeros((), device=device)
    sums = scr_out[0, : 8 * 128].reshape(8, 128).sum(dim=1)
    for rr in range(max(reps, 0)):
        acc = acc + sums[rr & 7]
    return acc.expand(8, 128).clone(), scr_out


def scatter(vals, dst, reps: int, n_chunks: int, *, nvrows: int = 8, kk: int = 4, ch: int = 512,
            scr=None):
    """K6 scatter (tools/micro_probe.py:131): vals f32[8*nvrows, 128], dst
    int32[8*kk, 128]; returns (out, scr) as ``scatter_plain``.  The kernel
    marks, with one scan of the destinations, the lanes that name each
    column, then sums in f32 over the marked lanes in ascending lane within
    each s and s in ascending order (the models of
    tests/torch_micro_cases.py); it calls no matrix-product library."""
    _check_scatter(nvrows, ch)
    if vals.shape != (8 * nvrows, 128) or dst.shape != (8 * kk, 128):
        raise ValueError(f"scatter: need vals [{8 * nvrows}, 128] and dst [{8 * kk}, 128], got "
                         f"{tuple(vals.shape)}, {tuple(dst.shape)}")
    device = vals.device
    if device.type == "cpu":
        return scatter_plain(vals, dst, reps, n_chunks, nvrows=nvrows, kk=kk, ch=ch, scr=scr)
    _cuda(device, "scatter")
    vals = _build.require(vals.contiguous(), "scatter: vals", device)
    dst = _build.require(dst.contiguous(), "scatter: dst", device, torch.int32)
    scr_out = (torch.zeros((nvrows, NI), device=device) if scr is None
               else _build.require(scr.reshape(nvrows, NI).to(torch.float32).clone(),
                                   "scatter: scr", device))
    out = torch.empty((8, 128), device=device)
    _call(device, "micro_scatter", _build.library().rt_micro_scatter,
          vals.data_ptr(), dst.data_ptr(), int(reps), int(n_chunks), nvrows, kk, ch,
          scr_out.data_ptr(), out.data_ptr())
    return out, scr_out


# -- shared checks ------------------------------------------------------------------


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"gather: unknown mode {mode!r}; one of {MODES}")


def _check_scatter(nvrows: int, ch: int) -> None:
    if not 1 <= nvrows <= 8 or ch < 1 or NI % ch:
        raise ValueError(f"scatter: need 1 <= nvrows <= 8 and ch dividing {NI}, got {nvrows}, {ch}")


def _cuda(device: torch.device, name: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")


def _call(device: torch.device, name: str, entry, *args) -> None:
    """Launch through the C entry point ``entry`` on the device's current
    stream; raise on a CUDA error, count the launch otherwise."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


# -- the probe ------------------------------------------------------------------------


def inputs(which: str, device) -> dict:
    """The TPU probe's inputs (tools/micro_probe.py:214-257), drawn from one
    numpy generator with seed 0 in its order: reduce's only when reduce
    runs, then gather's, then scatter's."""
    rng = np.random.default_rng(0)
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(device)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    out = {}
    if which in ("reduce", "all"):
        out["reduce"] = dict(rid=i32(rng.integers(0, R, (1, NI))),
                             key=i32(rng.integers(0, 1 << 30, (1, NI))))
    if which in ("gather", "all"):
        rays_t = f32(rng.standard_normal((R, 8)))
        slots = f32(rng.standard_normal((8, N_CL * 128)))
        item = i32(rng.integers(0, R, (1, NI)))
        vcl = i32(rng.integers(0, N_CL, (1, NV)))
        out["gather"] = dict(rays_t=rays_t, slots=slots, item=item, vcl=vcl)
    if which in ("scatter", "all"):
        nvrows, kk = SCATTER_SHAPE["nvrows"], SCATTER_SHAPE["kk"]
        out["scatter"] = dict(vals=f32(rng.standard_normal((8 * nvrows, 128))),
                              dst=i32(rng.integers(0, NI, (8 * kk, 128))))
    return out


def run(name: str, fn, r1: int, r2: int, n: int, device, trials: int = 3) -> dict:
    """Time ``fn(reps)`` at r1 and r2 reps (best of ``trials``; CUDA events
    on the card, the host clock on the CPU) and print the TPU probe's two
    lines.  Returns the numbers."""
    def t(reps: int) -> float:
        best = float("inf")
        for _ in range(trials):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(reps)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn(reps)
                best = min(best, time.perf_counter() - t0)
        return best

    t0 = time.perf_counter()
    fn(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0
    print(f"{name}: compile+run {compile_s:.1f} s", flush=True)
    b1, b2 = t(r1), t(r2)
    per_unit = (b2 - b1) / (r2 - r1) / n * 1e9
    print(f"{name}: {per_unit:8.2f} ns/unit over n={n} (r{r1}={b1 * 1e3:.2f} ms "
          f"r{r2}={b2 * 1e3:.2f} ms)", flush=True)
    return dict(ns_per_unit=per_unit, n=n, t_r1_ms=b1 * 1e3, t_r2_ms=b2 * 1e3,
                compile_s=compile_s, r1=r1, r2=r2)


def main(argv=None) -> dict:
    """The probe's command line; returns {name: run(...)'s numbers}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all", choices=("reduce", "gather", "scatter", "all"))
    ap.add_argument("--r1", type=int, default=8)
    ap.add_argument("--r2", type=int, default=32)
    ap.add_argument("--unroll", type=int, default=8)
    ap.add_argument("--mode", default="full", choices=MODES + ("sweep",))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("micro_probe: CUDA is not available (use --device cpu for the plain versions)")
    data = inputs(args.which, device)
    results = {}
    if "reduce" in data:
        d = data["reduce"]
        results["reduce"] = run(
            "reduce", lambda reps: reduce(d["rid"], d["key"], reps, NI, unroll=args.unroll),
            args.r1, args.r2, NI, device)
    if "gather" in data:
        d = data["gather"]
        for mode in SWEEP if args.mode == "sweep" else (args.mode,):
            results[f"gather[{mode}]"] = run(
                f"gather[{mode}]",
                lambda reps, mode=mode: gather(d["rays_t"], d["slots"], d["item"], d["vcl"], reps,
                                               NV, mode=mode),
                args.r1, args.r2, NV, device)
    if "scatter" in data:
        d, shape = data["scatter"], SCATTER_SHAPE
        n_chunks = NI // shape["ch"]
        results["scatter"] = run(
            f"scatter[nv={shape['nvrows']},K={shape['kk']},CH={shape['ch']}] "
            f"(per chunk-of-{shape['ch']})",
            lambda reps: scatter(d["vals"], d["dst"], reps, n_chunks, **shape),
            args.r1, args.r2, n_chunks, device)
    return results


if __name__ == "__main__":
    main()
