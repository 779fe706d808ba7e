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
