"""Elementwise ops that round and differentiate as the JAX package's do.

- ``div(num, x)``: ``num / x`` as one rounded division.  In torch,
  ``float / tensor`` is ``reciprocal(x) * num``, which rounds twice.
- ``maximum``, ``minimum`` and ``clip`` against a constant: JAX's
  ``lax.max``/``lax.min`` split the cotangent 0.5/0.5 where the operands
  tie, and ``jnp.clip(x, lo, hi)`` is ``minimum(hi, maximum(lo, x))``.
  ``torch.maximum``/``torch.minimum`` follow the same rule, while
  ``torch.clamp`` passes the whole cotangent at a bound.  The gradient
  path ties often (gray albedos in the Russian-roulette max, a
  probability of exactly ``rr_clamp``), so it uses these.
- ``take_rows(table, idx)``: ``table[idx]`` whose backward is a
  deterministic scatter-add (see its docstring).
- ``dot3``, ``cross3``: on 3-vectors held as three tensors, in the
  operation order of ``jnp.sum(a * b, -1)`` and ``jnp.cross``.
"""

from __future__ import annotations

import torch


def div(num: float, x: torch.Tensor) -> torch.Tensor:
    """num / x as one rounded division."""
    return torch.full_like(x, num) / x


def dot3(a, b) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b) -> tuple:
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    # A 0-dim CPU tensor enters a CUDA op as a scalar: no copy to the card.
    return torch.tensor(c, dtype=like.dtype)


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, _const(c, x))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, _const(c, x))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return minimum(maximum(x, lo), hi)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            out = grad.new_zeros(ctx.shape).index_put_((idx,), grad, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(was)
        return out, None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0.  Its backward adds the cotangents of
    repeated indices with ``index_put_(accumulate=True)`` under
    ``torch.use_deterministic_algorithms(True)``, which sorts the indices
    and sums each run in a fixed order instead of with float atomics, so
    two backward passes give bit-identical gradients (the JAX package's
    are deterministic too)."""
    return _TakeRows.apply(table, idx)
