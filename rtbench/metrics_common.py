"""What the per-layer metrics' readers share: the kernels' name patterns
(the CUDA kernels of ``rt_tpu_torch/csrc``) and the readings by kernel."""

from __future__ import annotations

K1 = r"\bmegakernel_flat\b|(^|[\s:])accumulate\("
K5 = r"\bmegakernel_clustered\b"


def kernel_ms(ctx, pattern: str):
    """Device ms per profiled unit of the kernels matching ``pattern``, or
    None where none ran."""
    tr = ctx["trace"]
    seconds = tr.device_seconds(pattern)
    if seconds <= 0.0 or not tr.units:
        return None
    return 1e3 * seconds / tr.units


def idle_pct(ctx):
    tr = ctx["trace"]
    if not tr.ops or tr.window[1] <= tr.window[0]:
        return None
    return tr.idle_pct()
