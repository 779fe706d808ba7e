"""Progressive refinement with checkpoint and resume (rt_tpu/progressive.py).

Reference analog: the preview render thread (window.rs:224-326): a fixed
pass schedule [1, 2, 4, 8, ..., 256] (237 passes, 40,055 spp), each pass
rendering every pixel at ``ns`` samples and blending into the image by
sample count, with per-sweep and cumulative Mray/s prints.

As in the JAX package:
- the accumulator is f32 (the reference blends through its u8 display
  buffer, window.rs:279-310), and ``state.accum`` is a host array that
  holds every finished sweep.  On the card the sum lives on the device:
  each sweep is added into it there by ``csrc/sweep_sum.cu``, and the sum
  is copied into one pinned host buffer, reused, which backs
  ``state.accum`` (read-only there: the next sweep's copy would overwrite a
  write).  On the CPU ``state.accum`` is the accumulator itself;
- the state (accum, total_spp, pass_index, seed) is checkpointed to .npz
  and resumes exactly; the keys are the JAX package's, so a checkpoint
  written by either package resumes in the other;
- per-sweep metrics are printed and appended as JSONL;
- by default every pass reuses sample indices 0..ns (the reference's
  Halton indexing, camera.rs:315-325), while the draws differ per pass
  through the pass key ``rng.fold_in(rng.key(seed), pass)``.

Engines: "wavefront" (the default) sweeps with ``wavefront.render_wavefront``
(K3, or K4 on a clustered scene, on the card); "mega" with the megakernel
(K1, or K5 on a clustered scene), falling back to the wavefront where the
scene is eligible for neither.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from rt_tpu_torch import _build, megakernel, profiling, rng
from rt_tpu_torch.camera import Camera
from rt_tpu_torch.config import ProgressiveSchedule, RenderConfig
from rt_tpu_torch.profiling import MetricsLog, ProgressBar, ThroughputTimer
from rt_tpu_torch.render import _device
from rt_tpu_torch.scene import SceneData
from rt_tpu_torch.wavefront import render_wavefront


# Sweeps summed by the sweep-sum kernel, as megakernel.LAUNCHES counts K1's
# launches: read by tests and chip_smoke.py; stays 0 on the CPU.
DEVICE_SUMS = 0


def accumulate_sweep(accum: torch.Tensor, colors: torch.Tensor, ns: int) -> None:
    """``accum += colors * ns`` in place, as two rounded f32 operations (the
    host's numpy sum, bit for bit).  ``colors``: one value per element of
    ``accum`` (any shape of that size), on its device.  On a card, one
    launch of the sweep-sum kernel on the current stream (one count of
    DEVICE_SUMS), with no synchronization; on the CPU, the plain two-op
    form.  Raises on anything else."""
    global DEVICE_SUMS
    device = accum.device
    colors = colors.reshape(accum.shape)
    if device.type == "cpu":
        accum += colors * ns
        return
    if device.type != "cuda":
        raise ValueError(f"no sweep sum for device {device}")
    _build.require(accum, "accum", device)
    _build.require(colors, "colors", device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _build.library().rt_sweep_accumulate(colors.data_ptr(), accum.data_ptr(),
                                                   accum.numel(), int(ns), stream)
    if err != 0:
        raise RuntimeError(f"sweep-sum launch failed with CUDA error {err}")
    DEVICE_SUMS += 1


@dataclasses.dataclass
class ProgressiveState:
    """``accum``: the host array of every finished sweep's sum.  On the CPU
    it is the accumulator itself.  On a card it mirrors the device's
    accumulator, refreshed after each sweep, and is read-only: a write into
    it would be overwritten by the next sweep's fetch, so it raises instead
    (``ProgressiveRenderer.load_checkpoint`` is how a sum goes in)."""

    accum: np.ndarray  # f32[H, W, 3] sum of (pass mean * pass spp)
    total_spp: int
    pass_index: int

    @property
    def image(self) -> np.ndarray:
        """The current linear estimate (valid after any sweep)."""
        return self.accum / max(self.total_spp, 1)


class ProgressiveRenderer:
    """Drives the sweep schedule; owns the accumulator and checkpointing."""

    def __init__(
        self,
        scene: SceneData,
        camera: Camera,
        cfg: RenderConfig,
        schedule: ProgressiveSchedule | None = None,
        checkpoint_path: str | None = None,
        metrics_path: str | None = None,
        reuse_sample_indices: bool = True,
        progress: bool = False,
        engine: str = "wavefront",
        checkpoint_every: int = 1,
        device="cuda",
    ):
        """``engine``: "wavefront" or "mega" (see the module docstring).
        ``checkpoint_every``: sweeps between checkpoint writes (the final
        sweep always writes).  ``device``: where the sweeps run; the scene's
        tables are moved there."""
        if engine not in ("wavefront", "mega"):
            raise ValueError(f"unknown engine {engine!r}")
        self.device = _device(device)
        self.scene = scene.to(self.device)
        self.camera = camera
        self.cfg = cfg
        self.passes = (schedule or ProgressiveSchedule.reference()).passes()
        self.checkpoint_path = checkpoint_path
        self.reuse_sample_indices = reuse_sample_indices
        self.checkpoint_every = max(int(checkpoint_every), 1)
        if engine == "mega" and not (megakernel.eligible(scene, cfg)
                                     or megakernel.eligible_clustered(scene, cfg)):
            engine = "wavefront"
        self.engine = engine
        h, w = camera.image_height, camera.image_width
        # The accumulator, on the sweeps' device, and the host tensor behind
        # state.accum: the same tensor on the CPU; on a card a pinned buffer
        # (torch's caching host allocator hands a later renderer the same
        # block) that receives the sum after each sweep.
        self._accum = torch.zeros((h, w, 3), dtype=torch.float32, device=self.device)
        self._host = (self._accum if self.device.type == "cpu" else
                      torch.zeros((h, w, 3), dtype=torch.float32, pin_memory=True))
        host_view = self._host.numpy()
        if self._host is not self._accum:
            host_view.setflags(write=False)
        self.state = ProgressiveState(host_view, 0, 0)
        self._timer = ThroughputTimer(w, h)
        self._metrics = MetricsLog(metrics_path)
        self._bar = ProgressBar(len(self.passes)) if progress else None
        self._pixel_idx = torch.arange(w * h, dtype=torch.int32, device=self.device)
        if checkpoint_path and os.path.exists(checkpoint_path):
            self.load_checkpoint(checkpoint_path)

    # -- sweeps ------------------------------------------------------------

    def step(self) -> dict | None:
        """Render one sweep; returns its metrics, or None when done."""
        i = self.state.pass_index
        if i >= len(self.passes):
            return None
        ns = self.passes[i]

        with profiling.span("progressive.step", i):
            self._timer.begin_sweep()
            # Reference quirk: jitter indices restart at 0 every pass
            # (camera.rs:317-320); the draws differ through the pass key.
            offset = 0 if self.reuse_sample_indices else self.state.total_spp
            key = rng.fold_in(rng.key(self.cfg.seed), i)
            with profiling.span("progressive.dispatch"):
                if self.engine == "mega":
                    colors = megakernel.render_megakernel(self.scene, self.camera, self.cfg, ns,
                                                          offset, rng.key_seed(key))
                else:
                    colors = render_wavefront(self.scene, self.camera, self._pixel_idx, self.cfg,
                                              ns, offset, key)
            with profiling.span("progressive.accumulate"):
                accumulate_sweep(self._accum, colors, ns)
            with profiling.span("progressive.fetch"):
                # The sum to the host, behind the sweep and its sum on the
                # stream; the wait makes a sweep end with its pixels there.
                # (On the CPU state.accum is the accumulator: nothing to do.)
                if self._host is not self._accum:
                    self._host.copy_(self._accum, non_blocking=True)
                    torch.cuda.current_stream(self.device).synchronize()
            sweep_mray, cum_mray = self._timer.end_sweep(ns)
            self.state.total_spp += ns
            self.state.pass_index += 1

            metrics = {
                "sweep": i + 1,
                "sweep_spp": ns,
                "total_spp": self.state.total_spp,
                "sweep_s": self._timer.sweep_s,
                "mray_per_s": sweep_mray,
                "cumulative_mray_per_s": cum_mray,
            }
            with profiling.span("progressive.report"):
                # Reference-parity print (window.rs:264-269, 319-324).
                print(
                    f"On sweep {i + 1} adding {ns} sample(s) for a total of "
                    f"{self.state.total_spp} sample(s) per pixel"
                )
                print(
                    f"Rendered sweep {i + 1} at {metrics['mray_per_s']:.1f} million "
                    f"rays/second, overall speed: {metrics['cumulative_mray_per_s']:.1f} Mray/s"
                )
                self._metrics.log(**metrics)
                if self._bar is not None:
                    self._bar.update(self.state.pass_index,
                                     f"{self.state.total_spp} spp, {sweep_mray:.1f} Mray/s")
            if self.checkpoint_path and (
                self.state.pass_index % self.checkpoint_every == 0
                or self.state.pass_index >= len(self.passes)
            ):
                self.save_checkpoint(self.checkpoint_path)
        return metrics

    def run(
        self,
        max_passes: int | None = None,
        on_sweep: Callable[[np.ndarray, dict], None] | None = None,
        should_stop: Callable[[], bool] | None = None,
    ) -> np.ndarray:
        """Run sweeps until the schedule (or ``max_passes``) is exhausted.
        ``on_sweep(image, metrics)`` fires after each sweep; ``should_stop``
        is the closing-flag analog (window.rs:271)."""
        done = 0
        while max_passes is None or done < max_passes:
            if should_stop is not None and should_stop():
                break
            metrics = self.step()
            if metrics is None:
                break
            done += 1
            if on_sweep is not None:
                on_sweep(self.state.image, metrics)
        return self.state.image

    # -- checkpointing (SURVEY.md §5.4) ------------------------------------

    def save_checkpoint(self, path: str) -> None:
        tmp = path + ".tmp"
        with profiling.span("progressive.checkpoint"):
            np.savez(
                tmp,
                accum=self.state.accum,
                total_spp=self.state.total_spp,
                pass_index=self.state.pass_index,
                seed=self.cfg.seed,
            )
            os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``path``: its sum goes into the host buffer behind
        ``state.accum`` (the same array object) and up to the device's
        accumulator."""
        with np.load(path) as data:
            if int(data["seed"]) != self.cfg.seed:
                raise ValueError(
                    f"checkpoint {path} was written with seed {int(data['seed'])}, not "
                    f"{self.cfg.seed}: resuming would repeat sample indices"
                )
            if data["accum"].shape != self.state.accum.shape:
                raise ValueError(f"checkpoint {path} holds a {data['accum'].shape} image, not "
                                 f"{self.state.accum.shape}")
            self._host.copy_(torch.from_numpy(data["accum"]))
            self.state.total_spp = int(data["total_spp"])
            self.state.pass_index = int(data["pass_index"])
        if self._host is not self._accum:
            self._accum.copy_(self._host)
