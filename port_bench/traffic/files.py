"""Files traffic: a recording served from NPY files, one complex64 frame a file, as CPSL datasets hold them.

The mix gives ``frames``, ``batch``, ``loader_threads`` and ``altitude``.
Set-up makes the frames on the device from the seed, writes them as
``frame_<i>.npy`` (``[rx, samples, chirps]`` complex64) into a fresh
directory under the run's temporary directory, flushed to disk, and draws one batch of
RANSAC draws, which every batch of the recording uses (``gumbel[:b]``).
It serves the recording once through the program's recording path
(``parallel/recording.process_recording``, mode ``2d``: point clouds and
ego-velocity at a fixed altitude), which also brings the files into the
page cache.

The window serves the whole recording again and again, each pass a call
that ends with its outputs on the host.  ``file_frames_per_s`` is every
frame served over the wall time of the whole window; the program's
``StageTimer`` spans of every pass are summed for the feed's metrics.

The check samples frames of the last pass; the reference reads their files
with NumPy and computes them itself.  ``close`` removes the directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from port_bench.gen import scene
from port_bench.lib import compare
from port_bench.lib.trace import span
from port_bench.traffic.bulk import RANSAC_TRIALS, build_pipeline, reference_numbers, sample


class Run:
    UNITS = {"file_frames_per_s": "frames/s"}

    def __init__(self, ctx):
        from mmwave_radar_processing_tpu_torch.utils.profiling import StageTimer

        cell = self.cell = ctx.cell
        self.seed, self.device = ctx.seed, ctx.device
        mix = cell.mix
        self.n, self.batch = int(mix["frames"]), int(mix["batch"])
        self.threads, self.altitude = int(mix["loader_threads"]), float(mix["altitude"])
        self.dir = tempfile.mkdtemp(prefix="port_bench_files_")
        self.paths = [os.path.join(self.dir, f"frame_{i:05d}.npy") for i in range(self.n)]
        re, im, _ = scene.frames(cell.radar, self.n, ctx.seed, ctx.device)
        for s in range(0, self.n, 256):
            block = torch.complex(re[s:s + 256], im[s:s + 256]).cpu().numpy()
            for i, frame in enumerate(block):
                np.save(self.paths[s + i], frame)
        del re, im
        os.sync()  # the write-back happens here, not inside the window
        self.draws = scene.gumbel((self.batch, 2, RANSAC_TRIALS, cell.radar.loops),
                                  scene.draws_seed(ctx.seed), ctx.device)
        self.cfg = ctx.port_config()
        self.pipeline = build_pipeline("combined", self.cfg, cell.config["processing"],
                                       ctx.device)
        self.call = ctx.program(self.pipeline, "combined")
        self.timer = StageTimer()
        self.out = self._serve(StageTimer())

    def _serve(self, timer) -> dict:
        from mmwave_radar_processing_tpu_torch.parallel.recording import process_recording

        with torch.no_grad():
            return process_recording(self.paths, self.cfg, mode="2d", batch=self.batch,
                                     altitude=self.altitude, loader_threads=self.threads,
                                     device=self.device, gumbel=self.draws, timer=timer,
                                     pipeline=self.call)

    def window(self, window) -> dict:
        passes = 0
        window.start()
        while True:
            with span("serve"):
                self.out = self._serve(self.timer)
            passes += 1
            if window.done(self.n):
                break
        wall = window.finish()
        frames = passes * self.n
        t = self.timer.totals
        return {"file_frames_per_s": frames / wall, "attempted": frames, "failed": 0,
                "load_wait_s": t.get("load_wait", 0.0), "wall_s": t.get("wall", 0.0)}

    def release(self) -> None:
        del self.pipeline, self.call
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        idx = sample(self.n, int(self.cell.spec["sample_frames"]), self.seed)
        frames = np.stack([np.load(self.paths[i]) for i in idx])
        re = torch.from_numpy(np.ascontiguousarray(frames.real, np.float32)).to(self.device)
        im = torch.from_numpy(np.ascontiguousarray(frames.imag, np.float32)).to(self.device)
        alt = torch.full((len(idx),), self.altitude, dtype=torch.float32, device=self.device)
        draws = self.draws[torch.as_tensor(idx % self.batch, device=self.device)]
        with torch.no_grad():
            nums = reference_numbers(self.cell, re, im, alt, draws, self.out["points"][idx],
                                     self.out["valid"][idx], self.out["velocity"][idx])
        return compare.checks(nums, self.cell.spec["limits"])

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
