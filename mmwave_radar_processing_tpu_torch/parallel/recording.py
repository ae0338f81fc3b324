"""Serve a recording through a frame-batched pipeline (JAX: the loop of ``scripts/process_recording.py``).

:func:`process_recording` reads a CPSL recording's raw ADC frames in
batches with the NPY loader (``data.native_loader``), runs each batch
through one of three pipelines and gathers what ``scripts/process_recording.py``
saves, with the same keys and dtypes:

- ``mode="2d"``: the combined pipeline; ``points``, ``valid`` and
  ``velocity``, every frame's velocity window centred on ``altitude``;
- ``mode="points"``: the point-cloud pipeline; ``points`` and ``valid``;
- ``mode="ground"``: the altimeter-gated ground scan; ``points``, ``valid``
  and ``altitude``, the tracker's ``final_altitude`` carried from one batch
  into the next.

The last batch is not padded to the batch size (eager PyTorch needs no
static shapes); each frame's output equals the JAX script's.  ``gumbel``
(``[batch, 2, 20, ransac_rows]``) hands the velocity fit its RANSAC draws,
``gumbel[:b]`` for a last batch of ``b`` frames; without it the pipeline
draws from its own seeded generator.

On a CUDA device the feed overlaps the work: batch ``k + 1`` loads on a host
thread into pinned memory while batch ``k`` computes, its copy to the device
runs on a side stream (``non_blocking``, an event the compute stream waits
on), and each batch's outputs go back into pinned host arrays on the compute
stream, so that nothing waits for the device until the last batch.  A
loader slot is refilled only after the event behind its copy has completed.

``timer`` (a :class:`~..utils.profiling.StageTimer`) receives, per batch:
``load`` (the loader thread's host seconds), ``load_wait`` (the seconds the
caller waited for it), ``h2d`` and ``compute`` (device seconds between CUDA
events; on the CPU, host seconds of the call); and once per run: ``wall``
(host seconds from the first load to the last output, items = frames) and,
on CUDA, ``device_busy`` (the union of the copy and compute streams' event
intervals, the busy share being its total over ``wall``'s).  Under
``torch.profiler`` the waits and copies are the spans ``mmw.feed.load_wait``
and ``mmw.feed.h2d``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_tpu_torch.data.native_loader import SplitFramePrefetcher
from mmwave_radar_processing_tpu_torch.parallel.full_pipeline import build_full_pipeline
from mmwave_radar_processing_tpu_torch.parallel.ground_pipeline import (
    build_ground_point_cloud_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.pipeline import build_point_cloud_pipeline
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device
from mmwave_radar_processing_tpu_torch.utils.profiling import StageTimer, annotate

MODES = ("2d", "points", "ground")


def build_recording_pipeline(cfg: RadarConfig, mode: str, *, max_dets: int = 128, device):
    """The pipeline the JAX script builds for ``mode`` (its default CFAR, antennas and angles)."""
    if mode == "2d":
        return build_full_pipeline(cfg, max_dets=max_dets, device=device)
    if mode == "points":
        return build_point_cloud_pipeline(cfg, max_dets=max_dets, device=device)
    if mode == "ground":
        return build_ground_point_cloud_pipeline(cfg, max_dets=max_dets, device=device)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _union_seconds(intervals_ms) -> float:
    """Length of the union of ``[start, end]`` intervals (ms), in seconds."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals_ms):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


class _Outputs:
    """The recording's outputs, gathered batch by batch (pinned host arrays on CUDA)."""

    def __init__(self, mode: str, n: int, max_dets: int, pin_memory: bool):
        shapes = {"points": ((n, max_dets, 4), torch.float32),
                  "valid": ((n, max_dets), torch.bool)}
        if mode == "2d":
            shapes["velocity"] = ((n, 3), torch.float32)
        if mode == "ground":
            shapes["altitude"] = ((n,), torch.float32)
        self.arrays = {key: torch.empty(shape, dtype=dtype, pin_memory=pin_memory)
                       for key, (shape, dtype) in shapes.items()}

    def put(self, start: int, values: dict) -> None:
        for key, value in values.items():
            dst = self.arrays[key][start:start + len(value)]
            dst.copy_(value, non_blocking=value.device.type == "cuda")

    def numpy(self) -> dict:
        return {key: t.numpy() for key, t in self.arrays.items()}


def process_recording(
    recording: Union[CpslDS, Sequence[str]],
    cfg: RadarConfig,
    *,
    mode: str = "2d",
    batch: int = 64,
    altitude: float = 1.2,
    max_dets: int = 128,
    loader_threads: int = 8,
    device,
    gumbel: Optional[torch.Tensor] = None,
    timer: Optional[StageTimer] = None,
    backend: str = "native",
    pipeline=None,
) -> dict:
    """Serve a recording (a ``CpslDS`` or its frame files in order) in batches of ``batch``.

    Returns ``{"points", "valid"}`` numpy arrays over every frame, with
    ``"velocity"`` (``mode="2d"``) or ``"altitude"`` (``mode="ground"``).
    ``backend`` is the loader's (``"native"`` or ``"numpy"``); ``pipeline``
    a pipeline built for ``mode`` on ``device`` to reuse (by default
    :func:`build_recording_pipeline`'s).
    """
    device = resolve_device(device)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    paths: List[str] = list(recording._files["radar_adc"] if isinstance(recording, CpslDS)
                            else recording)
    if not paths:
        raise ValueError("the recording holds no radar frames")
    if pipeline is None:
        pipeline = build_recording_pipeline(cfg, mode, max_dets=max_dets, device=device)
    timer = timer if timer is not None else StageTimer()
    on_cuda = device.type == "cuda"
    frame_shape = (cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    fetcher = SplitFramePrefetcher(paths, frame_shape, batch=batch, nthreads=loader_threads,
                                   pin_memory=on_cuda, backend=backend)
    outputs = _Outputs(mode, len(paths), max_dets, pin_memory=on_cuda)
    altitudes = torch.full((batch,), float(altitude), dtype=torch.float32, device=device)
    if gumbel is not None:
        gumbel = torch.as_tensor(gumbel, dtype=torch.float32).to(device)
        if gumbel.shape[0] < min(batch, len(paths)):
            raise ValueError(f"gumbel holds {gumbel.shape[0]} frames' draws, batch is {batch}")
    copy_stream = torch.cuda.Stream(device) if on_cuda else None
    compute_stream = torch.cuda.current_stream(device) if on_cuda else None

    def event():
        return torch.cuda.Event(enable_timing=True)

    def run(re_d, im_d, b, carry):
        if mode == "2d":
            pc, vel = pipeline(re_d, im_d, altitudes[:b],
                               gumbel=None if gumbel is None else gumbel[:b])
            return {"points": pc.points, "valid": pc.valid, "velocity": vel.velocity}, carry
        if mode == "points":
            pc = pipeline(re_d, im_d)
            return {"points": pc.points, "valid": pc.valid}, carry
        out = pipeline(re_d, im_d, init_altitude=carry)
        return ({"points": out.points, "valid": out.valid, "altitude": out.altitude},
                out.final_altitude)

    batch_events = []  # CUDA: (copy start, copy end, compute start, compute end)
    carry, start = None, 0
    t_start = time.perf_counter()
    if on_cuda:
        origin = event()
        origin.record(compute_stream)
    batches = iter(fetcher)
    while True:
        t0 = time.perf_counter()
        try:
            with annotate("mmw.feed.load_wait"):
                re_h, im_h = next(batches)
        except StopIteration:
            break
        b = re_h.shape[0]
        timer.record("load_wait", time.perf_counter() - t0, b)
        if on_cuda:
            c0, c1, k0, k1 = event(), event(), event(), event()
            with annotate("mmw.feed.h2d"), torch.cuda.stream(copy_stream):
                c0.record()
                re_d = re_h.to(device, non_blocking=True)
                im_d = im_h.to(device, non_blocking=True)
                c1.record()
            fetcher.release(c1)
            compute_stream.wait_event(c1)
            # allocated on the copy stream, used on the compute stream
            re_d.record_stream(compute_stream)
            im_d.record_stream(compute_stream)
            k0.record(compute_stream)
            values, carry = run(re_d, im_d, b, carry)
            outputs.put(start, values)
            k1.record(compute_stream)
            batch_events.append((c0, c1, k0, k1))
        else:
            t1 = time.perf_counter()
            values, carry = run(re_h, im_h, b, carry)
            outputs.put(start, values)
            timer.record("compute", time.perf_counter() - t1, b)
        start += b
    if on_cuda:
        compute_stream.synchronize()
    timer.record("wall", time.perf_counter() - t_start, start)
    counts = [len(chunk) for chunk in
              (paths[i:i + batch] for i in range(0, len(paths), batch))]
    for seconds, b in zip(fetcher.load_seconds, counts):
        timer.record("load", seconds, b)
    if on_cuda:
        intervals = []
        for (c0, c1, k0, k1), b in zip(batch_events, counts):
            timer.record("h2d", c0.elapsed_time(c1) / 1e3, b)
            timer.record("compute", k0.elapsed_time(k1) / 1e3, b)
            intervals += [(origin.elapsed_time(c0), origin.elapsed_time(c1)),
                          (origin.elapsed_time(k0), origin.elapsed_time(k1))]
        timer.record("device_busy", _union_seconds(intervals), start)
    return outputs.numpy()
