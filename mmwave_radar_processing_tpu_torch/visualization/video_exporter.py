"""Video export: drive the controller frame by frame and encode the drawn view grid (JAX: ``visualization/video_exporter.py``).

A grid of matplotlib views takes the controller's payload stream; each
processed frame is drawn to RGB and appended to an mp4 (libx264, quality
8), or a GIF where no ffmpeg encoder exists.

The two halves are apart: :meth:`VideoExporter.frame_payloads` yields each
frame's payloads (the processors on the controller's device, the payloads
on the host), and :meth:`VideoExporter.export` draws them.  The export
draws on a figure with its own Agg canvas, so it never changes the
process's matplotlib backend; matplotlib and imageio are imported there.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from mmwave_radar_processing_tpu_torch.utils.logger import get_logger
from mmwave_radar_processing_tpu_torch.visualization.views import VIEW_CLASSES


class VideoExporter:
    """Draws the selected processors' views of each frame into a movie.

    After :meth:`export`, ``timings`` holds its frames and its seconds in
    ``device_and_copy_s`` (the controller's frame: the processors and the
    payloads' copies to the host), ``draw_s`` (the views and the canvas)
    and ``encode_s`` (the writer).
    """

    def __init__(self, controller, view_keys: Optional[List[str]] = None,
                 fps: int = 20):
        self.controller = controller
        self.fps = fps
        self.logger = get_logger(__name__)
        self.view_keys = view_keys or self._default_views()
        self.timings: Dict[str, float] = {}

    def _default_views(self) -> List[str]:
        return list(self.controller.processors)[:4]

    def frame_payloads(self, start: int = 0,
                       end: Optional[int] = None) -> Iterator[Tuple[int, Dict[str, dict]]]:
        """``(frame, {view key: payload})`` for each frame in ``[start, end)``, as the views receive them."""
        end = end if end is not None else self.controller.dataset_model.num_frames
        latest: Dict[str, dict] = {}

        def on_update(key, payload):
            if key in self.view_keys:
                latest[key] = payload

        self.controller.subscribe_view_update(on_update)
        try:
            for i in range(start, end):
                latest.clear()
                self.controller.process_next_frame(i)
                yield i, dict(latest)
        finally:
            self.controller.unsubscribe_view_update(on_update)

    def export(self, out_path: str, start: int = 0,
               end: Optional[int] = None) -> int:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        from mmwave_radar_processing_tpu_torch.plotting.movie_generator import (
            _open_writer,
            _open_writer_path,
        )

        out_path = _open_writer_path(out_path, self.logger)
        n_views = len(self.view_keys)
        rows = 1 if n_views <= 2 else 2
        cols = int(np.ceil(n_views / rows))
        fig = Figure(figsize=(5 * cols, 4 * rows))
        canvas = FigureCanvasAgg(fig)
        axes = np.atleast_1d(fig.subplots(rows, cols)).reshape(-1)
        views = {key: VIEW_CLASSES[self.controller.registry[key].view_name](ax=ax)
                 for ax, key in zip(axes, self.view_keys)}

        timings = {"frames": 0, "device_and_copy_s": 0.0, "draw_s": 0.0, "encode_s": 0.0}
        writer = _open_writer(out_path, self.fps)
        try:
            t0 = time.perf_counter()
            for _, payloads in self.frame_payloads(start, end):
                t1 = time.perf_counter()
                for key, payload in payloads.items():
                    views[key].set_data(payload)
                canvas.draw()
                rgb = np.asarray(canvas.buffer_rgba())[..., :3]
                t2 = time.perf_counter()
                writer.append_data(rgb)
                t3 = time.perf_counter()
                timings["frames"] += 1
                timings["device_and_copy_s"] += t1 - t0
                timings["draw_s"] += t2 - t1
                timings["encode_s"] += t3 - t2
                t0 = time.perf_counter()
        finally:
            writer.close()
        self.timings = timings
        self.logger.info("exported %d frames to %s", timings["frames"], out_path)
        return timings["frames"]
