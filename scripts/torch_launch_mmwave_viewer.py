#!/usr/bin/env python
"""Launch the mmWave viewer with the PyTorch port (twin of ``launch_mmwave_viewer.py``): the Qt window where PyQt6 exists, headless playback otherwise.

The controller's processors run on ``--device`` (default cuda; the CPU
only when asked for); the views draw its host payloads.  With PyQt6 and no
``--export-movie``, the windowed shell opens; otherwise the same pipeline
plays headless, and ``--export-movie`` writes the drawn views to a movie
(mp4, or GIF where no ffmpeg encoder exists).

Example (from the repository root, headless):
    python scripts/torch_launch_mmwave_viewer.py \\
        --dataset-params gui_configs/dataset_params.yaml \\
        --processor-params gui_configs/processor_params.yaml \\
        --export-movie viewer.mp4 --frames 50
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.utils.env import load_env
from mmwave_radar_processing_tpu_torch.utils.logger import setup_logger
from mmwave_radar_processing_tpu_torch.visualization import (
    MmWaveRadarProcessorController,
    get_default_registry,
)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset-params", default="gui_configs/dataset_params.yaml")
    p.add_argument("--processor-params", default="gui_configs/processor_params.yaml")
    p.add_argument("--export-movie", default=None,
                   help="headless: draw the views into a movie at this path")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--views", nargs="*", default=None,
                   help="processor keys to draw (default: the first four)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the processors (default cuda; cpu only when asked for)")
    args = p.parse_args()

    load_env()
    logger = setup_logger()
    controller = MmWaveRadarProcessorController(
        registry=get_default_registry(),
        dataset_params_path=args.dataset_params,
        processor_params_path=args.processor_params,
        device=args.device,
    )

    try:
        import PyQt6  # noqa: F401

        have_qt = True
    except ImportError:
        have_qt = False

    if have_qt and not args.export_movie:
        from mmwave_radar_processing_tpu_torch.visualization.qt_shell import run_qt_viewer

        run_qt_viewer(controller)
        return

    if not args.export_movie:
        logger.info("PyQt6 not available: running headless playback "
                    "(use --export-movie to save the drawn views)")
        n = args.frames or controller.dataset_model.num_frames
        controller.play(0, n)
        logger.info("processed %d frames", n)
        return

    from mmwave_radar_processing_tpu_torch.visualization.video_exporter import VideoExporter

    exporter = VideoExporter(controller, view_keys=args.views)
    n = exporter.export(args.export_movie, 0, args.frames)
    logger.info("exported %d frames", n)


if __name__ == "__main__":
    main()
