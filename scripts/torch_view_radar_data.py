#!/usr/bin/env python
"""Inspect one frame of a dataset with the PyTorch port (twin of ``view_radar_data.py``): the processor dashboard to the screen or a file.

Loads a dataset and a radar config, runs one frame through the spectral
processors on ``--device`` (default cuda; the CPU only when asked for) and
draws the 2x3 dashboard on the host.

Example (from the repository root):
    python scripts/torch_view_radar_data.py --dataset sim_radvel \\
        --radar-config configs/6843_RadVel_ods_20Hz.cfg --frame 10 --out frame10.png
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.config import load_cfg
from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_tpu_torch.plotting import PlotterMmWaveData
from mmwave_radar_processing_tpu_torch.processors import (
    DopplerAzimuthProcessor,
    MicroDopplerProcessor,
    RangeAngleProcessor,
    RangeDopplerProcessor,
    VirtualArrayReformatter,
)
from mmwave_radar_processing_tpu_torch.utils.logger import setup_logger


def dashboard(cfg, dataset, frame: int, device):
    """The dashboard figure of ``frame``: the processors on ``device``, the drawing on the host."""
    processors = {
        "range_doppler": RangeDopplerProcessor(cfg, device=device),
        "range_angle": RangeAngleProcessor(cfg, device=device),
        "micro_doppler": MicroDopplerProcessor(cfg, device=device),
        "doppler_azimuth": DopplerAzimuthProcessor(cfg, device=device),
    }
    adc = VirtualArrayReformatter(cfg, device=device).process(dataset.get_radar_adc_data(frame))
    return PlotterMmWaveData(cfg).plot_compilation(
        adc,
        range_doppler=processors["range_doppler"].process(adc, rx_idx=0),
        range_angle=processors["range_angle"].process(adc),
        micro_doppler=processors["micro_doppler"].process(adc),
        doppler_azimuth=processors["doppler_azimuth"].process(adc),
        processors=processors,
    )


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True)
    p.add_argument("--radar-config", default="configs/6843_RadVel_ods_20Hz.cfg")
    p.add_argument("--array-geometry", default="ods")
    p.add_argument("--array-direction", default="down")
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--out", default=None, help="save the dashboard PNG here")
    p.add_argument("--device", default="cuda",
                   help="torch device of the processors (default cuda; cpu only when asked for)")
    args = p.parse_args()

    import matplotlib

    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    logger = setup_logger()
    cfg = load_cfg(args.radar_config, args.array_geometry, args.array_direction)
    logger.info("\n%s", cfg.overview())
    dataset = CpslDS(args.dataset)
    logger.info("dataset: %d frames", dataset.num_frames)

    fig = dashboard(cfg, dataset, args.frame, args.device)
    if args.out:
        fig.savefig(args.out, dpi=100)
        logger.info("wrote %s", args.out)
    else:
        plt.show()


if __name__ == "__main__":
    main()
