"""Radar configuration layer.

Parses TI mmWave-SDK CLI ``.cfg`` files into an immutable :class:`RadarConfig`
and derives radar performance parameters (range/velocity/angle resolution and
bin grids) eagerly at load time.  All derived grids are host ``numpy`` arrays,
constants that the processors and pipelines place on their device once.

The port's own copy of the JAX package's ``config`` layer (numpy only), so
that the port imports nothing of that package.

Reference behavior being matched: ``config_managers/cfgManager.py`` (parser
dispatch :210-264, performance formulas :105-169) in
davidmhunt/mmwave_radar_processing.
"""

from mmwave_radar_processing_tpu_torch.config.manager import (
    ChirpCfg,
    ConfigManager,
    ConfigNotLoaded,
    InvalidConfiguration,
    ProfileCfg,
    RadarConfig,
    load_cfg,
)
from mmwave_radar_processing_tpu_torch.config import grids

__all__ = [
    "ChirpCfg",
    "ConfigManager",
    "ConfigNotLoaded",
    "InvalidConfiguration",
    "ProfileCfg",
    "RadarConfig",
    "load_cfg",
    "grids",
]
