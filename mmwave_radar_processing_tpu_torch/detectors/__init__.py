"""CFAR detector objects + registry (CA/GO/SO/OS, 1D and 2D) (JAX: ``detectors/``).

Object facades over the threshold maps in
:mod:`mmwave_radar_processing_tpu_torch.ops.cfar`, mirroring the reference's
``detectors/`` package API (``detect`` + cached ``thresholds`` /
``detections`` / ``noise_estimates``, and its registry names).  Every class
takes an explicit ``device``.
"""

from mmwave_radar_processing_tpu_torch.detectors.cfar_detectors import (
    BaseCFAR1D,
    BaseCFAR2D,
    CaCFAR1D,
    CaCFAR2D,
    GoCFAR1D,
    OsCFAR1D,
    OsCFAR2D,
    SoCFAR1D,
    get_detector_registry,
)

__all__ = [
    "BaseCFAR1D",
    "BaseCFAR2D",
    "CaCFAR1D",
    "CaCFAR2D",
    "GoCFAR1D",
    "SoCFAR1D",
    "OsCFAR1D",
    "OsCFAR2D",
    "get_detector_registry",
]
