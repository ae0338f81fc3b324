"""Antenna sub-arrays of the ADC-domain velocity estimator (JAX: ``processors/velocity_estimator.py``).

Only the constants the velocity pipeline needs are here: the ODS geometry's
two azimuth and two elevation 4-antenna sub-arrays, as virtual channel
indices (``v = cfg*num_rx + rx``).  The estimator class itself is not
ported yet.
"""

ODS_AZ_SETS_VIRTUAL = ([0, 3, 4, 7], [1, 2, 5, 6])
ODS_EL_SETS_VIRTUAL = ([10, 11, 6, 7], [9, 8, 5, 4])
