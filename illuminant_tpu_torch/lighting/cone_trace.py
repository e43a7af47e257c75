"""Cone-trace constants (ConeTrace.fxh:1-29), shared with the scan shadows.

Counterpart of the constants of illuminant_tpu/lighting/cone_trace.py; the
64-step march itself (the exact oracle of the scan) is ROADMAP K12.
"""

MIN_CONE_RADIUS = 0.33
FULLY_SHADOWED_THRESHOLD = 0.075
UNSHADOWED_THRESHOLD = 0.95
HACK_DISTANCE_OFFSET = 1.5
