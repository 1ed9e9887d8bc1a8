"""Physical and numerical constants shared by the engine and the oracle.

Parity notes vs the reference (file:line cites into the RTS sources):
  * ``SCENE_EPS`` / ``SCENE_EPS_R`` are declared as ``0.005f`` (float32
    literals) in ray_tracer.h:9-10 and are promoted to double in every
    comparison, so the value used everywhere is the float32 rounding of
    0.005, not 0.005 exactly.  We reproduce that rounding.
  * ``EARTH_RADIUS`` is the 6,378,136 m sphere used for ray termination
    (ray_tracer.cu:447).
"""

import numpy as np

# Minimum segment length for incident/refracted rays (ray_tracer.h:9).
SCENE_EPS: float = float(np.float32(0.005))
# Minimum segment length for reflected rays (ray_tracer.h:10).
SCENE_EPS_R: float = float(np.float32(0.005))

# Earth modelled as a sphere centred on the scene origin (ray_tracer.cu:447).
EARTH_RADIUS: float = 6378136.0

# Default propagation speed; the reference reads it from rsParameters::c()
# (ray_tracer.cpp:645) which FERS defaults to the SI speed of light.
SPEED_OF_LIGHT: float = 299792458.0

# Sentinel written into the RCS-angle buffers before a launch
# (ray_tracer.cpp:865-866).
RCS_ANGLE_SENTINEL: float = -1000000.0

# "Not received" marker for a ray (ray_tracer.h:26).
NOT_RECEIVED: int = -1
