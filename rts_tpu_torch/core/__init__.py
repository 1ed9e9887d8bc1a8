from rts_tpu_torch.core import constants, rotation, vec
from rts_tpu_torch.core.constants import (
    EARTH_RADIUS,
    SCENE_EPS,
    SCENE_EPS_R,
    SPEED_OF_LIGHT,
)

__all__ = [
    "constants",
    "rotation",
    "vec",
    "EARTH_RADIUS",
    "SCENE_EPS",
    "SCENE_EPS_R",
    "SPEED_OF_LIGHT",
]
