from rts_tpu_torch.utils.timing import trace_annotation
from rts_tpu_torch.utils.validate import SceneValidationError, validate_scene, validate_world

__all__ = [
    "SceneValidationError",
    "trace_annotation",
    "validate_scene",
    "validate_world",
]
