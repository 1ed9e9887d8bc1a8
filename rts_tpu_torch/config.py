"""Global simulation parameters.

TPU-native replacement for the external ``rsParameters`` singleton the
reference reads (ray_tracer.cpp:600-648): a plain frozen dataclass passed
explicitly, instead of global state.  CamelCase accessors mirror the
reference API surface for drop-in familiarity.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Simulation-wide knobs.

    Attributes mirror rsParameters (reference call sites in parentheses):
      * ``num_rays`` — rays per axis of the N×N×N launch fan
        (GetRTSVariables().x, ray_tracer.cpp:601).
      * ``max_refl_depth`` — user-facing max reflections per ray
        (GetRTSVariables().y, ray_tracer.cpp:602).  The device "stop index"
        is ``max_refl_depth + 1`` (ray_tracer.cpp:776).
      * ``max_refr_depth`` — max refractions; any nonzero request is
        clamped to exactly 2 (ray_tracer.cpp:604-606).
      * ``c`` — propagation speed (rsParameters::c(), :645).
      * ``start_time`` — simulation start (:646).
      * ``cw_sample_rate`` — CW sample rate used to finite-difference
        target velocity (:647; default 1 kHz per the reference comment).
      * ``interpolate_smooth`` — smooth-normal interpolation toggle (:648).
    """

    num_rays: int = 1
    max_refl_depth: int = 1
    max_refr_depth: int = 0
    c: float = 299792458.0
    start_time: float = 0.0
    cw_sample_rate: float = 1000.0
    interpolate_smooth: bool = True

    def __post_init__(self):
        if self.num_rays < 1:
            raise ValueError("num_rays must be >= 1")
        if self.max_refl_depth < 0 or self.max_refr_depth < 0:
            raise ValueError("depths must be >= 0")
        # Reference quirk: refraction depth is forced to 0 or 2
        # (ray_tracer.cpp:604-606) — 1 refraction would leave the ray
        # trapped inside the target.
        if self.max_refr_depth > 0:
            object.__setattr__(self, "max_refr_depth", 2)

    # ---- derived sizes -------------------------------------------------

    @property
    def rays_per_fan(self) -> int:
        """N^3 primary rays per launch (ray_tracer.cu:150)."""
        return self.num_rays**3

    @property
    def ray_slot_multiplier(self) -> int:
        """Static result-buffer slots per primary ray.

        1 without refraction; ``max_refl_depth + 3`` with refraction:
        primary chain + trapped chain + (max_refl_depth + 1) exit slots
        (ray_tracer.cpp:608-623).
        """
        if self.max_refr_depth == 2:
            return self.max_refl_depth + 3
        return 1

    @property
    def ray_total(self) -> int:
        """Total static ray slots incl. refraction fan-out
        (ray_tracer.cpp:626)."""
        return self.ray_slot_multiplier * self.rays_per_fan

    @property
    def depth_total(self) -> int:
        """Columns of the per-ray path / RCS-angle matrices
        (ray_tracer.cpp:655)."""
        return self.max_refl_depth + self.max_refr_depth

    @property
    def sample_time(self) -> float:
        """Velocity finite-difference step (ray_tracer.cpp:647)."""
        return 1.0 / self.cw_sample_rate

    # ---- reference-shaped accessors ------------------------------------

    def GetRTSVariables(self):
        return (self.num_rays, self.max_refl_depth, self.max_refr_depth)

    def C(self):  # noqa: N802 — reference API parity
        return self.c

    def StartTime(self):  # noqa: N802
        return self.start_time

    def CwSampleRate(self):  # noqa: N802
        return self.cw_sample_rate

    def InterpolateSmooth(self):  # noqa: N802
        return self.interpolate_smooth
