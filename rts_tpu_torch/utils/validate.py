"""Scene and configuration validation — fail loudly before the device.

The reference's only failure handling is abort-on-error macros and
exit() on unreadable mesh files (SURVEY.md §5).  Here problems are
caught on the host with actionable messages: NaN/Inf geometry,
degenerate triangles, non-unit normals, empty worlds, and physically
inconsistent materials.  A NumPy copy of ``rts_tpu.utils.validate``
(host arrays: ``compile_scene``'s ``SceneArrays`` and the ``World``).
"""

from __future__ import annotations

from typing import List

import numpy as np


class SceneValidationError(ValueError):
    pass


def validate_scene(scene, *, strict: bool = False) -> List[str]:
    """Check a SceneArrays; returns warnings, raises on hard errors."""
    warnings: List[str] = []
    tv = scene.tri_verts[: scene.num_real_tris]
    if not np.isfinite(tv).all():
        raise SceneValidationError("scene contains NaN/Inf vertex coordinates")
    if not np.isfinite(scene.tri_normals[: scene.num_real_tris]).all():
        raise SceneValidationError("scene contains NaN/Inf normals")

    if scene.num_real_tris:
        e0 = tv[:, 1] - tv[:, 0]
        e1 = tv[:, 0] - tv[:, 2]
        area2 = np.linalg.norm(np.cross(e1, e0), axis=1)
        degen = int((area2 <= 0.0).sum())
        if degen:
            warnings.append(f"{degen} zero-area triangles (never hittable)")

        nrm = scene.tri_normals[: scene.num_real_tris].reshape(-1, 3)
        lengths = np.linalg.norm(nrm, axis=1)
        bad = int((np.abs(lengths - 1.0) > 1e-6).sum())
        if bad:
            warnings.append(f"{bad} non-unit shading normals (will be renormalised)")

    refl = np.asarray(scene.target_refl_coeff)
    if (np.abs(refl) > 1.0).any():
        warnings.append("reflection coefficient |refl| > 1 (gain on bounce)")
    refr = np.asarray(scene.target_refr_index)
    if (refr <= 0.0).any():
        raise SceneValidationError("refractive index must be positive")

    if strict and warnings:
        raise SceneValidationError("; ".join(warnings))
    return warnings


def validate_world(world, params) -> List[str]:
    """Check a World + Parameters before running."""
    warnings: List[str] = []
    if not world.transmitters:
        raise SceneValidationError("world has no transmitters")
    if not world.receivers:
        raise SceneValidationError("world has no receivers")
    if not world.targets:
        warnings.append("world has no targets (only direct Tx->Rx paths possible)")
    for tx in world.transmitters:
        if tx.wave is None or tx.wave.GetCarrier() <= 0:
            raise SceneValidationError(f"transmitter {tx.name!r}: carrier must be positive")
        span = tx.GetTxSpan()
        if len(span) != 3 or span[0] < 0 or span[1] < 0:
            raise SceneValidationError(f"transmitter {tx.name!r}: invalid tx_span {span}")
    for rx in world.receivers:
        r = rx.GetRxSphere()
        if r[0] <= 0:
            raise SceneValidationError(f"receiver {rx.name!r}: sphere radius must be positive")
    if params.num_rays % 2 == 0 and params.num_rays > 1:
        warnings.append(
            "even num_rays: the fan has no exact boresight ray "
            "(monostatic specular returns may vanish)"
        )
    return warnings
