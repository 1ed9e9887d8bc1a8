"""Receiver-sphere placement and angular acceptance windows.

Host-side NumPy equivalent of ray_tracer.cpp:894-918 (and its batched
device form, ``rx_sphere_geometry_device``): each receiver is a
sphere of radius r whose centre sits a distance r along the receiver's
boresight from the receiver position; the acceptance window is the
(theta, phi) span centred on the *receiver position* as seen from the
sphere centre (i.e. the back of the sphere faces the boresight).

Parity quirk: the reference computes the centre with float32 trig
(``cosf``/``sinf``/``atan2f``, ray_tracer.cpp:903-910) on double inputs;
``strict_parity`` reproduces that narrowing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RxSphereGeometry:
    centre: np.ndarray  # [NR, 3]
    radius: np.ndarray  # [NR]
    min_theta: np.ndarray  # [NR]
    max_theta: np.ndarray  # [NR]
    min_phi: np.ndarray  # [NR]
    max_phi: np.ndarray  # [NR]


def rx_sphere_geometry(
    rx_pos: np.ndarray,  # [NR, 3] receiver positions
    rx_azimuth: np.ndarray,  # [NR] boresight azimuth at pulse time
    rx_elevation: np.ndarray,  # [NR] boresight elevation at pulse time
    sphere_radius: np.ndarray,  # [NR]
    theta_span: np.ndarray,  # [NR] acceptance span in theta
    phi_span: np.ndarray,  # [NR] acceptance span in phi
    *,
    strict_parity: bool = True,
) -> RxSphereGeometry:
    rx_pos = np.asarray(rx_pos, dtype=np.float64).reshape(-1, 3)
    az = np.asarray(rx_azimuth, dtype=np.float64)
    el = np.asarray(rx_elevation, dtype=np.float64)
    r = np.asarray(sphere_radius, dtype=np.float64)

    if strict_parity:
        # cosf/sinf: float32 argument, float32 evaluation (cpp:903-905) —
        # but the PRODUCTS are evaluated in double (the float results are
        # promoted before multiplying with the double radius), so widen to
        # f64 immediately after the narrowed trig call.
        cos_el = np.cos(np.float32(el), dtype=np.float32).astype(np.float64)
        sin_el = np.sin(np.float32(el), dtype=np.float32).astype(np.float64)
        cos_az = np.cos(np.float32(az), dtype=np.float32).astype(np.float64)
        sin_az = np.sin(np.float32(az), dtype=np.float32).astype(np.float64)
    else:
        cos_el, sin_el, cos_az, sin_az = np.cos(el), np.sin(el), np.cos(az), np.sin(az)

    # left-associated like the C++ expression: (r * cosf(el)) * cosf(az)
    centre = rx_pos + np.stack(
        [(r * cos_el) * cos_az, (r * cos_el) * sin_az, r * sin_el], axis=-1
    )

    # Receiver position in spherical coords relative to the sphere centre
    # (cpp:907-910); atan2f is float32.
    d = rx_pos - centre
    if strict_parity:
        theta0 = np.arctan2(
            d[:, 1].astype(np.float32), d[:, 0].astype(np.float32), dtype=np.float32
        ).astype(np.float64)
        phi0 = np.arctan2(
            d[:, 2].astype(np.float32),
            np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2).astype(np.float32),
            dtype=np.float32,
        ).astype(np.float64)
    else:
        theta0 = np.arctan2(d[:, 1], d[:, 0])
        phi0 = np.arctan2(d[:, 2], np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2))

    th_span = np.asarray(theta_span, dtype=np.float64)
    ph_span = np.asarray(phi_span, dtype=np.float64)
    return RxSphereGeometry(
        centre=centre,
        radius=r,
        min_theta=theta0 - th_span / 2,
        max_theta=theta0 + th_span / 2,
        min_phi=phi0 - ph_span / 2,
        max_phi=phi0 + ph_span / 2,
    )


def rx_sphere_geometry_device(
    rx_pos,  # [..., 3] receiver positions (any leading batch shape)
    rx_azimuth,  # [...]
    rx_elevation,  # [...]
    sphere_radius,  # [...]
    theta_span,  # [...]
    phi_span,  # [...]
    dtype=torch.float32,
    device="cuda",
) -> RxSphereGeometry:
    """Sphere placement and acceptance windows on the device, batched.

    The device-tensor analogue of the reference's per-pulse host loop
    (ray_tracer.cpp:894-925): the whole [P, NR] pulse x receiver geometry
    evaluates in a few device operations, leaving host prep flat in pulse
    count.  Same math as :func:`rx_sphere_geometry` without the float32
    trig parity narrowing, in ``dtype`` (the inputs are rounded to it
    first, as ``rts_tpu``'s ``jnp.asarray(x, dtype)``); returns an
    ``RxSphereGeometry`` of tensors on ``device`` with the input batch
    shape.  Incompatible with ``refine=True``: ``prepare_cpi`` keeps the
    host prep there, as ``rts_tpu`` does for its replay's residuals.
    """
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    rx_pos, az, el, r = t(rx_pos), t(rx_azimuth), t(rx_elevation), t(sphere_radius)
    cos_el, sin_el = torch.cos(el), torch.sin(el)
    cos_az, sin_az = torch.cos(az), torch.sin(az)
    offset = torch.stack([(r * cos_el) * cos_az, (r * cos_el) * sin_az, r * sin_el], dim=-1)
    centre = rx_pos + offset
    d = rx_pos - centre
    theta0 = torch.atan2(d[..., 1], d[..., 0])
    phi0 = torch.atan2(d[..., 2], torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2))
    th2 = t(theta_span) / 2
    ph2 = t(phi_span) / 2
    return RxSphereGeometry(
        centre=centre,
        radius=r,
        min_theta=theta0 - th2,
        max_theta=theta0 + th2,
        min_phi=phi0 - ph2,
        max_phi=phi0 + ph2,
    )
