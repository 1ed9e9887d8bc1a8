"""A configuration file's scene, built again from its data in float64.

Plain NumPy: the fractal heightfield and the box generator, the attitude
rotation, the motion paths, the transmit fan and the receiver capture
spheres, each written from the published semantics of the radar tracer
(the port's `oracle/` and `geometry/` read the same).  Nothing here
imports the program: the reference builds its own triangles from the
numbers in `benchmark/configs/<config>.json` and the run's seed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SCENE_EPS = float(np.float32(0.005))  # the tracer's float32 literal 0.005f, widened
EARTH_RADIUS = 6378136.0


def fractal_heights(n: int, seed: int, octaves: int = 6, roughness: float = 0.55) -> np.ndarray:
    """Sum of bilinearly upsampled Gaussian octaves, scaled to [0, 1], [n, n]."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, n))
    amp = 1.0
    for o in range(octaves):
        k = min(n, 2 ** (o + 2))
        coarse = rng.standard_normal((k, k))
        xi = np.linspace(0, k - 1, n)
        x0 = np.clip(xi.astype(int), 0, k - 2)
        fx = xi - x0
        lo = coarse[x0][:, x0] * (1 - fx)[None, :] + coarse[x0][:, x0 + 1] * fx[None, :]
        hi = coarse[x0 + 1][:, x0] * (1 - fx)[None, :] + coarse[x0 + 1][:, x0 + 1] * fx[None, :]
        h += amp * (lo * (1 - fx)[:, None] + hi * fx[:, None])
        amp *= roughness
    h -= h.min()
    peak = h.max()
    return h / peak if peak > 0 else h


def rot_zyx(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cy, sy, cp, sp, cr, sr = (math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch),
                              math.cos(roll), math.sin(roll))
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return rz @ ry @ rx


def terrain_triangles(n: int, extent: float, peak: float, seed: int):
    """(corners [T, 3, 3], corner normals [T, 3, 3]) of an n x n vertex
    heightfield over [-extent/2, extent/2]^2, two triangles a cell, smooth
    normals from the central-difference gradient."""
    z = peak * fractal_heights(n, seed)
    xs = np.linspace(-extent / 2, extent / 2, n)
    xv, yv = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([xv, yv, z], axis=-1).reshape(-1, 3)
    step = extent / (n - 1)
    gx = np.gradient(z, step, axis=0)
    gy = np.gradient(z, step, axis=1)
    normals = np.stack([-gx, -gy, np.ones_like(z)], axis=-1).reshape(-1, 3)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    i = np.arange(n - 1)
    ii, jj = np.meshgrid(i, i, indexing="ij")
    v00, v10 = (ii * n + jj).ravel(), ((ii + 1) * n + jj).ravel()
    v01, v11 = (ii * n + jj + 1).ravel(), ((ii + 1) * n + jj + 1).ravel()
    tris = np.concatenate([np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)])
    return verts[tris], normals[tris]


_BOX_SIGNS = np.array([[1, -1, -1], [1, 1, -1], [1, -1, 1], [1, 1, 1],
                       [-1, -1, -1], [-1, 1, -1], [-1, -1, 1], [-1, 1, 1]], dtype=np.float64)
_BOX_TRIS = np.array([[0, 1, 2], [1, 3, 2], [2, 3, 7], [2, 7, 6], [1, 7, 3], [1, 5, 7],
                      [6, 7, 4], [7, 5, 4], [0, 4, 1], [1, 4, 5], [2, 6, 4], [0, 2, 4]])


def box_triangles(w: float, h: float, d: float, rot: np.ndarray):
    """(corners, corner normals) of a w x h x d box turned by ``rot``; every
    corner of a face carries the face's normal."""
    verts = (_BOX_SIGNS * (np.array([w, h, d]) * 0.5)) @ rot.T
    corners = verts[_BOX_TRIS]
    fn = np.cross(corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0])
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
    return corners, np.repeat(fn[:, None, :], 3, axis=1)


def path_position(path, t: np.ndarray) -> np.ndarray:
    """[P, 3] position on a waypoint path ``[[t, [x, y, z]], ...]``: the one
    point of a fixed path, else linear between waypoints, clamped at the ends."""
    ts = np.array([w[0] for w in path], np.float64)
    ps = np.array([w[1] for w in path], np.float64)
    t = np.asarray(t, np.float64)
    if len(ts) == 1:
        return np.broadcast_to(ps[0], t.shape + (3,)).copy()
    tc = np.clip(t, ts[0], ts[-1])
    i = np.clip(np.searchsorted(ts, tc, side="right") - 1, 0, len(ts) - 2)
    u = (tc - ts[i]) / (ts[i + 1] - ts[i])
    return ps[i] + (ps[i + 1] - ps[i]) * u[:, None]


def fan_directions(num_rays: int, azimuth: float, elevation: float, span) -> np.ndarray:
    """[N^3, 3] launch directions, lane = iz*N^2 + iy*N + ix: a Cartesian
    grid between the beam's corner vectors, turned about z by the azimuth
    and about the turned y axis by the elevation (with the tracer's
    reversed sine signs); not normalised after the turns."""
    n = num_rays
    sph = lambda a, e: np.array([math.cos(a) * math.cos(e), math.sin(a) * math.cos(e), math.sin(e)])
    if n == 1:
        return sph(azimuth, elevation)[None]
    az_span, el_span, launch_range = (float(s) for s in span)
    start, end = sph(-az_span / 2, -el_span / 2), sph(az_span / 2, el_span / 2)
    i = np.arange(n, dtype=np.float64)
    dx = start[0] + (end[0] * (1 + launch_range) - start[0]) / (n - 1) * i
    dy = start[1] + (end[1] - start[1]) / (n - 1) * i
    dz = start[2] + (end[2] - start[2]) / (n - 1) * i
    d = np.stack(np.broadcast_arrays(dx[None, None, :], dy[None, :, None], dz[:, None, None]), -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c, s = math.cos(azimuth), math.sin(azimuth)
    rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    d = d @ rz.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x, y, z = rz[:, 1] / np.linalg.norm(rz[:, 1])
    c, s = math.cos(elevation), math.sin(elevation)
    oc = 1.0 - c
    r1 = np.array([[c + x * x * oc, x * y * oc + z * s, x * z * oc - y * s],
                   [y * x * oc - z * s, c + y * y * oc, y * z * oc + x * s],
                   [z * x * oc + y * s, z * y * oc - x * s, c + z * z * oc]])
    return d @ r1.T


@dataclasses.dataclass
class CaptureSphere:
    """A receiver's capture sphere and its (theta, phi) acceptance window,
    centred on the receiver as seen from the sphere's centre."""

    centre: np.ndarray  # [3]
    radius: float
    min_theta: float
    max_theta: float
    min_phi: float
    max_phi: float


def capture_sphere(position, azimuth: float, elevation: float, sphere) -> CaptureSphere:
    """The sphere sits its radius along the boresight.  The tracer takes the
    boresight's cosines and sines, and the window's centre angles, in
    float32 (``cosf``, ``sinf``, ``atan2f``) and the products in double."""
    f = np.float32
    radius, th_span, ph_span = (float(s) for s in sphere)
    ce, se = float(np.cos(f(elevation), dtype=f)), float(np.sin(f(elevation), dtype=f))
    ca, sa = float(np.cos(f(azimuth), dtype=f)), float(np.sin(f(azimuth), dtype=f))
    pos = np.asarray(position, np.float64)
    centre = pos + np.array([(radius * ce) * ca, (radius * ce) * sa, radius * se])
    d = pos - centre
    theta0 = float(np.arctan2(f(d[1]), f(d[0]), dtype=f))
    phi0 = float(np.arctan2(f(d[2]), f(math.sqrt(d[0] ** 2 + d[1] ** 2)), dtype=f))
    return CaptureSphere(centre, radius, theta0 - th_span / 2, theta0 + th_span / 2,
                         phi0 - ph_span / 2, phi0 + ph_span / 2)


@dataclasses.dataclass
class Scene:
    """The scene of one configuration and seed, in float64."""

    corners: np.ndarray  # [T, 3, 3] at the t=0 attitude, target-centred
    normals: np.ndarray  # [T, 3, 3] corner normals
    target: np.ndarray  # [T] target index
    refl: np.ndarray  # [NT] reflection coefficients
    refr: np.ndarray  # [NT] refractive indices (1.0 unless the file gives one)
    paths: list  # per target, its waypoint path
    tx: dict
    rx: list
    params: dict
    sample_time: float

    def pulse_times(self, pulses: int) -> np.ndarray:
        return np.arange(pulses, dtype=np.float64) / float(self.tx["prf"])

    def motion(self, times: np.ndarray):
        """([P, NT, 3] target centres, [P, NT, 3] velocities by a forward
        difference over the CW sample time)."""
        pos = np.stack([path_position(p, times) for p in self.paths], 1)
        ahead = np.stack([path_position(p, times + self.sample_time) for p in self.paths], 1)
        return pos, (ahead - pos) / self.sample_time


def build_scene(config: dict, seed: int) -> Scene:
    """The scene a configuration file describes, with its terrain drawn from
    ``seed``.  Targets keep a fixed attitude (no rotation rates).  The
    tracer's refraction cap is 0 (reflections only) or 2 (a chain refracts
    into a target and out of it again)."""
    corners, normals, target = [], [], []
    for j, t in enumerate(config["targets"]):
        att = t.get("attitude", {})
        rot = rot_zyx(att.get("yaw", 0.0), att.get("pitch", 0.0), att.get("roll", 0.0))
        if t["shape"] == "terrain":
            g = t["terrain"]
            c, nrm = terrain_triangles(int(g["n"]), float(g["extent"]), float(g["peak"]), seed)
            c, nrm = c @ rot.T, nrm @ rot.T
        elif t["shape"] == "rect":
            c, nrm = box_triangles(*t["rect"], rot)
        else:
            raise ValueError(f"the reference builds terrain and rect targets, not {t['shape']!r}")
        corners.append(c)
        normals.append(nrm)
        target.append(np.full(len(c), j))
    params = config["params"]
    if int(params.get("max_refr_depth", 0)) not in (0, 2):
        raise ValueError(f"max_refr_depth is 0 or 2 in the tracer, not {params['max_refr_depth']!r}")
    return Scene(
        corners=np.concatenate(corners), normals=np.concatenate(normals), target=np.concatenate(target),
        refl=np.array([float(t["refl_coeff"]) for t in config["targets"]]),
        refr=np.array([float(t.get("refr_index", 1.0)) for t in config["targets"]]),
        paths=[t["path"] for t in config["targets"]], tx=config["transmitter"],
        rx=[capture_sphere(r["position"], r["azimuth"], r["elevation"], r["sphere"]) for r in config["receivers"]],
        params=params, sample_time=1.0 / float(params["cw_sample_rate"]),
    )
