"""Carry state from ``rts_tpu`` (the JAX reference) into this package.

Each function takes the JAX package's object and returns the port's, with
every array leaf read through ``np.asarray`` and placed on ``device`` (the
card unless the caller asks for another).
Nothing here imports jax: the leaves are array-likes that NumPy reads.
The tests use these to feed identical state to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rts_tpu_torch.aggregate import LaneAggregate
from rts_tpu_torch.engine.animate import SceneBase
from rts_tpu_torch.engine.cpi import CpiResult, CpiSpec, PulseBatch, RefineExtras
from rts_tpu_torch.engine.types import DeviceScene, RxGeomDevice, TraceConfig
from rts_tpu_torch.physics import antenna, rcs
from rts_tpu_torch.sim.paths import RotationPath


def tensor(a, device="cuda", dtype=None):
    """np.asarray(a) as a tensor on ``device`` (dtype kept unless given)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def f64(hi, lo, device="cuda"):
    """A double-single pair (f32 value + f32 residual) summed in float64."""
    return tensor(np.asarray(hi, np.float64) + np.asarray(lo, np.float64), device)


def scene_base(jbase, device="cuda") -> SceneBase:
    """rts_tpu.engine.animate.SceneBase, with its cluster boxes when it was
    built with ``cluster_size=`` (the brute-force/f64 base has none); its
    replay residuals (``with_lo=True``) become the port's f64 fields."""
    fields = [f for f in SceneBase._fields if not f.endswith("_f64")]
    base = SceneBase(*(None if getattr(jbase, f) is None else tensor(getattr(jbase, f), device)
                       for f in fields))
    if jbase.tri_verts_lo is None:
        return base
    return base._replace(
        tri_verts_f64=f64(jbase.tri_verts, jbase.tri_verts_lo, device),
        tri_corner_normals_f64=f64(jbase.tri_corner_normals, jbase.tri_corner_normals_lo, device),
        target_refl_f64=f64(jbase.target_refl, jbase.target_refl_lo, device),
        target_refr_f64=f64(jbase.target_refr, jbase.target_refr_lo, device),
    )


def device_scene(jscene, device="cuda") -> DeviceScene:
    """rts_tpu.engine.types.DeviceScene (``scene_to_device`` or
    ``animate_scene``), field for field."""
    return DeviceScene(*(tensor(getattr(jscene, f), device) for f in DeviceScene._fields))


def rx_geom(jrx, device="cuda") -> RxGeomDevice:
    """rts_tpu.engine.types.RxGeomDevice (a PulseBatch's, or one pulse's
    from ``RxGeomDevice.from_host``), field for field."""
    return RxGeomDevice(*(tensor(getattr(jrx, f), device) for f in RxGeomDevice._fields))


def refine_extras(jbatch, device="cuda") -> RefineExtras:
    """The f64 replay state of an rts_tpu PulseBatch built with refine=True:
    each hi + lo pair of its ``RefineExtras`` summed in float64."""
    x = jbatch.refine
    return RefineExtras(
        rot=f64(jbatch.rot, x.rot_lo, device), pos=f64(jbatch.pos, x.pos_lo, device),
        vel=f64(jbatch.vel, x.vel_lo, device), tx_origin=f64(jbatch.tx_origin, x.txo_lo, device),
        rx_centre=f64(jbatch.rx_geom.centre, x.rxc_lo, device),
        rx_radius=f64(jbatch.rx_geom.radius, x.rxr_lo, device),
        fan_rot=f64(x.fan_rot_hi, x.fan_rot_lo, device), bore=f64(x.bore_hi, x.bore_lo, device),
    )


def pulse_batch(jbatch, device="cuda") -> PulseBatch:
    """rts_tpu.engine.cpi.PulseBatch, with its replay extras when it has them."""
    return PulseBatch(*(
        rx_geom(jbatch.rx_geom, device) if f == "rx_geom" else tensor(getattr(jbatch, f), device)
        for f in PulseBatch._fields if f != "refine"
    ), refine=None if jbatch.refine is None else refine_extras(jbatch, device))


def trace_config(jcfg) -> TraceConfig:
    return TraceConfig(**dataclasses.asdict(jcfg))


def _model(obj, module):
    """The port's model class of the same name, with the same fields."""
    return getattr(module, type(obj).__name__)(**dataclasses.asdict(obj))


def cpi_spec(jspec) -> CpiSpec:
    """rts_tpu.engine.cpi.CpiSpec -> CpiSpec with the port's physics models
    (same class names and parameters) and receiver rotation paths."""
    kw = jspec.kwargs()
    rot_fns = tuple(
        RotationPath(**dataclasses.asdict(fn.__self__)).azel for fn in kw["rx_rotation_fns"]
    )
    return CpiSpec(
        tx_span=tuple(kw["tx_span"]),
        rcs_models=tuple(_model(m, rcs) for m in kw["rcs_models"]),
        tx_gain=_model(kw["tx_gain"], antenna),
        rx_gains=tuple(_model(g, antenna) for g in kw["rx_gains"]),
        rx_rotation_fns=rot_fns,
        carrier=kw["carrier"],
        cspeed=kw["cspeed"],
        num_rx=kw["num_rx"],
    )


def lane_aggregate(jagg, device="cuda") -> LaneAggregate:
    """rts_tpu.aggregate.LaneAggregate, field for field (a missing
    ``phase_lo`` becomes zeros, as the port's aggregation writes them)."""
    fields = {f: getattr(jagg, f) for f in LaneAggregate._fields}
    if fields["phase_lo"] is None:
        fields["phase_lo"] = np.zeros_like(np.asarray(fields["phase"]))
    return LaneAggregate(**{f: tensor(a, device) for f, a in fields.items()})


def cpi_result(jout, device="cuda") -> CpiResult:
    """rts_tpu.engine.cpi.CpiResult (a traced CPI), field for field: feeds
    one trace to both packages' renders."""
    return CpiResult(*(lane_aggregate(jout.agg, device) if f == "agg" else tensor(getattr(jout, f), device)
                       for f in CpiResult._fields))
