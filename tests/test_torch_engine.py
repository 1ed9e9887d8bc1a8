"""The port's per-pulse engine against rts_tpu: fan, animation, the
wavefront trace on the clustered path, post-processing, compaction and
aggregation.

Tolerances.  rts_tpu's functions here run eagerly (no jit), so XLA rounds
every operation on its own exactly as PyTorch does, and the fan and the
packed triangle fields come out equal; they are held to 2 ulp anyway
(the sin/cos of the two libraries may differ in the last bit).  The
refitted cluster boxes sum three products in an order the two einsum
implementations choose, so they are held to 2 ulp.  The traversal inside
``trace_fan`` is jitted on the JAX side, where XLA contracts a*b + c into
fused multiply-adds: discrete outputs (received, path rows, triangle
sequence, depths) must still be identical, and ray_length / power are held
to rtol 1e-5 / 5e-5 (a few f32 ulp of t, amplified by 1/r^2 for power).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rts_tpu.sim as js
from rts_tpu import Parameters as JParameters
from rts_tpu.aggregate import aggregate_lanes as j_aggregate
from rts_tpu.engine.animate import animate_packed as j_animate
from rts_tpu.engine.compact import received_first_idx as j_first_idx
from rts_tpu.engine.compact import take_lanes as j_take
from rts_tpu.engine.fan import generate_fan_c as j_fan
from rts_tpu.engine.wavefront import trace_fan as j_trace_fan
from rts_tpu.physics.postprocess import postprocess as j_postprocess

import rts_tpu_torch.engine.wavefront as TW
from rts_tpu_torch import convert
from rts_tpu_torch.aggregate import aggregate_lanes as t_aggregate
from rts_tpu_torch.engine.animate import ClusterScene
from rts_tpu_torch.engine.animate import animate_packed as t_animate
from rts_tpu_torch.engine.compact import received_first_idx as t_first_idx
from rts_tpu_torch.engine.compact import take_lanes as t_take
from rts_tpu_torch.engine.fan import generate_fan_c as t_fan
from rts_tpu_torch.engine.wavefront import TraceResult
from rts_tpu_torch.physics.postprocess import postprocess as t_postprocess

torch.set_num_threads(1)

ULP2 = 2.4e-7  # two f32 ulp, relative
C = 299792458.0
DEVICE = "cpu"  # the port's entry points default to the card


@pytest.mark.parametrize(
    "num_rays, tx_dir, span",
    [(1, (0.1, -0.2), (0.1, 0.1, 0.0)), (4, (0.3, 0.2), (0.15, 0.1, 0.0)),
     (9, (0.0, -math.pi / 2), (0.15, 0.15, 0.2))],
)
def test_generate_fan_c_matches(num_rays, tx_dir, span):
    az, el = np.float32(tx_dir[0]), np.float32(tx_dir[1])
    ref = np.asarray(j_fan(num_rays, (jnp.float32(az), jnp.float32(el)), span, dtype=jnp.float32))
    got = t_fan(num_rays, (torch.tensor(az), torch.tensor(el)), span, device=DEVICE).numpy()
    assert got.shape == ref.shape == (3, num_rays**3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ULP2)


def terrain_world(S, pulses=2, n=24, extent=1500.0, peak=450.0):
    """bench.py's terrain scene (BASELINE config 4), cut to ~1k triangles:
    Tx/Rx 4 km above a fractal terrain, a 60 m plate at 400 m.  The steep
    peaks keep a few tiles of rays alive into the third segment, which
    then runs narrow (compact_narrow=-1)."""
    w = S.World()
    down = S.RotationPath(elevation=-math.pi / 2)
    w.add(S.Transmitter(path=S.Path.fixed(0.0, 0.0, 4000.0), wave=S.RadarSignal(carrier=10e9),
                        pulse_count=pulses, prf=1000.0, tx_span=(0.15, 0.15, 0.0), rotation=down))
    w.add(S.Receiver(path=S.Path.fixed(0.0, 0.0, 4000.0), sphere=(25.0, 1.2, 1.2), rotation=down))
    w.add(S.Target(shape="terrain", terrain=(n, extent, peak, 3), path=S.Path.fixed(0.0, 0.0, 0.0),
                   refl_coeff=0.9))
    w.add(S.Target(shape="rect", rect=(2.0, 60.0, 60.0), attitude=S.AttitudePath(pitch=math.pi / 2),
                   path=S.Path.linear([(0.0, (0.0, 0.0, 400.0)), (1.0, (0.0, 5.0, 430.0))]),
                   refl_coeff=0.9))
    return w


@pytest.fixture(scope="module")
def jax_state():
    kw = dict(preset="production", refine=False, cluster_size=128, ray_tile=32, interpret=True)
    return js.prepare_cpi(terrain_world(js), JParameters(num_rays=9, max_refl_depth=2),
                          dtype=jnp.float32, **kw)


def test_animate_packed_matches(jax_state):
    jb, jbat, _, _ = jax_state
    tb, tbat = convert.scene_base(jb, device=DEVICE), convert.pulse_batch(jbat, device=DEVICE)
    for p in range(2):
        ref = j_animate(jb, jbat.rot[p], jbat.pos[p], jbat.vel[p], 128)
        got = t_animate(tb, tbat.rot[p], tbat.pos[p], tbat.vel[p])
        np.testing.assert_allclose(got.tri_pack.numpy(), np.asarray(ref.tri_pack), rtol=ULP2, atol=0)
        for f in ("aabb_mn", "aabb_mx"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                       rtol=ULP2, atol=0, err_msg=f)


def _scene(jsc):
    return ClusterScene(*(convert.tensor(getattr(jsc, f), DEVICE) for f in ClusterScene._fields))


@pytest.fixture(scope="module")
def traced(jax_state):
    """One pulse through both packages' trace_fan on the same animated
    scene, with the narrow late segments (compact_narrow=-1) engaged."""
    jb, jbat, jcfg, jspec = jax_state
    jsc = j_animate(jb, jbat.rot[1], jbat.pos[1], jbat.vel[1], 128)
    tx_span = jspec.kwargs()["tx_span"]
    fan = j_fan(jcfg.num_rays, (jbat.tx_dir[1, 0], jbat.tx_dir[1, 1]), tx_span, dtype=jnp.float32)
    rx1 = type(jbat.rx_geom)(*(a[1] for a in jbat.rx_geom))
    ref = j_trace_fan(jsc, rx1, jbat.tx_origin[1], fan, jcfg)
    widths = []
    real = TW.closest_hit_clustered

    def spy(origin, *a, **k):
        widths.append(origin.shape[1])
        return real(origin, *a, **k)

    TW.closest_hit_clustered = spy
    try:
        got = TW.trace_fan(_scene(jsc), convert.rx_geom(rx1, DEVICE),
                           convert.tensor(jbat.tx_origin[1], DEVICE), convert.tensor(fan, DEVICE),
                           convert.trace_config(jcfg))
    finally:
        TW.closest_hit_clustered = real
    return ref, got, widths, jax_state


def test_trace_fan_matches(traced):
    ref, got, widths, (_, _, jcfg, _) = traced
    n3 = jcfg.rays_per_fan
    # the narrow late segments really ran (fewer lanes than the fan)
    assert widths[0] == n3 and min(widths) < n3
    rec = np.asarray(ref.received)
    assert (rec >= 0).sum() > 0
    for name in ("received", "path", "tri_seq", "refl_depth", "refr_depth", "cap_bits",
                 "cap_root0_bits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.ray_length.numpy(), np.asarray(ref.ray_length), rtol=1e-5)
    np.testing.assert_allclose(got.power.numpy(), np.asarray(ref.power), rtol=5e-5, atol=0)
    np.testing.assert_allclose(got.doppler.numpy(), np.asarray(ref.doppler), rtol=1e-5, atol=1e-6)
    # hit points inherit the error of t along ~4 km paths: 1 cm absolute
    for name in ("first_hit", "prev_hit"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-2, err_msg=name)


def test_postprocess_matches(traced):
    """Post-processing of the same trace result (rts_tpu's, carried over)."""
    ref, _, _, (_, jbat, jcfg, jspec) = traced
    kw = jspec.kwargs()
    spec = convert.cpi_spec(jspec)
    jout = j_postprocess(
        ref, tx_origin=jbat.tx_origin[1], rx_positions=jbat.rx_pos[1], rcs_models=kw["rcs_models"],
        tx_gain=kw["tx_gain"], rx_gains=kw["rx_gains"],
        tx_rotation=(jbat.tx_dir[1, 0], jbat.tx_dir[1, 1]), rx_rotation_fns=kw["rx_rotation_fns"],
        time_t=jbat.times[1], carrier=kw["carrier"], cspeed=kw["cspeed"],
    )
    res = TraceResult(*(convert.tensor(getattr(ref, f), DEVICE) for f in TraceResult._fields))
    tdir = convert.tensor(jbat.tx_dir[1], DEVICE)
    tout = t_postprocess(
        res, tx_origin=convert.tensor(jbat.tx_origin[1], DEVICE),
        rx_positions=convert.tensor(jbat.rx_pos[1], DEVICE),
        rcs_models=spec.rcs_models, tx_gain=spec.tx_gain, rx_gains=spec.rx_gains,
        tx_rotation=(tdir[0], tdir[1]), rx_rotation_fns=spec.rx_rotation_fns,
        time_t=convert.tensor(jbat.times[1], DEVICE), carrier=spec.carrier, cspeed=spec.cspeed,
    )
    for name, a, b in zip(("power", "doppler", "delay"), tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ULP2, atol=0, err_msg=name)


def test_compaction_matches():
    rng = np.random.default_rng(2)
    received = np.where(rng.random(500) < 0.1, rng.integers(0, 3, 500), -1).astype(np.int32)
    vals = rng.normal(size=(2, 500)).astype(np.float32)
    for cap in (8, 64, 600):
        ji = np.asarray(j_first_idx(jnp.asarray(received), cap))
        ti = t_first_idx(torch.as_tensor(received), cap)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(
            t_take(torch.as_tensor(vals), ti, fill=-1).numpy(),
            np.asarray(j_take(jnp.asarray(vals), jnp.asarray(ji), fill=-1)),
        )


@pytest.mark.parametrize("num_rx, depth, seed", [(1, 2, 0), (3, 2, 1), (2, 3, 2)])
def test_aggregate_lanes_matches(num_rx, depth, seed):
    """Groups, representatives and combined values against rts_tpu's
    aggregation on synthetic lanes (direct rays, several receivers and
    targets, repeated path rows).  npath/path_match/emit are exact; the
    sums are taken in another order (pairwise tree vs one-hot matmul), so
    power/delay are held to rtol 1e-6 and Doppler to 1e-3 Hz.  Phase: rts_tpu reduces in
    double-single arithmetic, the port in float64, both rounded to f32 —
    held to 1e-6 rad."""
    rng = np.random.default_rng(seed)
    r, nt = 600, 3
    received = np.where(rng.random(r) < 0.3, rng.integers(0, num_rx, r), -1).astype(np.int32)
    refl = rng.integers(0, depth + 1, r).astype(np.int32)
    refr = np.zeros(r, np.int32)
    path = np.where(np.arange(depth)[:, None] < refl[None, :], rng.integers(0, nt, (depth, r)), -1)
    path = path.astype(np.int32)
    power = rng.uniform(1e-12, 1e-9, r).astype(np.float32)
    ray_length = rng.uniform(500.0, 9000.0, r).astype(np.float32)
    doppler = rng.normal(0.0, 300.0, r).astype(np.float32)
    args = (received, refl, refr, path, power, ray_length, doppler)
    ref = j_aggregate(*(jnp.asarray(a) for a in args), num_rx=num_rx, cspeed=C, carrier=10e9,
                      num_targets=nt, compact_cap=256)
    got = t_aggregate(*(torch.as_tensor(a) for a in args), num_rx=num_rx, cspeed=C, carrier=10e9)
    for name in ("npath", "path_match", "emit"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert np.asarray(ref.emit).sum() > 5 and (np.asarray(ref.npath) > 1).any()
    for name in ("power", "delay"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    # group means of mixed-sign Dopplers cancel: absolute 1e-3 Hz on ~300 Hz
    np.testing.assert_allclose(got.doppler.numpy(), np.asarray(ref.doppler), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got.phase.numpy(), np.asarray(ref.phase), rtol=0, atol=1e-6)
