"""The bounce loop's shading kernel (``csrc/shade.cu``, launched by
``engine.wavefront.shade_cuda``) where there is no card: CPU tensors,
float64 state and the parity engine take the plain ``_process_miss`` and
``_process_hit`` and count no kernel call; a segment the kernel does not
take raises before anything is checked or built; the wrapper hands the
library the operands its C signature names; and no kernel of the repo but
the traversal's own is read as the traversal by the benchmark.  The kernel
itself is held to the plain programs on the card
(tests/test_torch_kernel.py, marker ``gpu``).  This file imports neither
jax nor rts_tpu.
"""

import contextlib
import ctypes
import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.readers import TRAVERSAL_KERNELS
from rts_tpu_torch.accel import cluster_reorder
from rts_tpu_torch.core.constants import EARTH_RADIUS, SCENE_EPS, SCENE_EPS_R
from rts_tpu_torch.engine import wavefront as W
from rts_tpu_torch.engine.animate import animate_packed, scene_base
from rts_tpu_torch.engine.fan import generate_fan_c
from rts_tpu_torch.engine.intersect import HitResult
from rts_tpu_torch.engine.types import DeviceScene, RxGeomDevice, TraceConfig, scene_to_device
from rts_tpu_torch.geometry import rect_mesh, sphere_mesh
from rts_tpu_torch.geometry.scene import compile_scene
from rts_tpu_torch.ops import cluster_trace as TCT
from rts_tpu_torch.utils import timing

_CSRC = Path(TCT.__file__).resolve().parent / "csrc"
CS = 128


def _shade_calls() -> int:
    return timing.counters().get("shade.calls", 0)


def _compiled(cs=CS):
    mesh, _ = sphere_mesh(2, 50.0)
    plate = rect_mesh(2.0, 300.0, 300.0).translated([600.0, 0.0, 0.0])
    scene = compile_scene([mesh.translated([900.0, 200.0, 0.0]), plate], [0.9, 0.5], [1.0, 1.5],
                          [np.array([0.0, 10.0, 0.0]), np.zeros(3)])
    return cluster_reorder(scene, cluster_size=cs)


def _cluster_scene():
    base = scene_base(_compiled(), CS, device="cpu")
    return animate_packed(base, torch.eye(3).repeat(2, 1, 1), torch.zeros((2, 3)), torch.ones((2, 3)))


def _rx(num_rx=2, dtype=torch.float32):
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64)[:num_rx], dtype=dtype)
    return RxGeomDevice(f([[0.0, 0.0, 0.0], [900.0, 0.0, 50.0]] * 16), f([20.0, 40.0] * 16),
                        f([-0.5, 2.0] * 16), f([0.5, -2.0] * 16), f([-2.0, -0.3] * 16), f([0.3, 2.0] * 16))


@pytest.mark.parametrize("dtype, accel", [(torch.float32, "cluster"), (torch.float32, "brute"),
                                          (torch.float64, "brute")], ids=["f32_cluster", "f32_brute", "f64_brute"])
def test_cpu_state_takes_the_plain_programs(dtype, accel, monkeypatch):
    """A trace on CPU tensors, float32 or float64, clustered or brute force,
    never reaches the kernel's wrapper and counts no shade.calls."""
    monkeypatch.setattr(W, "shade_cuda", lambda *a, **k: pytest.fail("took the shading kernel"))
    cfg = TraceConfig(num_rays=5, max_refl_dev=3, max_refr_dev=2, accel=accel, cluster_size=CS, ray_tile=64,
                      sub_tiles=4, candidates=16, mt_group=4, tri_chunk=256)
    scene = _cluster_scene() if accel == "cluster" else scene_to_device(_compiled(), dtype, "cpu")
    fan = generate_fan_c(cfg.num_rays, [0.0, 0.0], [0.3, 0.3, 0.0], dtype=dtype, device="cpu")
    calls = _shade_calls()
    res = W.trace_fan(scene, _rx(dtype=dtype), [0.0, 0.0, 0.0], fan, cfg)
    assert _shade_calls() == calls
    assert int((res.refl_depth > 0).sum()) > 10


@pytest.mark.parametrize("device, dtype, parity, kernel", [
    ("cuda", torch.float32, False, True),
    ("cuda", torch.float64, False, False),
    ("cuda", torch.float32, True, False),
    ("cuda", torch.float64, True, False),
    ("cpu", torch.float32, False, False),
    ("cpu", torch.float64, False, False),
])
def test_which_state_the_kernel_shades(device, dtype, parity, kernel):
    """The kernel shades float32 state on a CUDA device, outside the
    parity engine; float64 state (the f64 engine, the parity preset) and
    CPU tensors keep the plain programs on any device."""
    leaf = SimpleNamespace(device=torch.device(device), dtype=dtype)
    cfg = TraceConfig(num_rays=3, max_refl_dev=3, max_refr_dev=0, strict_parity=parity)
    assert W.shade_on_card(leaf, cfg) is kernel


def _segment(lanes=40, rows=None, num_rx=2, n_tris=6, n_targets=2):
    """A segment's operands on the CPU (a DeviceScene of zeros)."""
    cfg = TraceConfig(num_rays=3, max_refl_dev=3, max_refr_dev=2, interpolate_smooth=False)
    state = W._init_state(cfg, torch.zeros(3), torch.randn(3, lanes, generator=torch.Generator().manual_seed(0)))
    rows = state.origin.shape[1] if rows is None else rows
    bufs = W.TraceBuffers(path=torch.full((cfg.depth_total, rows), -1, dtype=torch.int32),
                          rcs=torch.zeros((2, cfg.depth_total, rows)))
    n = state.origin.shape[1]
    hit = HitResult(t=torch.full((n,), math.inf), tri=torch.zeros(n, dtype=torch.int32), beta=torch.zeros(n),
                    gamma=torch.zeros(n), found=torch.zeros(n, dtype=torch.bool))
    z3 = torch.zeros((n_tris, 3))
    scene = DeviceScene(z3, z3, z3, z3, z3, z3, torch.zeros(n_tris), torch.zeros((n_tris, 3, 3)),
                        torch.zeros(n_tris, dtype=torch.int32), torch.ones(n_targets), torch.ones(n_targets),
                        torch.zeros((n_targets, 3)))
    return state, bufs, hit, scene, _rx(num_rx), torch.zeros(3), cfg


# what the kernel does not take: (lanes, rows, receivers, triangles, targets)
_REFUSED = {
    "no_lane": (0, 0, 2, 6, 2),
    "buffers_narrower_than_the_lanes": (40, 39, 2, 6, 2),
    "more_receivers_than_capture_bits": (40, 40, 32, 6, 2),
    "no_triangle": (40, 40, 2, 0, 2),
    "no_target": (40, 40, 2, 6, 0),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_refused_segments_raise_before_a_check_or_a_build(case, monkeypatch):
    """A segment outside the kernel's limits raises ValueError in
    shade_shape, and shade_cuda raises it before it checks an operand or
    loads the library."""
    lanes, rows, num_rx, n_tris, n_targets = _REFUSED[case]
    with pytest.raises(ValueError):
        W.shade_shape(lanes, rows, num_rx, n_tris, n_targets)
    monkeypatch.setattr(TCT, "_load", lambda: pytest.fail("loaded the kernel"))
    monkeypatch.setattr(TCT, "_check", lambda *a: pytest.fail("checked operands"))
    state, bufs, hit, scene, rx, tx, cfg = _segment(lanes, rows, num_rx, n_tris, n_targets)
    with pytest.raises(ValueError):
        W.shade_cuda(state, bufs, hit, scene, rx, tx, cfg)


def test_shade_shape_of_the_cells():
    """The terrain cell's 63^3 lanes, the dielectric cell's three slots of
    them (in buffers of five) and the split's 31^3 are taken, and one lane
    with 31 receivers, the most the capture bits hold."""
    assert W.shade_shape(250_047, 250_047, 1, 999_936, 2) is None
    assert W.shade_shape(750_141, 1_250_235, 2, 1_000_064, 2) is None
    assert W.shade_shape(29_791, 29_791, 1, 999_936, 2) is None
    assert W.shade_shape(1, 1, 31, 1, 1) is None


class _Lib:
    """Stands in for the library: records shade_launch's arguments."""

    def __init__(self):
        self.args = None

    def shade_launch(self, *args):
        self.args = args
        self.tx = list((ctypes.c_float * 3).from_address(args[34]))  # read while the operands live
        return 0


def _c_signature():
    """shade_launch's parameters in csrc/shade.cu, as ctypes types."""
    src = (_CSRC / "shade.cu").read_text()
    params = re.search(r'extern "C" int shade_launch\((.*?)\)\s*\{', src, re.S).group(1)
    kinds = []
    for p in (p.strip() for p in params.split(",")):
        kinds.append(ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float") else ctypes.c_int)
    return kinds


def test_binding_matches_the_c_signature(monkeypatch):
    """_load binds shade_launch with the argument types of its C signature,
    one for one (a pointer or the stream a void pointer)."""
    class Fn:
        argtypes = restype = None

    fake = SimpleNamespace(mt_traverse_launch=Fn(), mt_traverse_sweep_words=Fn(), phase1_launch=Fn(),
                           shade_launch=Fn())
    monkeypatch.setattr(TCT._Kernel, "lib", None)
    monkeypatch.setattr(TCT, "build_kernel", lambda: Path("unbuilt.so"))
    monkeypatch.setattr(TCT.ctypes, "CDLL", lambda path: fake)
    assert TCT._load() is fake
    assert fake.shade_launch.argtypes == _c_signature()
    assert fake.shade_launch.restype is ctypes.c_int


# the normal source of each scene: (the table, lane stride, component stride, mode bits)
_SOURCES = ("cluster_gather", "cluster_emit", "cluster_flat", "device_smooth", "device_flat")


@pytest.mark.parametrize("miss_only", [False, True], ids=["whole", "miss_half"])
@pytest.mark.parametrize("source", _SOURCES)
def test_wrapper_hands_the_library_a_segment(source, miss_only, monkeypatch):
    """shade_cuda passes the lane state, the hit record, the scene's normal
    table with its strides and mode bits, the per-target tables, the
    receivers, the transmitter and the buffers, in the C signature's
    order, the Python scalars as float32, and counts one shade.calls."""
    lib = _Lib()
    monkeypatch.setattr(TCT, "_load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: SimpleNamespace(cuda_stream=0))
    smooth = not source.endswith("flat")
    cfg = TraceConfig(num_rays=3, max_refl_dev=3, max_refr_dev=0, interpolate_smooth=smooth, rcs_angles=True)
    clustered = source.startswith("cluster")
    scene = _cluster_scene() if clustered else scene_to_device(_compiled(), torch.float32, "cpu")
    n_tris = scene.tri_target.shape[0]
    lanes = 70
    state = W._init_state(cfg, torch.zeros(3), torch.randn(3, lanes, generator=torch.Generator().manual_seed(2)))
    bufs = W.TraceBuffers(path=torch.full((cfg.depth_total, lanes + 5), -1, dtype=torch.int32),
                          rcs=torch.zeros((2, cfg.depth_total, lanes + 5)))
    shade = torch.zeros((10, lanes + 8))[:, :lanes] if source == "cluster_emit" else None
    hit = HitResult(t=torch.ones(lanes), tri=torch.zeros(lanes, dtype=torch.int32), beta=torch.zeros(lanes),
                    gamma=torch.zeros(lanes), found=torch.ones(lanes, dtype=torch.bool), shade=shade)
    rx, tx = _rx(), torch.tensor([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])[:, 0]  # a strided view
    calls = _shade_calls()
    out = W.shade_cuda(state, bufs, hit, scene, rx, tx, cfg, miss_only)
    assert out[0] is state and out[1] is bufs and _shade_calls() == calls + 1
    args = lib.args
    assert [type(a) for a in args[:37]] == [int] * 37 and len(args) == len(_c_signature())
    s = state
    want = [s.origin, s.direction, s.seg_dir, s.tmin, s.ray_length, s.power, s.doppler, s.refr_prev, s.refr_cur,
            s.refl_depth, s.refr_depth, s.received, s.first_hit, s.end, s.active, s.tri_seq, s.cap_bits,
            s.cap_root0_bits, hit.t, hit.tri, hit.beta, hit.gamma, hit.found]
    assert list(args[:23]) == [x.data_ptr() for x in want]
    # (smooth, shade_rows, tab_by_lane) as the C signature's modes
    table, ts, cs, modes = {
        "cluster_gather": lambda: (scene.shade_pack, 10, 1, (1, 1, 0)),
        "cluster_emit": lambda: (shade, 1, lanes + 8, (1, 1, 1)),
        "cluster_flat": lambda: (scene.tri_pack, 1, n_tris, (0, 0, 0)),
        "device_smooth": lambda: (scene.tri_corner_normals, 9, 1, (1, 0, 0)),
        "device_flat": lambda: (scene.tri_n, 3, 1, (0, 0, 0)),
    }[source]()
    assert args[23] == table.data_ptr() and args[24] == scene.tri_target.data_ptr()
    assert args[25] == (scene.rot if clustered else scene.target_vel).data_ptr()
    assert args[26:28] == (scene.target_refl.data_ptr(), scene.target_vel.data_ptr())
    assert list(args[28:34]) == [x.data_ptr() for x in rx]
    assert lib.tx == [1.0, 2.0, 3.0] and args[35:37] == (bufs.path.data_ptr(), bufs.rcs.data_ptr())
    ints = args[37:53]
    assert ints == (lanes, lanes + 5, cfg.tri_seq_width, cfg.depth_total, 2, n_tris, 2, 3, 0, ts, cs,
                    int(miss_only), 1, *modes)
    f32 = lambda x: float(np.float32(x))
    assert [f32(x) for x in args[53:58]] == [f32(SCENE_EPS), f32(SCENE_EPS_R), f32(EARTH_RADIUS**2),
                                             f32(4.0 * math.pi), f32((4.0 * math.pi) ** 2)]


@pytest.mark.parametrize("refraction", [False, True], ids=["reflect", "refract"])
def test_a_trace_checks_its_tables_once(refraction, monkeypatch):
    """trace_fan on state the kernel shades makes the scene's, receivers'
    and transmitter's operands once (shade_tables) and hands the same
    tables to every segment's launch: the miss half of each spawn segment
    with refraction on, the whole segment otherwise."""
    made, seen = [], []
    tables = W.shade_tables

    def counted(*a):
        made.append(tables(*a))
        return made[-1]

    def launch(state, bufs, hit, scene, rx, tx_origin, cfg, miss_only=False, tables=None):
        seen.append((tables, miss_only))
        state = W._process_miss(state, state.active & ~hit.found, rx, tx_origin, cfg)
        if miss_only:
            return state, bufs
        return W._process_hit(state, bufs, hit, state.active & hit.found, scene, tx_origin, cfg,
                              state.origin.shape[1], spawn=False)

    monkeypatch.setattr(W, "shade_on_card", lambda x, cfg: True)
    monkeypatch.setattr(W, "shade_tables", counted)
    monkeypatch.setattr(W, "shade_cuda", launch)
    cfg = TraceConfig(num_rays=5, max_refl_dev=3, max_refr_dev=2 if refraction else 0, accel="cluster",
                      cluster_size=CS, ray_tile=64, sub_tiles=4, candidates=16, mt_group=4)
    fan = generate_fan_c(cfg.num_rays, [0.0, 0.0], [0.3, 0.3, 0.0], device="cpu")
    W.trace_fan(_cluster_scene(), _rx(), [0.0, 0.0, 0.0], fan, cfg)
    assert len(made) == 1 and all(t is made[0] for t, _ in seen)
    spawns = 2 if refraction else 0
    assert [m for _, m in seen] == [True] * spawns + [False] * (len(seen) - spawns)
    assert len(seen) == cfg.num_segments


def test_in_place_fields_must_not_share_memory(monkeypatch):
    """The kernel writes the lane state in place, so two fields on one
    storage raise before the library loads."""
    monkeypatch.setattr(TCT, "_load", lambda: pytest.fail("loaded the kernel"))
    state, bufs, hit, scene, rx, tx, cfg = _segment()
    state = state._replace(seg_dir=state.direction)
    with pytest.raises(ValueError, match="share memory"):
        W.shade_cuda(state, bufs, hit, scene, rx, tx, cfg)


def _globals(path):
    return re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?(?:void\s+)?(\w+)\s*\(",
                      path.read_text())


def test_the_shading_kernel_is_not_read_as_the_traversal():
    """benchmark/readers.py matches TRAVERSAL_KERNELS as substrings of
    device kernel names into mt_traverse_roofline: the shading kernel's
    name matches none of them, and no kernel in csrc/ but the traversal's
    own two does."""
    names = {p.name: _globals(p) for p in sorted(_CSRC.glob("*.cu"))}
    assert names["shade.cu"] == ["shade_kernel"]
    for file, kernels in names.items():
        for name in kernels:
            hits = [k for k in TRAVERSAL_KERNELS if k in name]
            assert not hits or (file == "mt_traverse.cu" and name in TRAVERSAL_KERNELS), (file, name)
