"""The pulse x ray split on 3 spawned gloo ranks: rts_tpu's mid-shape case
(a 15^3 fan in three ray blocks of 1,125 lanes, the clustered traversal,
the replay and ``compact_narrow``) with the replay cap and ``agg_cap``
below and above the lanes a pulse receives, the same where every block
receives lanes, the divisibility errors, and ``run_sweep(mesh=...)``.  The rank worker and the helpers are those of
``tests/test_torch_sharding.py``; as there, ``rts_tpu`` is imported only
inside the tests, never by a spawned rank.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from rts_tpu_torch.engine.cpi import trace_cpi
from rts_tpu_torch.sim import export as te
from rts_tpu_torch.sim.sweep import run_sweep

from test_torch_sharding import (CASES, DEVICE, _assert_bit_identical, _assert_matches_rts_tpu, _cap_case, _flat,
                                 _jax_sharded, _port_state, _spawn, _sweep_cases, wide_world)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    probe = trace_cpi(*_port_state(None, _cap_case(0)))  # no cap: every received lane replayed
    most = int((probe.received >= 0).sum(1).max())
    small, big = max(1, most // 2), most + 4
    wide = trace_cpi(*_port_state(None, _cap_case(0, wide_world, 9)))
    wide_cap = int((wide.received >= 0).sum(1).max()) // 2
    brute = CASES["brute_f64"]
    jobs = [(f"caps_{cap}", "trace", (None, _cap_case(cap)), (1, 3)) for cap in (small, big)]
    jobs += [("wide", "trace", (None, _cap_case(wide_cap, wide_world, 9)), (1, 3)),
             ("pulses_3x1", "error", (None, (brute[0], 5, *brute[2:])), (3, 1)),
             ("rays_1x3", "error", (None, (brute[0], 3, dict(num_rays=4, max_refl_depth=2), brute[3])), (1, 3)),
             ("sweep", "sweep", None, (3, 1))]
    out_dir = tmp_path_factory.mktemp("world3")
    return dict(results=_spawn(out_dir, 3, jobs), caps=(small, big), probe=probe, wide=(wide, wide_cap),
                sweep_dir=str(out_dir / "sweep"))


def _per_block(received, k: int = 3) -> list[int]:
    block = received.shape[1] // k
    return [int((received[:, i * block:(i + 1) * block] >= 0).sum()) for i in range(k)]


def test_caps_firing_on_a_ray_split(spawned):
    """rts_tpu's mid-shape case: every received lane lies in the middle ray
    block, which exceeds the small cap.  A cap acts on each block's lanes,
    so the split replays what the unsplit trace replays: both caps give the
    unsplit result bit for bit, and the small cap's split matches
    rts_tpu's split."""
    small, big = spawned["caps"]
    per_block = _per_block(spawned["probe"].received)
    assert max(per_block) > small, f"no ray block exceeds the small cap {small}: {per_block}"
    assert sum(per_block) <= big
    for cap in (small, big):
        _assert_bit_identical(spawned["results"][f"caps_{cap}"], _flat(trace_cpi(*_port_state(None, _cap_case(cap)))),
                              f"cap {cap}")
    _assert_matches_rts_tpu(spawned["results"][f"caps_{small}"], _jax_sharded(_cap_case(small), (1, 3)), f64=False)


def test_caps_part_the_split_from_the_unsplit_trace_as_in_rts_tpu(spawned):
    """Every ray block receives lanes (9^3 in three blocks of 243) and the
    replay cap is half a pulse's received lanes.  rts_tpu's replay refines
    each block's first ``cap`` received lanes under the split and the
    pulse's first ``cap`` without it, so its two results part on the lanes
    replayed by a block and not by the pulse.  The port grows its replay
    block to hold every received lane, so on those lanes too the split
    equals the unsplit trace bit for bit, and it matches rts_tpu's split
    to the float32 tolerances."""
    wide, cap = spawned["wide"]
    assert min(_per_block(wide.received)) > 0
    got = spawned["results"]["wide"]
    ref = _flat(trace_cpi(*_port_state(None, _cap_case(cap, wide_world, 9))))
    rec = ref["received"][0] >= 0
    block = rec.shape[0] // 3
    in_block = torch.cat([torch.cumsum(rec[i * block:(i + 1) * block].int(), 0) for i in range(3)])
    parting = rec & (in_block <= cap) & (torch.cumsum(rec.int(), 0) > cap)
    assert int(parting.sum()) > 0  # the lanes where rts_tpu's two results part
    _assert_bit_identical(got, ref, "the replay cap on a (1, 3) split")
    _assert_matches_rts_tpu(got, _jax_sharded(_cap_case(cap, wide_world, 9), (1, 3)), f64=False)


def test_not_divisible_raises(spawned):
    assert "pulse count 5 not divisible by pulse shards 3" in spawned["results"]["pulses_3x1"]["error"]
    assert "N^3=64 not divisible by ray shards 3" in spawned["results"]["rays_1x3"]["error"]


def test_run_sweep_on_a_mesh_writes_what_the_unsplit_sweep_writes(spawned, tmp_path):
    """Every rank traces both cases; only the rank at (0, 0) writes, and its
    files equal the unsplit sweep's."""
    assert int(spawned["results"]["sweep"]["completed"]) == 2
    split_dir = spawned["sweep_dir"]
    ref = run_sweep(_sweep_cases(), str(tmp_path), device=DEVICE)
    assert ref.completed == ["c0", "c1"]
    assert sorted(os.listdir(split_dir)) == ["c0.npz", "c1.npz"]
    for name in ref.completed:
        a, b = te.load_cpi(os.path.join(split_dir, f"{name}.npz")), te.load_cpi(str(tmp_path / f"{name}.npz"))
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
