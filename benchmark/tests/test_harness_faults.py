"""A run whose timed path is broken underneath comes out not correct: half
of the pulses left out, the exchange between ranks left out, an answer
altered where it is produced.  The harness's look for a card is skipped:
the run is driven through ``run_cell`` on the CPU."""

from __future__ import annotations

import torch

from benchmark import run
from conftest import SEED, tiny


def _run(cell):
    return run.run_cell(cell, SEED, 0.3, False, device="cpu")


def test_sound_run_is_correct(imaging_cell):
    assert _run(imaging_cell)["correct"] is True


def test_half_of_the_pulses_left_out(imaging_cell, monkeypatch):
    from rts_tpu_torch.engine import cpi

    real = cpi.map_pulses

    def half(full, batch):
        out = real(full, batch)
        keep = batch.times.shape[0] // 2
        return run._tree(lambda x: torch.cat([x[:keep], torch.zeros_like(x[keep:])]), out)

    monkeypatch.setattr(cpi, "map_pulses", half)
    result = _run(imaging_cell)
    assert result["correct"] is False and result["failed"] == result["attempted"]
    assert result["checked"]["rx_differ"]["value"] > 0


def test_answer_altered_where_produced(terrain_cell, monkeypatch):
    from rts_tpu_torch.engine import cpi

    real = cpi.postprocess

    def altered(res, **kw):
        power, doppler, delay = real(res, **kw)
        return power * (1 + 1e-5), doppler, delay

    monkeypatch.setattr(cpi, "postprocess", altered)
    result = _run(terrain_cell)
    assert result["correct"] is False
    assert result["checked"]["rx_power_rel"]["value"] > 1e-6


def _rank_without_exchange(rank, *args):
    """A rank whose gathers leave the other ranks' buffers as allocated
    (zero): the exchange between ranks left out."""
    import torch.distributed as dist

    from rts_tpu_torch.parallel import sharding

    def local_only(x, group):
        me, n = dist.get_rank(group), dist.get_world_size(group)
        return [x if i == me else torch.zeros_like(x) for i in range(n)]

    sharding._all_gather = local_only
    run._rank_main(rank, *args)


def test_exchange_between_ranks_left_out(monkeypatch):
    # the plate crosses the beam within the CPI, so that the ranks' pulse
    # blocks differ
    cell = tiny(run.load_cell("imaging-1M.cpi256.split4"), moving=True)
    assert _run(cell)["correct"] is True
    monkeypatch.setattr(run, "_rank_main", _rank_without_exchange)
    result = _run(cell)
    assert result["correct"] is False
    assert result["checked"]["rx_differ"]["value"] > 0
