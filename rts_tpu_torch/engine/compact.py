"""Received-lane compaction for the capped post-processing path
(counterpart of ``rts_tpu.engine.compact``).

Unused slots hold ``total`` (one past the last lane): gathers go through
:func:`take_lanes`, which fills them, and write-backs must drop them
(``engine.cpi`` writes back only the first ``count`` slots).
"""

from __future__ import annotations

import torch


def received_first_idx(received, cap: int):
    """Lane indices of the first ``cap`` received lanes, in lane order.

    Returns int64 [cap]; slots past the received count hold ``total``.
    The j-th received lane is the first l with cumsum[l] == j+1.
    """
    csum = torch.cumsum((received >= 0).to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=received.device)
    return torch.searchsorted(csum, want, side="left")


def take_lanes(a, idx, fill=0):
    """Gather lanes (last axis) at ``idx``; out-of-range slots -> ``fill``."""
    total = a.shape[-1]
    ok = idx < total
    out = a[..., idx.clamp(max=total - 1)]
    return torch.where(ok, out, torch.as_tensor(fill, dtype=a.dtype, device=a.device))
