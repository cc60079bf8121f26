"""Fixed-capacity row compaction.

Counterpart of ddcmd_tpu/parallel/slab.py:compact_rows, the primitive
every halo and migration buffer of the brick mesh is packed with.  The
slab decomposition itself is not ported: the brick mesh subsumes it.
"""

from __future__ import annotations

import torch


def compact_rows(arrays: dict, mask, out_cap: int):
    """Pack the rows where `mask` is True to the front of (out_cap, ...)
    zero-filled buffers, in row order.  Returns (packed dict, count as a
    0-d int64 tensor clipped to out_cap, overflow as a 0-d bool tensor):
    static shapes, no host read; rows past out_cap are dropped and flag
    the overflow."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    count = pos[-1] + 1 if mask.shape[0] else torch.zeros(
        (), dtype=torch.int64, device=mask.device)
    slot = torch.where(mask & (pos < out_cap), pos,
                       torch.full_like(pos, out_cap))
    out = {}
    for k, a in arrays.items():
        buf = torch.zeros((out_cap + 1,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        buf[slot] = a
        out[k] = buf[:out_cap]
    return out, torch.clamp(count, max=out_cap), count > out_cap
