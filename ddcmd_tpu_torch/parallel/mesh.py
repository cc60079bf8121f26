"""The brick mesh: this rank's place in it and its collectives.

Counterpart of what shard_map, ppermute, psum, pmax and axis_index do in
the JAX package, and of ddcmd_tpu/parallel/brickstep.py:make_brick_mesh.
One process (rank) owns one brick.  Ranks ravel as the JAX package's
devices do, rank = (ix*ny + iy)*nz + iz (parallel/brick.py:
distribute_bricks).  At world size 1 there is no process group and every
collective is the identity; on any mesh, axes of size 1 exchange nothing
(periodicity is the stencil's business there, as in the JAX package).

Buffers travel at fixed capacity with their fill counts beside them
(parallel/slab.compact_rows), so no size handshake precedes a send.  The
backend follows the tensors: NCCL for `cuda:<local rank>`, gloo for CPU
tensors; a mismatch raises, and nothing is staged through the host.

On an axis of size 2 both neighbours are the same rank, so the lo-window
and hi-window buffers to one peer must be told apart: by tag under gloo,
and by issue order under NCCL, which ignores tags.  Every exchange
issues, per field in key order, the send up then the send down, and the
receives in the same order, so both rules match the same pairs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

_TAG_UP, _TAG_DN = 0, 1     # + 2 * (field index): one tag per message


class BrickMesh:
    """shape (nx, ny, nz) over the world of torch.distributed (or one
    process when no group is initialised); `idx3` is this rank's brick."""

    def __init__(self, shape, device):
        self.shape = tuple(int(s) for s in shape)
        self.device = torch.device(device)
        n = int(np.prod(self.shape))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n != world:
            raise ValueError(f"mesh {self.shape} needs {n} ranks, the world "
                             f"has {world}")
        self.size = n
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        nx, ny, nz = self.shape
        ix, rem = divmod(self.rank, ny * nz)
        iy, iz = divmod(rem, nz)
        self.idx3 = (ix, iy, iz)
        if n > 1:
            backend = dist.get_backend()
            want = "nccl" if self.device.type == "cuda" else "gloo"
            if backend != want:
                raise ValueError(f"tensors on {self.device} need the {want} "
                                 f"backend, the process group runs {backend}")

    def rank_of(self, idx3) -> int:
        nx, ny, nz = self.shape
        return (idx3[0] * ny + idx3[1]) * nz + idx3[2]

    def neighbour(self, axis: int, shift: int) -> int:
        idx = list(self.idx3)
        idx[axis] = (idx[axis] + shift) % self.shape[axis]
        return self.rank_of(idx)

    def exchange(self, send_lo: dict, send_hi: dict, axis: int):
        """Both one-hop shifts along `axis`: send_hi goes to the +1
        neighbour, send_lo to the -1 neighbour (brick._exchange_axis).
        Returns (from_lo, from_hi): what the -1 / +1 neighbours sent
        toward this rank, fields of the same shapes.  An axis of size 1
        must not be exchanged."""
        if self.shape[axis] == 1:
            raise ValueError(f"axis {axis} has one brick: nothing to exchange")
        up, dn = self.neighbour(axis, +1), self.neighbour(axis, -1)
        from_lo = {k: torch.empty_like(v) for k, v in send_hi.items()}
        from_hi = {k: torch.empty_like(v) for k, v in send_lo.items()}
        keys = sorted(send_hi)
        ops = []
        for i, k in enumerate(keys):
            ops.append(dist.P2POp(dist.isend, send_hi[k].contiguous(), up,
                                  tag=2 * i + _TAG_UP))
            ops.append(dist.P2POp(dist.isend, send_lo[k].contiguous(), dn,
                                  tag=2 * i + _TAG_DN))
        for i, k in enumerate(keys):
            ops.append(dist.P2POp(dist.irecv, from_lo[k], dn,
                                  tag=2 * i + _TAG_UP))
            ops.append(dist.P2POp(dist.irecv, from_hi[k], up,
                                  tag=2 * i + _TAG_DN))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return from_lo, from_hi

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the mesh (a new tensor; the identity on one rank)."""
        if self.size == 1:
            return x
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's x, in rank order."""
        if self.size == 1:
            return x[None]
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x.contiguous())
        return torch.stack(out)
