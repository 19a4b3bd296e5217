"""Differentiable collectives over a ``torch.distributed`` group: the
transposes that JAX's ``shard_map`` derives for ``lax.psum`` and
``lax.ppermute``, written out as ``torch.autograd.Function``s.

* :func:`all_reduce_sum` sums over the group; its backward sums the
  cotangents over the group too (the transpose of ``lax.psum``).
* :func:`ring_pass` sends this rank's K/V chunk to rank r + 1 and takes
  rank r - 1's; its backward sends the cotangents the other way (the
  transpose of ``lax.ppermute``).  K and V are stacked into one buffer:
  two separate exchanges could be matched in different orders on
  different ranks by autograd's backward, and a gloo group would then
  hand V's cotangent to K without an error.  A group of one rank
  exchanges nothing, and a CUDA tensor on a gloo group raises (no copy
  through the host).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "ring_pass"]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group=None):
    """The sum of ``x`` over ``group`` (differentiable)."""
    return _AllReduceSum.apply(x, group)


def _peer(group, rank):
    return rank if group is None else dist.get_global_rank(group, rank)


def _exchange(buf, group, step):
    """Send ``buf`` to rank r + step of ``group``, return what rank
    r - step sent."""
    if buf.is_cuda and dist.get_backend(group) == "gloo":
        raise RuntimeError("ring_pass: a CUDA tensor on a gloo group (the "
                           "exchange does not copy through the host); use "
                           "an NCCL group")
    P, r = dist.get_world_size(group), dist.get_rank(group)
    if P == 1:
        return buf
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, _peer(group, (r + step) % P), group),
           dist.P2POp(dist.irecv, recv, _peer(group, (r - step) % P), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return _exchange(torch.stack([k, v]), group, 1).unbind(0)

    @staticmethod
    def backward(ctx, gk, gv):
        return (*_exchange(torch.stack([gk, gv]), ctx.group, -1).unbind(0),
                None)


def ring_pass(k, v, group=None):
    """This rank's K/V chunk to rank r + 1, rank r - 1's back
    (differentiable; the identity on a group of one rank)."""
    return _RingPass.apply(k.contiguous(), v.contiguous(), group)
