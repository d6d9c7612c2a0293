"""Distributed (multi-device) stencil execution: halo exchange per chain.

Ported from ``src/repro/core/distributed.py``.  The paper (§5.2) notes
tiling's second benefit: instead of exchanging halos per-loop, OPS computes
the accumulated halo depth of the whole loop chain and exchanges once per
chain — fewer, larger messages.  This module implements both policies over
a list of per-shard tensors, so the trade-off is measurable.

Grids are decomposed along one axis (default: the *non*-tiled dim 1, so
out-of-core slab tiling along dim 0 composes with MPI-style decomposition
along dim 1, mirroring the paper's 4-process KNL runs).

The reference runs the exchange as a ``ppermute`` collective under
``shard_map`` on one device's block.  Here :func:`exchange_halos` takes every
shard's tensors at once (one dict per mesh entry, each on its own device)
and does the two directed copies per interior boundary itself, in place:
a peer copy between cards, a device-to-device copy when both shards are on
one card, a host copy on the CPU.  The semantics are the reference's
(non-periodic by default, ``periodic=True`` wraps, depth 0 moves nothing).

The chain's accumulated halo depth for left-to-right execution is
``n_loops × σ`` per neighbour side (σ = max stencil extent): loop k may read
σ cells beyond what loop k-1 wrote, so a chain of n loops consumes up to n·σ
remote cells before requiring fresh data.  After the exchange, every rank
runs the whole chain redundantly on its extended region (halo-deep compute).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Union

import torch

from .loop import ParallelLoop
from .mesh import DeviceMesh

Shards = List[Dict[str, torch.Tensor]]


@dataclass
class HaloExchangeStats:
    messages: int = 0
    bytes: int = 0


def _band(t: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(lo, hi)
    return t[tuple(idx)]


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` on the destination device's current stream.  A
    peer copy first makes that stream wait for everything enqueued on the
    source device's current stream (an event), so it reads what the source
    shard wrote; on one device the current stream orders them already."""
    if not dst.is_cuda or src.device == dst.device:
        dst.copy_(src, non_blocking=dst.is_cuda)
        return
    stream = torch.cuda.current_stream(dst.device)
    if src.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(src.device))
        stream.wait_event(ev)
    with torch.cuda.device(dst.device), torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)


def exchange_halos(shards: Sequence[Dict[str, torch.Tensor]], depth: int,
                   dim: int = 1, periodic: bool = False) -> Shards:
    """One bidirectional halo exchange of ``depth`` cells along ``dim``,
    in place.

    ``shards`` holds one ``{name: tensor}`` dict per mesh entry, in mesh
    order; each tensor includes halo padding of at least ``depth`` on each
    side of ``dim``.  Rank r's low halo receives rank r-1's top interior
    band and its high halo rank r+1's bottom interior band — the two
    ``ppermute`` rings of the reference, as two directed copies per interior
    boundary.  Returns the shards (the same tensors, updated).

    Boundary semantics: by default the grid is NOT periodic — the edge ranks
    (first and last along the mesh) keep their outer halo slots
    *unchanged*, so whatever physical boundary data the caller placed there
    survives the exchange.  ``periodic=True`` wraps the ring around.

    Depth 0 is a fast path: a chain with no reads along ``dim`` needs no
    neighbour data at all, so nothing is copied.

    The sends read the state before the exchange, as the reference's
    functional ``ppermute`` does: where a shard is narrower than three
    depths (a send band overlaps a halo it receives) the bands are copied
    out first.
    """
    shards = [dict(s) for s in shards]
    if depth <= 0:
        return shards
    n = len(shards)
    for name in shards[0]:
        arrs = [s[name] for s in shards]
        sizes = [a.shape[dim] for a in arrs]
        # rank r's top band -> rank r+1's low halo; bottom band -> r-1's high
        up = [_band(a, dim, sz - 2 * depth, sz - depth) for a, sz in zip(arrs, sizes)]
        dn = [_band(a, dim, depth, 2 * depth) for a in arrs]
        if any(sz < 3 * depth for sz in sizes):
            up = [b.clone() for b in up]
            dn = [b.clone() for b in dn]
        for r in range(n):
            if r > 0 or periodic:
                _copy(_band(arrs[r], dim, 0, depth), up[(r - 1) % n])
            if r < n - 1 or periodic:
                sz = sizes[r]
                _copy(_band(arrs[r], dim, sz - depth, sz), dn[(r + 1) % n])
    return shards


def exchange_message_count(n_ranks: int, n_arrays: int = 1,
                           periodic: bool = False) -> int:
    """Messages one halo exchange sends: 2 directions per neighbour pair per
    array — ``2·n`` pairs on a periodic ring, ``2·(n-1)`` on an open chain."""
    if n_ranks <= 1:
        return 0
    pairs = n_ranks if periodic else n_ranks - 1
    return 2 * pairs * n_arrays


def chain_message_count(n_ranks: int, n_arrays: int, n_loops: int = 1,
                        per_loop: bool = False, periodic: bool = False) -> int:
    """Total messages a chain moves under either exchange policy: the tiled
    policy exchanges once per chain (deep); the untiled policy exchanges
    before every loop (``n_loops`` shallow exchanges) — the §5.2 trade-off."""
    exchanges = n_loops if per_loop else 1
    return exchanges * exchange_message_count(n_ranks, n_arrays, periodic)


def chain_halo_depth(loops: Sequence[ParallelLoop], dim: int = 1) -> int:
    """Accumulated halo depth a whole chain needs along ``dim``."""
    sigma = 0
    for lp in loops:
        for arg in lp.args:
            if arg.mode.reads:
                sigma = max(sigma, arg.stencil.max_abs_extent(dim))
    return sigma * len(loops)


ShardFn = Callable[[Dict[str, torch.Tensor], int], Dict[str, torch.Tensor]]


def make_sharded_chain_step(
    chain_fn: ShardFn,
    mesh: Union[int, DeviceMesh],
    depth: int,
    per_loop: bool = False,
    loop_fns: Sequence[ShardFn] = (),
    per_loop_depth: int = 1,
    dim: int = 1,
    periodic: bool = False,
):
    """Build a sharded step: halo exchange(s) + local chain execution.

    ``mesh`` is a :class:`DeviceMesh` or a rank count.  The step takes one
    ``{name: tensor}`` dict per rank (each on its rank's device) and returns
    the same; ``chain_fn(arrays, rank)`` and every ``loop_fns`` entry run
    one rank's block (``rank`` stands in for the reference's
    ``lax.axis_index``).  The exchanges update the given tensors in place.

    ``per_loop=False`` (tiled policy): ONE deep exchange then the whole chain
    locally (each rank computes a ``depth``-wide skirt redundantly).
    ``per_loop=True`` (untiled policy): exchange before every loop —
    ``len(loop_fns)`` shallow messages, no redundant compute.

    This low-level step factory is superseded by the ``ooc-sharded`` backend
    (``Session("ooc-sharded", mesh="sim:4")``), which runs the same
    one-exchange-per-chain policy *composed with* out-of-core tiling.

    The returned function carries message accounting for the §5.2 policy
    trade-off: ``fn.exchanges`` (exchange events per step) and
    ``fn.messages_per_array`` (messages per step per array).
    """
    n_ranks = mesh.num_devices if isinstance(mesh, DeviceMesh) else int(mesh)

    def step(shards: Sequence[Dict[str, torch.Tensor]]) -> Shards:
        if len(shards) != n_ranks:
            raise ValueError(f"step over {n_ranks} ranks got {len(shards)} shards")
        shards = list(shards)
        if per_loop:
            for fn in loop_fns:
                shards = exchange_halos(shards, per_loop_depth, dim, periodic)
                shards = [fn(a, r) for r, a in enumerate(shards)]
            return shards
        shards = exchange_halos(shards, depth, dim, periodic)
        return [chain_fn(a, r) for r, a in enumerate(shards)]

    step.exchanges = len(loop_fns) if per_loop else 1
    step.messages_per_array = chain_message_count(
        n_ranks, 1, n_loops=len(loop_fns), per_loop=per_loop,
        periodic=periodic)
    return step

