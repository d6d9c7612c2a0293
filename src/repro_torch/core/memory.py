"""Memory-hierarchy model: hardware presets, transfer ledger, timeline sim.

The paper's platform figures are reproduced through a calibrated
bandwidth/latency model.  Every byte the executor moves is recorded as a ledger event with
explicit dependencies mirroring Algorithm 1's three streams; the modelled
makespan is the longest path through that event graph with per-stream FIFO
serialisation — exactly how CUDA streams compose.

Presets carry the paper's measured numbers (STREAM/device copy bandwidths,
PCIe/NVLink throughputs as achieved, not peak).

Copied from ``src/repro/core/memory.py``.  The reference models its own
target, a TPU v5e, as ``TPU_V5E``; the port's own target is the H100, and
its preset ``H100`` (figures the card achieved in ``chip_smoke.py`` phase
16(a)) is the default ``hw`` where the reference's is ``TPU_V5E``.  It
imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class HardwareModel:
    """Bandwidths in bytes/s, latencies in s, compute in flop/s."""

    name: str
    fast_capacity: float        # fast memory size (bytes)
    fast_bw: float              # fast-memory stream bandwidth
    slow_bw: float              # slow (DDR4/host) bandwidth
    up_bw: float                # slow->fast link bandwidth (achieved)
    down_bw: float              # fast->slow link bandwidth (achieved)
    dd_bw: float                # fast-memory device-device copy bandwidth
    link_latency: float = 10e-6
    flops: float = 1e12
    page_bytes: int = 2 << 20   # UM/cache page granularity
    page_fault_latency: float = 50e-6  # per-page miss service latency (UM)
    # -- host tier (the HostModel): how much slow memory there is, and how
    # fast the disk tier behind it moves when home copies spill past it.
    host_capacity: float = float("inf")  # host-RAM size (bytes)
    disk_bw: float = 2e9                 # spill-store streaming bandwidth
    disk_latency: float = 100e-6         # per-op service latency (seek/queue)
    # -- network (device-mesh halo exchanges): per-message launch latency and
    # achieved point-to-point bandwidth of the interconnect the sharded
    # backend's HaloExchange ops ride (defaults ~100 GbE as achieved).
    net_bw: float = 12.5e9               # bytes/s per link
    net_latency: float = 20e-6           # per-message latency

    def with_(self, **kw) -> "HardwareModel":
        return replace(self, **kw)


GB = 1e9

# Paper-measured numbers (§5): KNL 7210 quadrant/cache; P100 PCIe & NVLink.
KNL_7210 = HardwareModel(
    name="knl-7210",
    fast_capacity=16 * GB,
    fast_bw=291 * GB,       # STREAM triad, cache mode, dynamic alloc (§5.2)
    slow_bw=60.8 * GB,      # DDR4 flat
    up_bw=60.8 * GB,        # MCDRAM fills come from DDR4
    down_bw=60.8 * GB,
    dd_bw=314 * GB,         # MCDRAM flat bandwidth
    flops=2.6e12,
)
P100_PCIE = HardwareModel(
    name="p100-pcie",
    fast_capacity=16 * GB,
    fast_bw=509.7 * GB,     # measured device-device streaming copy (§5.3)
    slow_bw=60 * GB,
    up_bw=11 * GB,          # achieved PCIe throughput (§5.3)
    down_bw=11 * GB,
    dd_bw=509.7 * GB,
    flops=10e12,
)
P100_NVLINK = P100_PCIE.with_(name="p100-nvlink", up_bw=30 * GB, down_bw=30 * GB)
# The port's own target: rates achieved on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit, CUDA-event medians of 10 (the host copy by the host
# clock) in ``chip_smoke.py`` phase 16(a) (``card_constants``), which prints
# each field beside its run's rate and fails if a ratio leaves [0.5, 2].
H100 = HardwareModel(
    name="h100-sxm",
    fast_capacity=80 * GB,  # the 80 GB part, written as P100_PCIE writes 16 GB
    fast_bw=3000 * GB,      # 4 GiB device-to-device copy_, read and write counted
    slow_bw=33.4 * GB,      # 1 GiB copy_ between pinned host buffers, read and write
    up_bw=52.7 * GB,        # pinned 1 GiB host-to-device copy_
    down_bw=55.1 * GB,      # pinned 1 GiB device-to-host copy_
    dd_bw=3000 * GB,        # the device-to-device copy_, as fast_bw
    flops=756e12,           # bf16 8192^3 torch.matmul (TPU_V5E's flops are bf16 too)
)
PRESETS = {m.name: m for m in (KNL_7210, P100_PCIE, P100_NVLINK, H100)}


@dataclass
class Event:
    eid: int
    stream: int            # 0 = compute/edge, 1 = upload, 2 = download,
    #                        3 = disk, 4 = network (halo exchange)
    kind: str              # upload | download | edge | compute | prefetch
    #                        | fetch_home | spill_home
    #                        | halo_pack | halo_exchange | halo_unpack
    nbytes: int
    duration: float
    deps: Tuple[int, ...] = ()
    t_start: float = 0.0
    t_end: float = 0.0


class TransferLedger:
    """Records events; computes the modelled timeline (3-stream overlap)."""

    def __init__(self, hw: HardwareModel):
        self.hw = hw
        self.events: List[Event] = []
        self.totals: Dict[str, int] = {}

    def add(self, stream: int, kind: str, nbytes: int, duration: float,
            deps: Tuple[int, ...] = ()) -> int:
        eid = len(self.events)
        self.events.append(Event(eid, stream, kind, int(nbytes), duration, tuple(deps)))
        self.totals[kind] = self.totals.get(kind, 0) + int(nbytes)
        return eid

    # duration helpers -------------------------------------------------------
    def t_up(self, nbytes: int) -> float:
        return self.hw.link_latency + nbytes / self.hw.up_bw if nbytes else 0.0

    def t_down(self, nbytes: int) -> float:
        return self.hw.link_latency + nbytes / self.hw.down_bw if nbytes else 0.0

    def t_dd(self, nbytes: int) -> float:
        return nbytes / self.hw.dd_bw if nbytes else 0.0

    def t_disk(self, nbytes: int) -> float:
        return self.hw.disk_latency + nbytes / self.hw.disk_bw if nbytes else 0.0

    def t_net(self, nbytes: int, messages: int = 1) -> float:
        """Halo-exchange time: per-message launch latency plus payload on the
        interconnect (messages overlap across links; latency does not)."""
        if not nbytes and not messages:
            return 0.0
        return messages * self.hw.net_latency + nbytes / self.hw.net_bw

    def t_compute(self, nbytes: int, flops: int) -> float:
        return max(nbytes / self.hw.fast_bw, flops / self.hw.flops)

    # timeline ----------------------------------------------------------------
    def simulate(self) -> float:
        """Longest-path schedule with per-stream FIFO ordering; returns makespan.

        Speculative-prefetch events schedule normally (they occupy stream 1)
        but do not extend the makespan: their tail runs during the NEXT
        chain's ramp-up — that is the whole point of the optimisation."""
        stream_free: Dict[int, float] = {}
        for ev in self.events:  # events were appended in submission order
            start = stream_free.get(ev.stream, 0.0)
            for d in ev.deps:
                start = max(start, self.events[d].t_end)
            ev.t_start = start
            ev.t_end = start + ev.duration
            stream_free[ev.stream] = ev.t_end
        return max((ev.t_end for ev in self.events if ev.kind != "prefetch"),
                   default=0.0)

    def serialized_time(self) -> float:
        """What the same work would cost with no overlap (single stream)."""
        return sum(ev.duration for ev in self.events)

    def summary(self) -> Dict[str, float]:
        makespan = self.simulate()
        out = {f"bytes_{k}": float(v) for k, v in self.totals.items()}
        out["makespan_s"] = makespan
        out["serialized_s"] = self.serialized_time()
        out["overlap_efficiency"] = (
            out["serialized_s"] / makespan if makespan > 0 else 1.0
        )
        return out
