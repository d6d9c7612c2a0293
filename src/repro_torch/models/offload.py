"""Out-of-core LM serving: layer-weight streaming (the paper's Algorithm 1
applied to transformer weights).

Mapping from the stencil setting:
  loop chain      -> the layer stack (executed in order, every step)
  dataset         -> one layer's weight slice
  fast memory     -> device memory;  slow memory -> host RAM (pinned)
  3 slots         -> ``window`` preallocated device slots, each one slice
  read-only opt   -> weights never download (they are read-only)
  write-first opt -> activations and caches never upload (born on device)
  prefetch        -> layer l+1's weights upload while layer l computes; and
                     the next step's layer 0 uploads after the last layer of
                     this step (the cross-chain speculative prefetch: the
                     next chain is the same layer stack, so it always hits)

Ported from ``src/repro/models/offload.py``.  Where the reference relies on
JAX's async dispatch for the overlap, the port makes it explicit on CUDA:

* each layer's weights live in one flat pinned host buffer (a view per
  weight, each at a 256-byte offset); the device holds at most ``window``
  slots, allocated at their first use and reused, each a flat buffer with a
  ``Block`` of views into it;
* an upload runs on the streamer's copy stream and first waits for the event
  recorded on the compute stream after the last layer that read its slot;
  a layer's compute waits for its slot's upload event.  The slots never go
  back to the allocator while the streamer lives, so no freed block can be
  reused under a running layer;
* the KV caches are written in place (the reference restacks them each step).

The reference's unused ``flops_per_layer_per_token`` argument and
``compute_bound_fraction`` field are left out.  The ring keeps the
reference's eviction order (the slot furthest behind the
layer being fetched) and its speculative ``_fetch(0)``, so ``uploaded_bytes``
and the modelled step equal the reference's.  The default ``hw`` is the
port's own target, ``H100`` (the reference's is its ``TPU_V5E``), so
``modelled_step_s`` is a model of the H100's achieved rates, not a
measurement.  On the CPU the slots are plain tensors and uploads are
synchronous copies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.memory import H100, HardwareModel, TransferLedger
from .transformer import (
    Block,
    Transformer,
    cache_position,
    decode_layer,
    layer_caches,
    lm_logits,
    position,
)

# The families whose layers stream (the reference's streamer serves these).
STREAMED_FAMILIES = ("dense", "vlm")

# Byte alignment of each weight's view in a layer's flat buffer.
_ALIGN = 256


@dataclass
class StreamStats:
    uploaded_bytes: int = 0
    steps: int = 0
    modelled_step_s: float = 0.0
    # Port only: device seconds of the uploads read so far (copy-stream CUDA
    # events; ``LayerStreamer.upload_seconds`` reads the rest), and their count.
    upload_s: float = 0.0
    uploads_timed: int = 0


class _Slot:
    """One device slot: a flat buffer and a ``Block`` of views into it."""

    __slots__ = ("flat", "block", "ready", "free")

    def __init__(self, flat: torch.Tensor, block: Block):
        self.flat = flat
        self.block = block
        self.ready: Optional[torch.cuda.Event] = None   # upload done (copy stream)
        self.free: Optional[torch.cuda.Event] = None    # last reader done (compute)


class LayerStreamer:
    """Runs decode steps for a model whose layer weights live in host memory.

    The layers of ``model`` are copied into host buffers (pinned when the
    model is on CUDA); the caller may then drop the model's ``blocks``.  The
    other weights (embeddings, final norm, head) stay where they are and are
    used every step (the paper keeps frequently-reused data in fast memory).
    """

    def __init__(self, model: Transformer, *, window: int = 3,
                 hw: HardwareModel = H100):
        cfg = model.cfg
        if cfg.family not in STREAMED_FAMILIES:
            # The reference's streamer asserts the same (in its decode).
            raise ValueError(f"streamed decode serves the dense and vlm families, "
                             f"not {cfg.family} ({cfg.name})")
        self.cfg = cfg
        self.window = max(2, window)
        self.hw = hw
        self.L = cfg.num_layers
        self.device = model.embed.device
        self.resident = {"embed": model.embed, "final_norm": model.final_norm,
                         "lm_head": getattr(model, "lm_head", None)}
        first = model.blocks[0]
        self.dtype = next(first.parameters()).dtype
        esize = torch.empty((), dtype=self.dtype).element_size()
        step = _ALIGN // esize
        self._layout: List[Tuple[str, torch.Size, int]] = []
        numel = 0
        for name, p in first.named_parameters():
            self._layout.append((name, p.shape, numel))
            numel += -(-p.numel() // step) * step
        self._flat_numel = numel
        self.layer_nbytes = [sum(p.numel() * p.element_size() for p in blk.parameters())
                             for blk in model.blocks]
        self._cuda = self.device.type == "cuda"
        self.host: List[torch.Tensor] = []
        with torch.no_grad():
            for blk in model.blocks:
                flat = torch.zeros(numel, dtype=self.dtype, pin_memory=self._cuda)
                for name, shape, off in self._layout:
                    self._view(flat, shape, off).copy_(blk.get_parameter(name))
                self.host.append(flat)
        self._ring: Dict[int, _Slot] = {}
        self.ledger = TransferLedger(hw)
        self.stats = StreamStats()
        self._flops_per_layer_token = 2.0 * cfg.active_param_count() / max(cfg.num_layers, 1)
        self.copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._timed: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    @staticmethod
    def _view(flat: torch.Tensor, shape: torch.Size, off: int) -> torch.Tensor:
        return flat[off:off + shape.numel()].view(shape)

    def _new_slot(self) -> _Slot:
        flat = torch.empty(self._flat_numel, dtype=self.dtype, device=self.device)
        block = Block(self.cfg, self.dtype, torch.device("meta"))
        for name, shape, off in self._layout:
            *path, leaf = name.split(".")
            owner = block.get_submodule(".".join(path)) if path else block
            setattr(owner, leaf, torch.nn.Parameter(self._view(flat, shape, off),
                                                    requires_grad=False))
        slot = _Slot(flat, block)
        if self._cuda:
            # The allocator may hand back a block that work still queued on
            # the compute stream reads: the first upload waits for it.
            flat.record_stream(self.copy_stream)
            slot.free = torch.cuda.Event()
            slot.free.record(torch.cuda.current_stream(self.device))
        return slot

    # -- slot management ---------------------------------------------------------
    def _fetch(self, li: int) -> _Slot:
        if li in self._ring:
            return self._ring[li]
        if len(self._ring) < self.window:
            slot = self._new_slot()
        else:
            # evict the slice furthest BEHIND the layer being fetched in ring
            # order (so a speculatively-prefetched layer 0 survives the tail
            # of the previous step); read-only => discard, never download.
            stalest = max(self._ring, key=lambda k: (li - k) % self.L)
            slot = self._ring.pop(stalest)
        if self._cuda:
            with torch.cuda.stream(self.copy_stream):
                if slot.free is not None:
                    self.copy_stream.wait_event(slot.free)
                start = torch.cuda.Event(enable_timing=True)
                slot.ready = torch.cuda.Event(enable_timing=True)
                start.record()
                slot.flat.copy_(self.host[li], non_blocking=True)
                slot.ready.record()
            self._timed.append((start, slot.ready))
        else:
            slot.flat.copy_(self.host[li])
        self._ring[li] = slot
        self.stats.uploaded_bytes += self.layer_nbytes[li]
        return slot

    def _acquire(self, li: int) -> Block:
        """Layer ``li``'s weights, once its upload is done (compute stream)."""
        slot = self._ring[li]
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(slot.ready)
        return slot.block

    def _release(self, li: int) -> None:
        """Mark layer ``li``'s compute as the last reader of its slot."""
        if self._cuda:
            slot = self._ring[li]
            slot.free = torch.cuda.Event()
            slot.free.record(torch.cuda.current_stream(self.device))

    def upload_seconds(self, wait: bool = True) -> float:
        """Add the device time of the timed uploads to ``stats.upload_s`` and
        return it; with ``wait=False`` only the uploads already done are read."""
        keep = []
        for start, end in self._timed:
            if wait:
                end.synchronize()
            if wait or end.query():
                self.stats.upload_s += start.elapsed_time(end) / 1e3
                self.stats.uploads_timed += 1
            else:
                keep.append((start, end))
        self._timed = keep
        return self.stats.upload_s

    def device_resident_bytes(self) -> int:
        """Max weight bytes on device at any time (the out-of-core claim),
        computed: ``window`` slices."""
        return self.window * max(self.layer_nbytes)


class StreamedDecoder(LayerStreamer):
    """Streamed decode for the dense/vlm families (llama-style blocks).

    At most ``window`` layer slices are on the device at any point; slice
    l+1's upload is issued before layer l's compute.  The math is
    ``transformer.decode_step``'s, op for op, so the logits are equal to it.
    """

    def decode(self, cache: Dict[str, Any],
               tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One step: logits (B, vocab) and ``cache``, updated in place.
        Raises ``CacheFullError`` when the cache has no slot left."""
        cfg = self.cfg
        cur = cache_position(cfg, cache)
        batch = tokens.shape[0]
        self.upload_seconds(wait=False)
        h = self.resident["embed"][tokens][:, None, :]
        pos = position(cur, h.device)
        self._fetch(0)
        for li in range(self.L):
            if li + 1 < self.L:
                self._fetch(li + 1)          # prefetch the next layer (copy stream)
            blk = self._acquire(li)
            h = decode_layer(blk, h, cfg, layer_caches(cfg, cache, li), pos)
            self._release(li)
        # speculative prefetch for the NEXT step's first layer: the next
        # chain is the same layer stack, so this always hits.
        self._fetch(0)
        r = self.resident
        logits = lm_logits(h, cfg, r["embed"], r["final_norm"], r["lm_head"])[:, 0, :]
        cache["len"] = cur + 1

        # ledger: model the overlapped schedule on the target hardware
        t_cmp_layer = self._flops_per_layer_token * batch / self.hw.flops
        up_eid = cmp_eid = None
        for li in range(self.L):
            nb = self.layer_nbytes[li]
            deps = tuple(e for e in (up_eid,) if e is not None)
            up_eid = self.ledger.add(1, "upload", nb, self.ledger.t_up(nb), deps)
            cdeps = [up_eid] + ([cmp_eid] if cmp_eid is not None else [])
            cmp_eid = self.ledger.add(0, "compute", 0, t_cmp_layer, tuple(cdeps))
        self.stats.steps += 1
        self.stats.modelled_step_s = self.ledger.simulate() / self.stats.steps
        return logits, cache
