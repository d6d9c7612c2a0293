"""The decode step as one CUDA graph per served model, batch and cache.

The reference serves every family through ``jax.jit(lambda p, c, t:
decode_step(p, cfg, c, t))`` (``src/repro/launch/serve.py``): one device
program a token, its position a device scalar.  The port has no XLA; its
counterpart is a ``torch.cuda.CUDAGraph`` of ``transformer.decode_tokens``,
captured once and replayed every token, which takes the host's dispatch of
the step's few thousand launches off the token's path.  It is not
``torch.compile``: the graph replays the eager launches as they are.

``decode_tokens`` reads the position only as a 0-d int64 tensor and never
syncs with the host, so one capture serves every position.  The graph owns
the step's static inputs (a token buffer, that position tensor, encdec's
position table) and its output buffer; the cache is the caller's, written in
place at fixed addresses.  The host ``len`` stays the cache's truth: each call
checks it (``cache_position``, which raises ``CacheFullError`` before any
launch), fills the position tensor from it and bumps it after the replay.

The first call (``WARMUP_STEPS``) runs ``decode_tokens`` eagerly on the
graph's side stream, as PyTorch's capture recipe asks (cuBLAS's handle and
workspace for that stream).  It is a real step of the sequence: its logits
are returned and its cache writes kept.  It runs under
``torch.cuda.set_sync_debug_mode("error")``, so a host sync in the step
names itself there, before the capture.  The next call captures one
step into the graph's own memory pool (a capture launches nothing, so it
writes nothing) and replays it; every later call replays.  A failed capture
or replay raises; nothing falls back to the eager step.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, Optional, Tuple

import torch

from .transformer import Transformer, cache_position, decode_tokens, position_table


class DecodeGraph:
    """``model``'s decode step on ``cache`` as a CUDA graph: call it as
    ``decode_step`` (``logits, cache = graph(cache, tokens)``), with this
    ``cache`` and (B,) tokens, under any grad mode (it runs under
    ``torch.inference_mode``).  The returned logits are a fresh tensor each
    call.  Raises ``ValueError`` unless the model and every cache tensor
    are on one CUDA device.

    Records: ``capture_s`` (the capture's host seconds, ``None`` before
    it), ``pool_bytes`` (device bytes the capture reserved for the graph's
    private pool), ``replays``."""

    WARMUP_STEPS = 1            # eager steps on the side stream before the capture
    SYNC_DEBUG = "error"        # torch.cuda.set_sync_debug_mode in the warm-up

    def __init__(self, model: Transformer, cache: Dict[str, Any]):
        tensors = [t for k, t in cache.items() if k != "len"]
        devices = {p.device for p in model.parameters()} | {t.device for t in tensors}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError("DecodeGraph needs the model and its cache on one CUDA "
                             f"device, not on {sorted(str(d) for d in devices)}")
        self.device = next(iter(devices))
        self.model, self.cache = model, cache
        self._held = {k: t for k, t in cache.items() if k != "len"}
        self.capture_s: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.replays = 0
        self._calls = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._stream = torch.cuda.Stream(self.device)
        with torch.inference_mode():
            self._tokens = torch.zeros(tensors[0].shape[1], dtype=torch.int64,
                                       device=self.device)
            self._pos = torch.zeros((), dtype=torch.int64, device=self.device)
            self._pe = position_table(model, cache)
        self._logits: Optional[torch.Tensor] = None

    def _step(self) -> torch.Tensor:
        return decode_tokens(self.model, self.cache, self._tokens, self._pos, self._pe)

    def _warm_step(self) -> torch.Tensor:
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(self.SYNC_DEBUG)
        try:
            with torch.cuda.stream(self._stream):
                logits = self._step()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(self._stream)
        logits.record_stream(main)
        return logits

    def _capture(self) -> None:
        # torch.cuda.graph empties the allocator's cache on entry: empty it
        # first, so that the difference below is the graph's pool alone
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        # assigned first: after a failed capture the graph cannot replay, and
        # the next call raises rather than warming up again
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph, stream=self._stream):
            self._logits = self._step()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before

    def __call__(self, cache: Dict[str, Any],
                 tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if cache is not self.cache or any(cache[k] is not t for k, t in self._held.items()):
            raise ValueError("DecodeGraph replays the cache tensors it was made with")
        cur = cache_position(self.model.cfg, cache)
        with torch.inference_mode():
            self._tokens.copy_(tokens)
            self._pos.fill_(cur)
            if self._calls < self.WARMUP_STEPS:
                logits = self._warm_step()
            else:
                if self._graph is None:
                    self._capture()
                self._graph.replay()
                self.replays += 1
                logits = self._logits.clone()
        self._calls += 1
        cache["len"] = cur + 1
        return logits, cache
