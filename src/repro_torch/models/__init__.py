"""LM model substrate of the port: every family of the JAX package's
``repro.models`` (dense, vlm, moe, ssm, hybrid, encdec: config, layers,
attention with MLA, moe, the Mamba-2 scan and decode in ``ssm``,
transformer), the weights carried across from its parameter trees, and
layer-weight streaming for serving the dense and vlm families
(``offload.StreamedDecoder``), and the training loss (``loss_fn``, with
``forward(remat=True)``; the optimizer and the step are in
``repro_torch.train``).  ``forward``, ``loss_fn`` and ``decode_step`` also
run on a mesh (``mesh=``; the rules in ``repro_torch.distributed``).  On a
card, ``DecodeGraph`` (``graph.py``) replays the single-device decode step
as one CUDA graph, the counterpart of the reference's jitted step."""
from .config import ModelConfig
from .graph import DecodeGraph
from .transformer import (
    CacheFullError,
    Transformer,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
)

__all__ = ["CacheFullError", "DecodeGraph", "ModelConfig", "Transformer", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn"]
