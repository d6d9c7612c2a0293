"""LM model substrate of the port: the dense, vlm and moe families of the JAX
package's ``repro.models`` (config, layers, attention with MLA, moe,
transformer), the weights carried across from its parameter trees, and
layer-weight streaming for serving the dense and vlm families
(``offload.StreamedDecoder``).  The ssm, hybrid and encdec families,
training and sharding are later slices (ROADMAP A14)."""
from .config import ModelConfig
from .transformer import (
    CacheFullError,
    Transformer,
    decode_step,
    forward,
    init_cache,
    init_params,
)

__all__ = ["CacheFullError", "ModelConfig", "Transformer", "decode_step", "forward",
           "init_cache", "init_params"]
