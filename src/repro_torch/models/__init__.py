"""LM model substrate of the port: the dense and vlm families of the JAX
package's ``repro.models`` (config, layers, attention, transformer), the
weights carried across from its parameter trees, and layer-weight streaming
for serving (``offload.StreamedDecoder``).  The moe, ssm, hybrid and encdec
families, training and sharding are later slices (ROADMAP A14)."""
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
