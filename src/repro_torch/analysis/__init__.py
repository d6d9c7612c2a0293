"""Step analysis: an op-level cost counter (the port's counterpart of the
reference's HLO parser) and the roofline with H100 constants."""
from .op_analysis import analyze_step
from .roofline import H100_SXM, model_flops, roofline_terms

__all__ = ["H100_SXM", "analyze_step", "model_flops", "roofline_terms"]
