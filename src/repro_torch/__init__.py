"""repro_torch — the PyTorch/CUDA port of ``repro``, the out-of-core stencil
runtime of "Beyond 16GB: Out-of-Core Stencil Computations".

The layout mirrors ``repro``: :mod:`repro_torch.core` (the Session frontend,
planner, interpreters and data plane), :mod:`repro_torch.obs` (tracing and
metrics), :mod:`repro_torch.serve` (the multi-tenant server, with its
launcher in :mod:`repro_torch.launch.serve`) and :mod:`repro_torch.kernels`
(hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version).  It imports ``torch`` and
never JAX or ``repro``; the JAX package stays the reference the port is
tested against.

Entry points run on the card unless the caller asks for the CPU:
``Session("ooc")`` raises on a machine without CUDA, and
``Session("ooc", device="cpu")`` runs there.
"""
