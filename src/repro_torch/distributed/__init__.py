"""Sharding of the LM models over a ``torch.distributed`` ``DeviceMesh``
(ported from ``src/repro/distributed``): the specs of parameters, batches
and caches and their DTensor placements (``sharding``), the pieces the
models' mesh paths are built from (``spmd``), and the int8 all-reduce over
the pod axis (``compression``).  Not to be confused with
``repro_torch.core.mesh``, the stencil runtime's device meshes."""
