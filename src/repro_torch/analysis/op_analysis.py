"""Op-level cost counter: the port's counterpart of ``analysis/hlo_analysis.py``.

Torch has no HLO, so the costs come from watching a step run: ``OpCostLog``
is a ``TorchDispatchMode`` that sees every aten op the step dispatches, its
backward included, on the card, on the CPU or under ``FakeTensorMode``.
``analyze_step(fn, devices)`` runs ``fn`` under it and returns the keys of
the reference's ``analyze_hlo_text``:

  * ``dot_flops``: the product ops only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``_scaled_mm`` and the SDPA ops), by
    ``torch.utils.flop_counter``'s formulas, as the reference counts
    ``dot`` only.  Convolutions go under ``conv_flops``; elementwise FLOPs
    are not counted.  An op that eager runs as its composite decomposition
    (``matmul`` under ``inference_mode``) is run as that decomposition, its
    parts counted; an op with a kernel of its own is costed as that kernel
    and never decomposed, so a step's results stay bit for bit those of a
    run without the mode (``FlopCounterMode`` decomposes ``silu_backward``,
    which then rounds otherwise).  The two count the same products.
  * ``hbm_bytes``: the eager op boundary, which is what the card runs
    (the reference counts XLA's fusion boundaries): each op reads its
    operands and writes its results once.  View and metadata ops cost 0
    (the reference's skip list in torch terms); ``empty`` allocates and
    writes nothing; ``index_select``, ``gather``, ``embedding`` and
    indexing read what they produce plus the indices; an in-place or
    scatter write (``copy_`` into a view, ``index_put_``,
    ``slice_scatter``, ...) costs twice the update's bytes, as the reference
    charges ``dynamic-update-slice``.  DTensor operands count their local
    shard.
  * collectives, by op and by group size, with the reference's ring wire
    factors: all-gather (g-1)/g of the gathered result, all-reduce
    2(g-1)/g, all-to-all (g-1)/g, collective permute (``send``) 1, and
    reduce-scatter (g-1)/g of its INPUT.  The reference charges the
    reduce-scatter's result (``hlo_analysis.py:213``, its ``_WIRE_FACTOR``
    applied to ``op.result_bytes``), which undercounts by the group size
    (ROADMAP fault C8).  Groups of ``dcn_group_size`` or fewer go to the
    ``dcn`` bucket, larger ones to ``ici``.

It returns ``num_ops`` (ops dispatched) in place of ``num_computations``,
and with ``breakdown`` the ``top_hbm`` list: (bytes, op, operand shapes,
calls), the 15 largest.

Where the reference counts fewer products (ROADMAP fault C9): it follows
only ``calls|to_apply|body|condition`` (``hlo_analysis.py:45``), never a
``conditional``'s ``branch_computations``, so the dots of a ``lax.cond``
branch count 0 (DeepSeek-V2-Lite's dense-or-moe layer, Zamba2's shared
block), though its docstring says "counted once per invocation".  The port
has no branch: the layer that runs is the one counted.  And XLA drops dead
products the eager port computes: a Mamba-2 forward discards its final
chunk state, so the reference's HLO has no ``Sc`` product
(``models/ssm.py``'s ``bjn,bjh,bjhp->bhpn``), which the port counts.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_DOTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten._scaled_mm}
_DOTS |= {op for op in flop_registry
          if isinstance(op, torch._ops.OpOverloadPacket) and "attention" in op.__name__}
_CONVS = {op for op in flop_registry
          if isinstance(op, torch._ops.OpOverloadPacket) and "conv" in op.__name__}

# Queries of a tensor's metadata (``FakeTensorMode`` dispatches them): not ops.
_METADATA = {"size", "sym_size", "stride", "sym_stride", "storage_offset",
             "sym_storage_offset", "numel", "sym_numel", "dim", "is_contiguous",
             "sym_is_contiguous", "is_strides_like_format", "is_non_overlapping_and_dense"}
# Ops that move no bytes: views the schema does not mark as such, and
# allocation without a write.
_FREE = {"_unsafe_view", "_reshape_alias", "lift_fresh", "detach", "alias",
         "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "empty_permuted", "set_", "resize_", "_local_scalar_dense", "wait_tensor"}
# Ops that read only what they produce, plus the indices.
_GATHERS = {"index_select", "gather", "embedding", "index"}
# In-place writes into part of a tensor (and ``slice_scatter``, the
# reference's ``dynamic-update-slice``), and the position of their update.
_SCATTERS = {"copy_": 1, "index_put_": 2, "slice_scatter": 1, "scatter_": 3,
             "scatter_add_": 3, "index_add_": 3}

_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")
# The collectives the port runs: the functional ops (DTensor, ``spmd``) and
# c10d's tensor forms (``dist.all_gather_into_tensor`` on a gloo group of
# CUDA tensors, ``launch/mesh.py``), and ``send`` for a collective permute.
_KIND = {"all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
         "all_reduce": "all-reduce", "allreduce_": "all-reduce",
         "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute"}

# Wire bytes a device sends, as a multiple of ``CollectiveLog``'s bytes (the
# collective's input on this rank), for a group of g.
_WIRE_FACTOR = {
    "all-gather": lambda g: g - 1,                  # (g-1)/g of the gathered result
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,        # of the input (C8)
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


def _group_size(args) -> int:
    """The group size of a collective's arguments: a functional op names
    its group, a c10d op passes the group itself."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                pass
        elif not isinstance(a, (torch.Tensor, int, float, bool, list, tuple)) \
                and callable(getattr(a, "size", None)):
            try:
                return int(a.size())
            except (TypeError, RuntimeError):
                pass
    return 0


class CollectiveLog(TorchDispatchMode):
    """Counts each collective op of the functional and c10d namespaces and
    the bytes of its input on this rank, by op and by group size."""

    def __init__(self):
        super().__init__()
        self.bytes_by_op: Dict[str, int] = defaultdict(int)
        self.count_by_op: Dict[str, int] = defaultdict(int)
        self.bytes_by_group: Dict[int, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._collective(func, args)
        return func(*args, **(kwargs or {}))

    def _collective(self, func, args) -> Optional[Tuple[str, int, int]]:
        """Records ``func`` if it is a collective: (name, bytes, group size)."""
        name = func.__name__.split(".")[0]
        if (func.namespace not in _COLLECTIVE_NS or "wait" in name
                or name.startswith("_wrap")):
            return None
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        tensors += [t for a in args if isinstance(a, (list, tuple))
                    for t in a if isinstance(t, torch.Tensor)]
        if name in ("_allgather_base_", "_reduce_scatter_base_"):
            tensors = tensors[1:]               # (output, input): count the input
        elif func.namespace == "c10d" and name.startswith(("allgather", "reduce_scatter")):
            tensors = tensors[-1:]
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        group = _group_size(args)
        if not group and name in ("_allgather_base_", "_reduce_scatter_base_"):
            out, inp = args[0], args[1]           # the group is the size ratio
            group = max(out.numel(), inp.numel()) // max(min(out.numel(), inp.numel()), 1)
        self.count_by_op[name] += 1
        self.bytes_by_op[name] += nbytes
        self.bytes_by_group[group] += nbytes
        return name, nbytes, group


_IMPLICIT = torch._C.DispatchKey.CompositeImplicitAutograd
_BACKEND = {"cpu": "CPU", "cuda": "CUDA"}


def _composite(func, args) -> bool:
    """Whether eager runs ``func`` as its ``CompositeImplicitAutograd``
    decomposition (it has no kernel for its tensors' backend): under
    ``inference_mode`` such ops (``matmul``, ``linear``, ``einsum``) reach
    the mode whole, and their products are inside."""
    name = func.name()
    if not torch._C._dispatch_has_kernel_for_dispatch_key(name, _IMPLICIT):
        return False
    dev = next((t.device.type for t in tree_leaves(args) if isinstance(t, torch.Tensor)), None)
    return (dev in _BACKEND
            and not torch._C._dispatch_has_kernel_for_dispatch_key(name, _BACKEND[dev]))


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _nbytes(tensors) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tensors if isinstance(t, torch.Tensor))


def _update_bytes(name: str, args) -> Optional[int]:
    """Bytes a scatter-like write reads and writes: twice its update (for
    ``copy_``, the destination's elements at the source's and its own
    width); None for any other op, or where the update is a scalar."""
    if name == "copy_":
        dst, src = _local(args[0]), _local(args[1])
        return dst.numel() * (dst.element_size() + src.element_size())
    i = _SCATTERS.get(name)
    if i is None or len(args) <= i or not isinstance(args[i], torch.Tensor):
        return None
    return 2 * _nbytes([args[i]])


class OpCostLog(CollectiveLog):
    """Per-device costs of the ops run under it (the module docstring's
    rules).  ``devices`` is the group size taken where a collective names
    none; ``breakdown`` keeps the bytes by op and operand shapes."""

    def __init__(self, devices: int = 1, dcn_group_size: int = 2, breakdown: bool = False):
        super().__init__()
        self.devices, self.dcn_group_size, self.breakdown = devices, dcn_group_size, breakdown
        self.dot_flops = 0
        self.conv_flops = 0
        self.hbm_bytes = 0
        self.num_ops = 0
        self.wire_by_kind: Dict[str, float] = defaultdict(float)
        self.count_by_kind: Dict[str, int] = defaultdict(int)
        self.wire_ici = 0.0
        self.wire_dcn = 0.0
        self.by_op: Dict[Tuple[str, str], list] = defaultdict(lambda: [0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim" or func.__name__.split(".")[0] in _METADATA:
            return func(*args, **kwargs)
        if _composite(func, args):
            with self:
                return func._op_dk(_IMPLICIT, *args, **kwargs)
        packet = func._overloadpacket
        coll = self._collective(func, args)
        out = func(*args, **kwargs)
        self.num_ops += 1
        if packet in _DOTS:
            self.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in _CONVS:
            self.conv_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if coll is not None:
            self._wire(*coll)
        self._bytes(func, args, kwargs, out)
        return out

    def _wire(self, name: str, nbytes: int, group: int) -> None:
        kind = _KIND.get(name)
        if kind is None:
            return
        g = group or self.devices
        wire = nbytes * _WIRE_FACTOR[kind](g)
        self.wire_by_kind[kind] += wire
        self.count_by_kind[kind] += 1
        if g <= self.dcn_group_size:
            self.wire_dcn += wire
        else:
            self.wire_ici += wire

    def _bytes(self, func, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        if func.is_view or name in _FREE:
            return
        if name in _GATHERS:
            nbytes = 2 * _nbytes(tree_leaves(out)) + _nbytes(tree_leaves((args[1:], kwargs)))
        else:
            nbytes = _update_bytes(name, args)
        if nbytes is None:
            nbytes = _nbytes(tree_leaves((args, kwargs))) + _nbytes(tree_leaves(out))
        self.hbm_bytes += nbytes
        if self.breakdown:
            shapes = ",".join(str(list(_local(a).shape)) for a in tree_leaves(args)
                              if isinstance(a, torch.Tensor))
            rec = self.by_op[(name, shapes[:48])]
            rec[0] += nbytes
            rec[1] += 1

    def summary(self) -> Dict:
        """The reference's ``analyze_hlo_text`` keys (``num_ops`` for
        ``num_computations``), plus ``conv_flops``."""
        out = {
            "dot_flops": float(self.dot_flops),
            "conv_flops": float(self.conv_flops),
            "hbm_bytes": float(self.hbm_bytes),
            "collective_wire_bytes": dict(self.wire_by_kind),
            "collective_bytes_ici": self.wire_ici,
            "collective_bytes_dcn": self.wire_dcn,
            "collective_op_counts": dict(self.count_by_kind),
            "num_ops": self.num_ops,
        }
        if self.breakdown:
            top = sorted(((b, op, shapes, n) for (op, shapes), (b, n) in self.by_op.items()),
                         reverse=True)[:15]
            out["top_hbm"] = [(float(b), op, shapes, n) for b, op, shapes, n in top]
        return out


def analyze_step(fn: Callable[[], object], devices: int, dcn_group_size: int = 2,
                 breakdown: bool = False) -> Dict:
    """Run ``fn()`` once under ``OpCostLog`` and return its per-device
    costs (the module docstring)."""
    log = OpCostLog(devices, dcn_group_size, breakdown)
    with log:
        fn()
    return log.summary()
