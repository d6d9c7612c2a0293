"""repro_torch.core — runtime skewed tiling + out-of-core streaming execution
of stencil loop chains, in PyTorch.  The counterpart of ``repro.core`` with
the same public names; see each module's docstring for what it copies,
ports or leaves to a later ROADMAP item."""
from .backends import (
    KernelBackend,
    ReferenceBackend,
    available_backends,
    make_backend,
    register_backend,
)
from .block import Block
from .dataset import Dataset, datasets_from_numpy, make_dataset
from .dependency import (
    ChainInfo,
    analyze_chain,
    chain_signature,
    plan_signature,
    shared_plan_signature,
)
from .device import resolve_device
from .engine import SliceBoundsError, TileEngine
from .executor import (
    ChainPlan,
    ChainStats,
    OOCConfig,
    OutOfCoreExecutor,
    ResidentExecutor,
)
from .interp import (
    DataPlaneInterpreter,
    InterpResult,
    LedgerInterpreter,
    SpecState,
    simulate_plan,
)
from .mesh import DeviceMesh, HaloSpec, MeshError, ShardGeometry, parse_mesh
from .plan import (
    CarryEdge,
    Compute,
    Download,
    Elide,
    Evict,
    FetchHome,
    HaloExchange,
    HaloPack,
    HaloUnpack,
    PinUpload,
    Plan,
    PlanError,
    PlanOp,
    Prefetch,
    SpillHome,
    Upload,
    WritebackPinned,
    build_plan,
    format_plan,
    plans_from_json,
    plans_to_json,
)
from .verify import (
    Diagnostic,
    PlanVerificationError,
    VerifyResult,
    verify_plan,
    verify_plans,
)
from .fuzz import Mutation, check_mutations, enumerate_mutations
from .store import (
    BackingStore,
    ChunkedStore,
    MmapStore,
    RamStore,
    StoreConfig,
    StoreError,
    available_stores,
    load_checkpoint,
    make_store,
    register_store,
    save_checkpoint,
)
from .tune import TuneResult, tune_configs
from .sharded import ShardedOutOfCoreExecutor, ShardingError
from .program import (
    ExecutionConfig,
    Session,
    SessionClosedError,
    StencilProgram,
    StencilValidationError,
    infer_args,
    trace_kernel,
)
from .loop import (
    INC,
    READ,
    RW,
    WRITE,
    AccessMode,
    Accessor,
    Arg,
    ParallelLoop,
    ReductionSpec,
)
from .memory import (
    GB,
    H100,
    KNL_7210,
    P100_NVLINK,
    P100_PCIE,
    PRESETS,
    HardwareModel,
    TransferLedger,
)
from .stencil import Stencil, box_stencil, offset_stencil, point_stencil, star_stencil
from .tiling import TileSchedule, choose_num_tiles, make_tile_schedule
from .transfer import (
    Codec,
    ResidencyError,
    ResidencyManager,
    TransferEngine,
    TransferError,
    available_codecs,
    get_codec,
    register_codec,
)

__all__ = [
    "Block", "Dataset", "make_dataset", "datasets_from_numpy",
    "ChainInfo", "analyze_chain", "chain_signature", "plan_signature",
    "shared_plan_signature",
    "resolve_device", "SliceBoundsError", "TileEngine",
    "ChainPlan", "ChainStats", "OOCConfig", "OutOfCoreExecutor",
    "ResidentExecutor",
    "Session", "SessionClosedError", "StencilProgram", "ExecutionConfig",
    "StencilValidationError",
    "infer_args", "trace_kernel",
    "available_backends", "make_backend", "register_backend",
    "ReferenceBackend", "KernelBackend",
    "AccessMode", "Accessor", "Arg",
    "ParallelLoop", "ReductionSpec", "READ", "WRITE", "RW", "INC",
    "GB", "H100", "KNL_7210", "P100_NVLINK", "P100_PCIE", "PRESETS",
    "HardwareModel", "TransferLedger", "Stencil", "box_stencil",
    "offset_stencil", "point_stencil", "star_stencil", "TileSchedule",
    "choose_num_tiles", "make_tile_schedule",
    "Codec", "register_codec", "get_codec", "available_codecs",
    "TransferEngine", "TransferError", "ResidencyManager", "ResidencyError",
    "Plan", "PlanError", "PlanOp", "Upload", "Download", "Compute",
    "CarryEdge", "Elide",
    "Evict", "Prefetch", "PinUpload", "WritebackPinned", "FetchHome",
    "SpillHome", "HaloPack", "HaloExchange", "HaloUnpack", "build_plan",
    "format_plan", "plans_to_json", "plans_from_json",
    "DeviceMesh", "HaloSpec", "MeshError", "ShardGeometry", "parse_mesh",
    "ShardedOutOfCoreExecutor", "ShardingError",
    "Diagnostic", "VerifyResult", "PlanVerificationError", "verify_plan",
    "verify_plans", "Mutation", "enumerate_mutations", "check_mutations",
    "BackingStore", "RamStore", "MmapStore", "ChunkedStore", "StoreConfig",
    "StoreError", "make_store", "register_store", "available_stores",
    "save_checkpoint", "load_checkpoint",
    "LedgerInterpreter", "DataPlaneInterpreter", "InterpResult", "SpecState",
    "simulate_plan", "TuneResult", "tune_configs",
]
