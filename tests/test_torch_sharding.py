"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's ``repro.distributed.sharding``, and the host-only dry run
(``repro_torch.launch.dryrun``).

For all ten configs at their published widths, on stand-in meshes of
(16, 16) and (2, 16, 16) (the rules read only axis names and sizes): every
parameter's spec equal to the reference's leaf for leaf (the port's
parameters built under ``FakeTensorMode``, the reference's by
``jax.eval_shape``; the reference's stacked layer axis, whose entry is
``None``, dropped), ``batch_specs`` and ``cache_specs`` equal for every
``shape_cells`` cell, and the bytes one device holds of a cell's inputs
(parameters, AdamW moments and step, batch; or parameters, cache and
tokens) from the port's specs equal to the sum of the JAX shard shapes
(``NamedSharding(AbstractMesh, spec).shard_shape``).  DeepSeek-V2-Lite's
layers hold one FFN each in the port and both in the reference, so its
unused copies are left out of the JAX sum.  Then the dry run on two
reduced cells on the 256-rank fake group, its record's argument bytes
equal to the same JAX sum.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import specs as JSPEC  # noqa: E402
from repro.models.config import SHAPES  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(key):
    shape, names = MESHES[key]
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def _norm(spec):
    """A spec as a tuple whose one-name tuples are the name (JAX's
    ``PartitionSpec`` stores ``('data',)`` as ``'data'``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _jax_cfg(arch, reduced=False):
    return JC.get_reduced_config(arch) if reduced else JC.get_config(arch)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, reduced=False):
    return JSPEC.params_sds(_jax_cfg(arch, reduced))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """name -> (shape, dtype) of the port's Transformer at published widths."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        model = Transformer(TC.get_config(arch), device="cpu")
        return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


def _leaf(tree, name):
    """The reference leaf of the port's parameter ``name`` and whether it
    is stacked over the layers."""
    parts = name.split(".")
    stacked = parts[0] in TS.STACKED
    node = tree[parts[0]]
    for k in (parts[2:] if stacked else parts[1:]):
        node = node[k]
    return node, stacked


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    m = _stand_in(mesh)
    jspecs = JS.param_specs(_jax_params(arch), jcfg, m)
    shapes = _port_params(arch)
    got = TS.param_specs({n: torch.empty(s, device="meta")
                          for n, (s, _) in shapes.items()}, tcfg, m)
    assert got.keys() == shapes.keys()
    for name, spec in got.items():
        want, stacked = _leaf(jspecs, name)
        want = tuple(want)[1:] if stacked else tuple(want)
        assert _norm(spec) == _norm(want), name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_batch_and_cache_specs_equal_jax(arch, mesh):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    m = _stand_in(mesh)
    for shape in JC.shape_cells(arch):
        for include_model in (False, True):
            want = JS.batch_specs(jcfg, m, shape.global_batch, include_model=include_model)
            got = TS.batch_specs(tcfg, m, shape.global_batch, include_model=include_model)
            assert {k: _norm(v) for k, v in got.items()} == \
                {k: _norm(tuple(v)) for k, v in want.items()}
        want = JS.cache_specs(jcfg, m, shape.global_batch)
        got = TS.cache_specs(tcfg, m, shape.global_batch)
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(tuple(v)) for k, v in want.items()}, shape.name


@functools.lru_cache(maxsize=None)
def _jax_inputs(arch, reduced, shape_name):
    """The reference's ``input_specs`` but for the optimizer state (its
    moments are the parameters' shapes in fp32), the parameters traced once
    per config."""
    shape, jcfg = SHAPES[shape_name], _jax_cfg(arch, reduced)
    out = {"params": _jax_params(arch, reduced)}
    if shape.kind == "decode":
        out.update(cache=JSPEC.cache_sds(jcfg, shape), tokens=JSPEC.decode_tokens_sds(shape))
    else:
        out["batch"] = JSPEC.batch_specs_sds(jcfg, shape)
    return out


@functools.lru_cache(maxsize=None)
def _port_inputs(tcfg, shape_name):
    """name -> (shape, dtype) of the parameters, and of the batch or the
    cache, from ``launch/specs.py``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import specs

    shape = SHAPES[shape_name]
    with FakeTensorMode():
        params = {n: (tuple(p.shape), p.dtype)
                  for n, p in specs.params_fake(tcfg).named_parameters()}
        rest = (specs.cache_fake(tcfg, shape) if shape.kind == "decode"
                else specs.batch_specs_fake(tcfg, shape))
    return params, {k: (tuple(v.shape), v.dtype) for k, v in rest.items() if k != "len"}


def _jax_bytes(arch, shape, mesh_key, reduced=False, tp=True) -> int:
    """The bytes one device holds of the cell's inputs, from the JAX shard
    shapes of the reference's specs (``AbstractMesh``)."""
    jcfg = _jax_cfg(arch, reduced)
    dims, names = MESHES[mesh_key]
    amesh = AbstractMesh(dims, names)
    m = _stand_in(mesh_key)

    def nbytes(leaf, spec, layers=None):
        local = NamedSharding(amesh, spec).shard_shape(tuple(leaf.shape))
        n = int(np.prod(local, dtype=np.int64)) * np.dtype(leaf.dtype).itemsize
        if layers is not None:              # only ``layers`` of the stacked leaf
            n = n // leaf.shape[0] * layers
        return n

    specs = _jax_inputs(arch, reduced, shape.name)
    params = specs["params"]
    p_specs = JS.param_specs(params, jcfg, m, tp=tp)
    nd = jcfg.first_dense_layers
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        spec = functools.reduce(lambda t, k: t[k], keys, p_specs)
        layers = None
        if nd and keys[0] == "blocks" and keys[1] in ("mlp", "moe"):
            layers = nd if keys[1] == "mlp" else jcfg.num_layers - nd
        copies = 3 if shape.kind == "train" else 1           # mu and nu, fp32
        total += nbytes(leaf, spec, layers)
        if copies == 3:
            f32 = jax.ShapeDtypeStruct(leaf.shape, np.float32)
            total += 2 * nbytes(f32, spec, layers)
    if shape.kind == "train":
        total += 4                                            # step
        b = JS.batch_specs(jcfg, m, shape.global_batch, include_model=not tp)
        total += sum(nbytes(v, b[k]) for k, v in specs["batch"].items())
    elif shape.kind == "prefill":
        b = JS.batch_specs(jcfg, m, shape.global_batch)
        total += sum(nbytes(v, b[k]) for k, v in specs["batch"].items())
    else:
        c = JS.cache_specs(jcfg, m, shape.global_batch)
        total += sum(nbytes(v, c[k]) for k, v in specs["cache"].items())
        ba = tuple(a for a in names if a in ("pod", "data"))
        nb = int(np.prod([dict(zip(names, dims))[a] for a in ba]))
        total += nbytes(specs["tokens"], P(ba if shape.global_batch % nb == 0 else None))
    return total


def _port_bytes(tcfg, shape, mesh_key) -> int:
    """The same from the port's specs and ``launch/specs.py``'s inputs."""
    from repro_torch.distributed.spmd import bspec

    m = _stand_in(mesh_key)
    shapes, rest = _port_inputs(tcfg, shape.name)
    p_specs = TS.param_specs({n: torch.empty(s, device="meta") for n, (s, _) in shapes.items()},
                             tcfg, m)
    total = TS.local_bytes(shapes, p_specs, m)
    if shape.kind == "train":
        total += 2 * TS.local_bytes({n: (s, torch.float32) for n, (s, _) in shapes.items()},
                                    p_specs, m) + 4
    if shape.kind != "decode":
        total += TS.local_bytes(rest, TS.batch_specs(tcfg, m, shape.global_batch), m)
    else:
        total += TS.local_bytes(rest, TS.cache_specs(tcfg, m, shape.global_batch), m) + 4
        total += TS.local_bytes({"tokens": ((shape.global_batch,), torch.int32)},
                                {"tokens": (bspec(m, shape.global_batch),)}, m)
    return total


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_argument_bytes_per_device_equal_jax_shard_shapes(arch):
    tcfg = TC.get_config(arch)
    for shape in JC.shape_cells(arch):
        for mesh_key in sorted(MESHES):
            assert _port_bytes(tcfg, shape, mesh_key) == _jax_bytes(arch, shape, mesh_key), \
                (shape.name, mesh_key)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    m = _stand_in("pod2")
    assert TS.placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert TS.placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements((("data", "pod"),), m)
    assert TS.local_shape((256, 4096, 2048), (("pod", "data"), None, "model"), m) == \
        (8, 4096, 128)


@pytest.mark.parametrize("arch, shape", [("llama3_2_1b", "train_4k"),
                                         ("qwen3_moe_30b_a3b", "decode_32k")])
def test_dryrun_writes_its_record(tmp_path, arch, shape):
    """Two reduced cells on the 256-rank fake group, in a child process
    (the fake group is process-wide): the record's argument bytes equal the
    JAX shard shapes' sum for the same config and cell."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--reduced", "--multi-pod", "off", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "1 passed, 0 failed" in out.stdout
    rec = json.loads((tmp_path / f"{arch}_{shape}_pod1_reduced.json").read_text())
    assert rec["devices"] == 256 and rec["mesh"] == "data=16xmodel=16"
    assert rec["device"].startswith("none")
    want = _jax_bytes(arch, SHAPES[shape], "pod1", reduced=True)
    assert rec["memory"]["argument_bytes_per_device"] == want
    assert rec["memory"]["peak_estimate_per_device"] >= want
    assert rec["cost_analysis"]["flops"] > 0 and rec["model_flops"] > 0
    assert sum(rec["collectives"]["count_by_op"].values()) > 0
