"""The port's step analysis (``repro_torch.analysis``: the op-level cost
counter, the roofline with H100 constants, the dry-run roofline table) and
its cache and unified-memory model (``repro_torch.core.cachesim``) against
the JAX package's ``repro.analysis`` and ``repro.core.cachesim``.

Products and bytes are held to the reference's ``analyze_hlo_text`` on the
jitted JAX function (exact), the collectives to its ring conventions on
hand-written HLO (exact), and two faults of the reference are shown
against it: C8 (a reduce-scatter charged on its result) and C9 (the dots
of a ``conditional``'s branches count 0).  ``roofline_terms``,
``model_flops`` and ``simulate_chain`` equal the reference's field for
field.
"""
import json
import math
import os
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.analysis.roofline as JR  # noqa: E402
import repro.configs as JC  # noqa: E402
import repro_torch.analysis.roofline as TR  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.analysis.hlo_analysis import (  # noqa: E402
    _CALL_ATTR_RE,
    _TRIP_RE,
    _WHILE_RE,
    _dot_flops,
    analyze_hlo_text,
    parse_hlo,
)
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models.ssm import mamba2_forward as j_mamba2_forward  # noqa: E402
from repro_torch.analysis import H100_SXM, analyze_step, model_flops, roofline_terms  # noqa: E402
from repro_torch.analysis.op_analysis import OpCostLog  # noqa: E402
from repro_torch.models import forward, init_params, loss_fn  # noqa: E402
from repro_torch.models.ssm import mamba2_forward  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
# The reference's dot FLOPs at the reduced configs, B = 2, S = 64.
REFERENCE_DOT_FLOPS = {"llama3_2_1b": 100_663_296, "llama3_2_1b/grad": 369_098_752,
                       "qwen3_moe_30b_a3b": 99_221_504, "deepseek_v2_lite_16b": 47_448_064,
                       "zamba2_1_2b": 208_666_624, "mamba2_1_3b": 112_721_920}
# The reference's TPU constants, as a Hardware record for this test only.
REFERENCE_HW = TR.Hardware(name="reference", peak_flops=JR.PEAK_FLOPS, hbm_bw=JR.HBM_BW,
                           ici_bw=JR.ICI_BW, dcn_bw=JR.DCN_BW)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("_chip_smoke_analysis",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _records(text: str) -> dict:
    recs = {}
    for line in text.splitlines():
        rec = json.loads(line)
        recs.setdefault(rec["phase"], []).append(rec)
    return recs


def _hlo(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


def _tokens(cfg):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _reference_forward_hlo(arch) -> str:
    cfg = JC.get_reduced_config(arch)
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    return _hlo(lambda p, t: j_forward(p, cfg, t), params, jnp.asarray(_tokens(cfg)))


def _port_forward_flops(arch) -> float:
    cfg = TC.get_reduced_config(arch)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(_tokens(cfg)).long()
    with torch.no_grad():
        return analyze_step(lambda: forward(model, tokens), 1)["dot_flops"]


# -- products and bytes --------------------------------------------------------
def test_scan_module_products_and_bytes():
    """The reference's own scan module (``tests/test_analysis.py``): L
    matmuls and ``tanh`` in a ``lax.scan``, against a torch loop of the
    same; both count 2·N³·L, and the port's bytes stay within the reference
    test's bounds."""
    N, L = 64, 7

    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=L)[0]

    spec = jax.ShapeDtypeStruct((N, N), jnp.float32)
    ref = analyze_hlo_text(_hlo(f, spec, spec), total_devices=1)
    x = torch.randn(N, N, generator=torch.Generator().manual_seed(0))
    w = torch.randn(N, N, generator=torch.Generator().manual_seed(1))

    def loop():
        c = x
        for _ in range(L):
            c = torch.tanh(c @ w)
        return c
    got = analyze_step(loop, 1)
    assert ref["dot_flops"] == got["dot_flops"] == 2 * N ** 3 * L
    lower = L * 2 * N * N * 4
    assert lower <= got["hbm_bytes"] <= 100 * lower
    assert got["num_ops"] == 2 * L and got["conv_flops"] == 0.0


def test_lone_matmul_bytes_equal_the_reference():
    N = 64
    spec = jax.ShapeDtypeStruct((N, N), jnp.float32)
    ref = analyze_hlo_text(_hlo(lambda a, b: a @ b, spec, spec), total_devices=1)
    a, b = torch.ones(N, N), torch.ones(N, N)
    got = analyze_step(lambda: a @ b, 1)
    assert got["hbm_bytes"] == ref["hbm_bytes"] == 3 * N * N * 4
    assert got["dot_flops"] == ref["dot_flops"] == 2 * N ** 3


def test_byte_rules_views_gathers_and_scatters():
    """Views cost 0; an embedding reads what it produces plus the indices;
    a copy into a view and ``index_put_`` cost twice the update."""
    x = torch.zeros(64, 32)
    idx = torch.arange(8)
    got = analyze_step(lambda: x.view(32, 64).t().unsqueeze(0).expand(3, -1, -1)[1, :10], 1)
    assert got["hbm_bytes"] == 0 and got["num_ops"] == 6
    got = analyze_step(lambda: x.t().reshape(-1), 1)             # a copy, not a view
    assert got["hbm_bytes"] == 2 * 64 * 32 * 4
    got = analyze_step(lambda: torch.nn.functional.embedding(idx, x), 1)
    assert got["hbm_bytes"] == 2 * 8 * 32 * 4 + 8 * 8
    got = analyze_step(lambda: x[:4].copy_(torch.ones(4, 32)), 1)
    assert got["hbm_bytes"] == 4 * 32 * 4 + 2 * 4 * 32 * 4      # ones writes, copy_ 2x
    got = analyze_step(lambda: x.index_put_((idx,), torch.ones(8, 32)), 1)
    assert got["hbm_bytes"] == 8 * 32 * 4 + 2 * 8 * 32 * 4


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b_a3b"])
def test_forward_dot_flops_equal_the_reference(arch):
    ref = analyze_hlo_text(_reference_forward_hlo(arch), 1)["dot_flops"]
    assert ref == REFERENCE_DOT_FLOPS[arch]
    assert _port_forward_flops(arch) == ref


def test_remat_gradient_dot_flops_equal_the_reference():
    """``jax.grad`` of the remat ``loss_fn`` against the port's backward of
    its remat ``loss_fn`` (forward, recompute and backward products)."""
    arch = "llama3_2_1b"
    jcfg, tcfg = JC.get_reduced_config(arch), TC.get_reduced_config(arch)
    tokens = _tokens(jcfg)
    labels = np.roll(tokens, -1, axis=1)
    params = j_init_params(jcfg, jax.random.PRNGKey(0))
    text = _hlo(jax.grad(lambda p, t, y: j_loss_fn(p, jcfg, t, y, remat=True)),
                params, jnp.asarray(tokens), jnp.asarray(labels))
    ref = analyze_hlo_text(text, 1)["dot_flops"]
    model = init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.requires_grad_(True)
    t, y = torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()
    got = analyze_step(lambda: loss_fn(model, t, y, remat=True).backward(), 1)
    assert ref == REFERENCE_DOT_FLOPS["llama3_2_1b/grad"]
    assert got["dot_flops"] == ref


def test_dot_flops_equal_flop_counter_mode_beside_it():
    from torch.utils.flop_counter import FlopCounterMode

    cfg = TC.get_reduced_config("deepseek_v2_lite_16b")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    log = OpCostLog()
    with torch.no_grad(), FlopCounterMode(display=False) as flops, log:
        forward(model, torch.from_numpy(_tokens(cfg)).long())
    assert log.summary()["dot_flops"] == flops.get_total_flops() > 0


# -- C9: the reference does not reach a conditional's branches ---------------
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")


def _dot_flops_with_branches(text: str, shares) -> float:
    """The reference's dot FLOPs, its multipliers propagated as its
    ``_multipliers`` does and also into each ``conditional``'s branch i at
    ``shares[i]`` of the conditional's invocations (test-local; the
    reference is not changed)."""
    mod = parse_hlo(text)
    mult = defaultdict(float)
    mult[mod.entry] = 1.0
    for _ in range(64):
        changed = False
        for comp, ops in mod.comps.items():
            m = mult.get(comp, 0.0)
            if not m:
                continue
            for op in ops:
                if op.opcode == "while":
                    wm, tm = _WHILE_RE.search(op.rest), _TRIP_RE.search(op.rest)
                    n = float(tm.group(1)) if tm else 1.0
                    calls = [(wm.group(2), m * n), (wm.group(1), m * (n + 1))]
                elif op.opcode == "conditional":
                    names = re.findall(r"[\w.\-]+", _BRANCHES_RE.search(op.rest).group(1))
                    calls = [(c, m * shares[i]) for i, c in enumerate(names)]
                else:
                    calls = [(c, m) for c in _CALL_ATTR_RE.findall(op.rest)]
                for callee, new in calls:
                    if callee in mod.comps and mult.get(callee, 0.0) < new:
                        mult[callee] = new
                        changed = True
        if not changed:
            break
    return sum(mult.get(comp, 0.0) * _dot_flops(op, mod.symbols.get(comp, {}))
               for comp, ops in mod.comps.items() for op in ops if op.opcode == "dot")


def test_c9_reference_counts_no_dot_in_a_conditional_branch():
    text = """HloModule m

%then (a: f32[16,32]) -> f32[16,8] {
  %a = f32[16,32]{1,0} parameter(0)
  %w = f32[32,8]{1,0} constant({...})
  ROOT %d = f32[16,8]{1,0} dot(%a, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%else (b: f32[16,32]) -> f32[16,8] {
  %b = f32[16,32]{1,0} parameter(0)
  ROOT %s = f32[16,8]{1,0} slice(%b), slice={[0:16], [0:8]}
}

ENTRY %main (p: s32[], x: f32[16,32]) -> f32[16,8] {
  %p = s32[] parameter(0)
  %x = f32[16,32]{1,0} parameter(1)
  ROOT %c = f32[16,8]{1,0} conditional(%p, %x, %x), branch_computations={%else, %then}
}
"""
    assert analyze_hlo_text(text, 1)["dot_flops"] == 0.0
    assert _dot_flops_with_branches(text, (0.0, 1.0)) == 2 * 16 * 8 * 32
    x, w = torch.ones(16, 32), torch.ones(32, 8)
    taken = True
    got = analyze_step(lambda: x @ w if taken else x[:, :8].clone(), 1)
    assert got["dot_flops"] == 2 * 16 * 8 * 32


def _sc_flops(cfg) -> int:
    """The final chunk state's product of a Mamba-2 layer at B x S
    (``bjn,bjh,bjhp->bhpn``, one chunk here): 2·B·H·P·N·Q."""
    q = min(S, cfg.ssm_chunk)
    return 2 * B * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * q


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "zamba2_1_2b"])
def test_c9_port_equals_the_reference_once_its_branches_are_reached(arch):
    """DeepSeek-V2-Lite's layers are dense (branch 1, the first layer) or
    moe (branch 0); Zamba2's shared block (branch 1) runs after every third
    Mamba layer.  Reached at those shares, the reference counts the port's
    products; Zamba2's port adds its Mamba layers' final-state products,
    which XLA drops (the Mamba2 test)."""
    cfg = JC.get_reduced_config(arch)
    text = _reference_forward_hlo(arch)
    assert analyze_hlo_text(text, 1)["dot_flops"] == REFERENCE_DOT_FLOPS[arch]
    if arch == "deepseek_v2_lite_16b":
        dense = cfg.first_dense_layers / cfg.num_layers
        shares, dead = (1 - dense, dense), 0
    else:
        sites = (cfg.num_layers // cfg.shared_attn_every) / cfg.num_layers
        shares, dead = (1 - sites, sites), cfg.num_layers * _sc_flops(cfg)
    reached = _dot_flops_with_branches(text, shares)
    got = _port_forward_flops(arch)
    assert got > REFERENCE_DOT_FLOPS[arch]
    assert got == reached + dead


def test_mamba2_gap_is_the_final_state_product_xla_drops():
    """Mamba2 has no conditional: the port counts 3,145,728 more (2.8%).
    The forward discards each layer's final ssm state, so XLA removes the
    product that makes it; the port's eager scan computes it.  One mixer
    jitted with its state kept counts exactly the port's products."""
    arch = "mamba2_1_3b"
    jcfg, tcfg = JC.get_reduced_config(arch), TC.get_reduced_config(arch)
    assert analyze_hlo_text(_reference_forward_hlo(arch), 1)["dot_flops"] == \
        REFERENCE_DOT_FLOPS[arch]
    got = _port_forward_flops(arch)
    assert got - REFERENCE_DOT_FLOPS[arch] == jcfg.num_layers * _sc_flops(jcfg) == 3_145_728

    params = j_init_params(jcfg, jax.random.PRNGKey(0))
    mixer = jax.tree.map(lambda a: a[0], params["blocks"]["mamba"])
    x = jnp.zeros((B, S, jcfg.d_model), jnp.float32)
    dropped = analyze_hlo_text(_hlo(lambda p, x: j_mamba2_forward(p, x, jcfg)[0], mixer, x),
                               1)["dot_flops"]
    kept = analyze_hlo_text(_hlo(lambda p, x: j_mamba2_forward(p, x, jcfg), mixer, x),
                            1)["dot_flops"]
    assert kept - dropped == _sc_flops(jcfg)
    model = init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    xt = torch.zeros(B, S, tcfg.d_model)
    with torch.no_grad():
        port = analyze_step(lambda: mamba2_forward(model.blocks[0].mamba, xt, tcfg), 1)
    assert port["dot_flops"] == kept


# -- collectives on a fake process group of 16 ranks -------------------------
_COLLECTIVES = {
    "all-gather": ("f32[{n}]{{0}} all-gather(%p), replica_groups={groups}, dimensions={{0}}",
                   lambda g: 64 * g),
    "all-reduce": ("f32[{n}]{{0}} all-reduce(%p), replica_groups={groups}, to_apply=%add",
                   lambda g: 64),
    "all-to-all": ("f32[{n}]{{0}} all-to-all(%p), replica_groups={groups}, dimensions={{0}}",
                   lambda g: 64),
    "reduce-scatter": ("f32[{n}]{{0}} reduce-scatter(%p), replica_groups={groups}, "
                       "dimensions={{0}}, to_apply=%add", lambda g: 64 // g),
}


def _reference_collective(kind: str, g: int) -> dict:
    body, n = _COLLECTIVES[kind]
    groups = f"[{16 // g},{g}]<=[16]"
    text = ("HloModule m\n\nENTRY %main (p: f32[64]) -> f32[64] {\n"
            "  %p = f32[64]{0} parameter(0)\n"
            f"  %c = {body.format(n=n(g), groups=groups)}\n"
            "  ROOT %r = f32[64]{0} copy(%p)\n}\n")
    return analyze_hlo_text(text, total_devices=16)


@pytest.fixture(scope="module")
def fake16():
    """A ``fake`` process group of 16 ranks (this process is rank 0) with
    subgroups of 8 and of 2; destroyed after the module's tests."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_process_group

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    fake_process_group(16)
    try:
        yield {8: dist.new_group(list(range(8))), 2: dist.new_group([0, 1])}
    finally:
        dist.destroy_process_group()


def _port_collective(kind: str, group) -> dict:
    import torch.distributed._functional_collectives as funcol

    x = torch.ones(64)
    run = {"all-gather": lambda: funcol.all_gather_tensor(x, 0, group),
           "all-reduce": lambda: funcol.all_reduce(x, "sum", group),
           "all-to-all": lambda: funcol.all_to_all_single(x, None, None, group),
           "reduce-scatter": lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group)}[kind]
    return analyze_step(lambda: funcol.wait_tensor(run()), 16)


@pytest.mark.parametrize("g", [8, 2])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "all-to-all"])
def test_collective_wire_bytes_and_buckets_equal_the_reference(fake16, kind, g):
    ref, got = _reference_collective(kind, g), _port_collective(kind, fake16[g])
    for key in ("collective_wire_bytes", "collective_bytes_ici", "collective_bytes_dcn",
                "collective_op_counts"):
        assert got[key] == ref[key], key
    assert (got["collective_bytes_dcn"] > 0) == (g == 2)
    if kind == "all-gather" and g == 8:
        assert got["collective_bytes_ici"] == 1792


def test_c8_reduce_scatter_is_charged_on_its_input(fake16):
    """The reference charges the result (32 B x 7/8 = 28 B); a ring sends
    7 chunks of 32 B, the input x (g-1)/g = 224 B."""
    ref = _reference_collective("reduce-scatter", 8)
    got = _port_collective("reduce-scatter", fake16[8])
    assert ref["collective_wire_bytes"] == {"reduce-scatter": 28.0}
    assert got["collective_wire_bytes"] == {"reduce-scatter": 224.0}
    assert got["collective_bytes_ici"] == 224.0 and got["collective_bytes_dcn"] == 0.0


# -- the roofline --------------------------------------------------------------
def test_no_tpu_constant_in_the_port():
    text = "\n".join(p.read_text() for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    for tpu in ("197e12", "819e9", "6.25e9"):
        assert tpu not in text
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw) == (989e12, 3.35e12)


_ROOFLINE_HLO = """HloModule m

ENTRY %main (p: f32[4096,64]) -> f32[4096,64] {{
  %p = f32[4096,64]{{1,0}} parameter(0)
  %w = f32[64,64]{{1,0}} constant({{...}})
  %d = f32[4096,64]{{1,0}} dot(%p, %w), lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}
  ROOT %ar = f32[4096,64]{{1,0}} all-reduce(%d), replica_groups={groups}, to_apply=%add
}}
"""


@pytest.mark.parametrize("arch,shape,devices,groups", [
    ("llama3_2_1b", "train_4k", 16, "[2,8]<=[16]"),
    ("qwen3_moe_30b_a3b", "decode_32k", 256, "[16,16]<=[256]"),
    ("mamba2_1_3b", "prefill_32k", 512, "[256,2]<=[512]")])
def test_roofline_terms_equal_the_reference(arch, shape, devices, groups):
    """The port's ``roofline_terms`` fed ``analyze_hlo_text``'s dict and the
    reference's constants equals the reference's, key for key."""
    from repro.models.config import SHAPES as J_SHAPES

    from repro_torch.models.config import SHAPES as T_SHAPES

    text = _ROOFLINE_HLO.format(groups=groups)
    want = JR.roofline_terms(text, devices, JC.get_config(arch), J_SHAPES[shape])
    got = roofline_terms(analyze_hlo_text(text, devices), devices, TC.get_config(arch),
                         T_SHAPES[shape], hw=REFERENCE_HW)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    assert got["collective_s"] > 0 and got["compute_s"] > 0


def test_model_flops_equal_the_reference_for_every_cell():
    j_cells = [(a, s.name) for a, s in JC.all_cells()]
    t_cells = [(a, s) for a, s in TC.all_cells()]
    assert [(a, s.name) for a, s in t_cells] == j_cells
    for (arch, shape), (_, j_shape) in zip(t_cells, JC.all_cells()):
        assert model_flops(TC.get_config(arch), shape) == \
            JR.model_flops(JC.get_config(arch), j_shape)


def test_analyze_report_dir_reads_the_dry_run_records(tmp_path, monkeypatch):
    """``launch/dryrun.py`` on a reduced cell (a child process: the fake
    group is process-wide) writes an ``analysis`` block into each record;
    the table reads it, and ``python -m repro_torch.analysis.roofline``
    writes its markdown, whose header is the reference's."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3_moe_30b_a3b",
         "--shape", "decode_32k", "--reduced", "--multi-pod", "both", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    rows = TR.analyze_report_dir(str(tmp_path))
    assert [r["file"] for r in rows] == ["qwen3_moe_30b_a3b_decode_32k_pod1_reduced.json",
                                         "qwen3_moe_30b_a3b_decode_32k_pod2_reduced.json"]
    for r in rows:
        rec = json.loads((tmp_path / r["file"]).read_text())
        a = rec["analysis"]
        assert a["dot_flops"] == rec["cost_analysis"]["flops"] > 0
        assert a["hbm_bytes"] > 0 and math.isfinite(r["bound_s"]) and r["bound_s"] > 0
        assert r["dominant"] in ("compute", "memory", "collective")
        assert a["collective_op_counts"] and r["ici_bytes"] > 0
        assert {k: r[k] for k in a["roofline"]} == a["roofline"]
    monkeypatch.chdir(tmp_path)
    assert TR.main([str(tmp_path)]) == 0
    md = (tmp_path / "reports" / "roofline_torch.md").read_text().splitlines()
    assert md[:2] == JR._to_markdown([]).splitlines()[:2]
    assert len(md) == 4 and "**" in md[2]
    # chip_smoke.py phase 16's table over the same records, on two Hardware
    cs = _chip_smoke()
    half = TR.Hardware("half", *(v / 2 for v in (H100_SXM.peak_flops, H100_SXM.hbm_bw,
                                                       H100_SXM.ici_bw, H100_SXM.dcn_bw)))
    cs.analysis_dryrun("cpu", tmp_path, (H100_SXM, half), records=2)
    with pytest.raises(RuntimeError, match="dry-run rows"):
        cs.analysis_dryrun("cpu", tmp_path, (H100_SXM,), records=4)


def test_chip_smoke_analysis_phase_runs_on_the_cpu(capsys):
    """Phase 16's (b) and (d) of ``chip_smoke.py`` on the CPU: Llama's
    reduced config in bf16 (a training step of 2 x 64 tokens in two
    microbatches, a decode step of batch 4 after 8 tokens) and CloverLeaf
    2D's timestep chain at 512^2; every gate holds (here the "card" is the
    CPU, its times host times)."""
    cs = _chip_smoke()
    cfg = TC.get_reduced_config("llama3_2_1b").with_(dtype="bfloat16")
    cs.analysis_train("cpu", (H100_SXM,), device="cpu", cfg=cfg,
                      train=dict(seq=64, batch=2, microbatches=2))
    cs.analysis_decode("cpu", (H100_SXM,), device="cpu", cfg=cfg,
                       decode=dict(batch=4, prompt_len=8))
    cs.analysis_cachesim("cpu", 512, device="cpu")
    recs = _records(capsys.readouterr().out)
    train, decode = recs["analysis_train"][0], recs["analysis_decode"][0]
    assert train["outputs_equal"] and decode["outputs_equal"]
    assert train["dot_flops"] == train["flop_counter_flops"] == train["fake_dot_flops"]
    assert train["dot_flops"] >= train["six_n_t"]
    assert train["hbm_bytes"] == train["fake_hbm_bytes"] > 0
    assert decode["dot_flops"] == decode["flop_counter_flops"] == decode["fake_dot_flops"]
    assert decode["hbm_bytes"] >= decode["weight_bytes"]
    roof = train["roofline"][H100_SXM.name]
    assert roof["dominant"] in ("compute", "memory") and 0 < roof["roofline_fraction"] < 1
    sim = recs["analysis_cachesim"][0]
    assert sim["tiles"] > 1 and "raised" in sim["results"]["flat_fast"]
    assert sim["results"]["um_tiled"]["faults"] > 0


# -- core/cachesim.py ----------------------------------------------------------
MODES = ("flat_fast", "flat_slow", "cache", "um", "um_prefetch")


def _app_loops(pkg: str, app: str):
    """One timestep chain of ``app`` at a small size, recorded by ``pkg``'s
    reference Session, as the reference's ``benchmarks/um_scaling.py`` does
    (OpenSBLI: the two timesteps of its chain)."""
    if pkg == "jax":
        from repro.apps import CloverLeaf2D, CloverLeaf3D, OpenSBLI
        from repro.core import Session
        rt = Session("reference")
    else:
        from repro_torch.apps import CloverLeaf2D, CloverLeaf3D, OpenSBLI
        from repro_torch.core import Session
        rt = Session("reference", device="cpu")
    make, steps = {"cloverleaf2d": (lambda: CloverLeaf2D(40, 32, summary_every=0), 1),
                   "cloverleaf3d": (lambda: CloverLeaf3D(12, 10, 8, summary_every=0), 1),
                   "opensbli": (lambda: OpenSBLI(12), 2)}[app]
    a = make()
    a.dt = 1e-4
    for _ in range(steps):
        a.record_timestep(rt)
    loops = list(rt.queue)
    rt.queue.clear()
    return loops, a.total_bytes()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("app", ["cloverleaf2d", "cloverleaf3d", "opensbli"])
def test_simulate_chain_equals_the_reference(app, mode):
    """Every mode, tiled (4 tiles) and not, with and without warm-up, on
    4 KiB pages and a fast memory of a third of the homes (everything for
    ``flat_fast``, which raises MemoryError at a third in both)."""
    from repro.core import P100_PCIE as J_P100
    from repro.core.cachesim import simulate_chain as j_simulate

    from repro_torch.core import P100_PCIE as T_P100
    from repro_torch.core.cachesim import simulate_chain as t_simulate

    j_loops, total = _app_loops("jax", app)
    t_loops, t_total = _app_loops("torch", app)
    assert t_total == total and [lp.name for lp in t_loops] == [lp.name for lp in j_loops]
    kw = dict(page_bytes=4096, fast_capacity=total / 3)
    j_hw, t_hw = J_P100.with_(**kw), T_P100.with_(**kw)
    if mode == "flat_fast":
        for sim, loops, hw in ((j_simulate, j_loops, j_hw), (t_simulate, t_loops, t_hw)):
            with pytest.raises(MemoryError, match="flat_fast"):
                sim(loops, hw, mode=mode)
        j_hw, t_hw = j_hw.with_(fast_capacity=3 * total), t_hw.with_(fast_capacity=3 * total)
    for tiled in (False, True):
        for warmup in (True, False):
            opts = dict(mode=mode, tiled=tiled, num_tiles=4, warmup=warmup)
            want = j_simulate(j_loops, j_hw, **opts)
            got = t_simulate(t_loops, t_hw, **opts)
            assert vars(got) == vars(want), opts
            assert (got.achieved_bw, got.hit_rate) == (want.achieved_bw, want.hit_rate)
            assert got.useful_bytes > 0 and got.time_s > 0
