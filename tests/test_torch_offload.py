"""Layer-weight streaming in the port (``repro_torch.models.offload``) and the
model-decode launcher, against the port's resident ``decode_step`` and the
JAX package's ``repro.models.offload.StreamedDecoder``.

Streamed decode runs ``decode_step``'s ops on views of the streamed slots, so
its logits are equal to the resident ones (``torch.equal``).  Against the JAX
package, both streamers get ``hw=P100_PCIE`` and the same weights: logits at
fp32 rtol 1e-4 / atol 1e-5 (the JAX package's own offload tolerance), and the
uploaded bytes and the modelled step equal, since both keep the same ring.
On the card ``chip_smoke.py --model`` runs the same path at Llama 3.2 1B's
published widths.
"""
import jax
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.core.memory as JM  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.core.memory as TM  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.offload import StreamedDecoder as JStreamedDecoder  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import CacheFullError, decode_step, init_cache, init_params  # noqa: E402
from repro_torch.models.offload import StreamedDecoder  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

CPU = "cpu"
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


def _tokens(vocab, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch,layers,window", [
    ("llama3_2_1b", 2, 2), ("llama3_2_1b", 5, 2), ("llama3_2_1b", 5, 3),
    ("qwen2_5_14b", 4, 3), ("internvl2_76b", 3, 2)])
def test_streamed_decode_equals_resident_decode(arch, layers, window):
    cfg = TC.get_reduced_config(arch).with_(num_layers=layers)
    model = init_params(cfg, generator=torch.Generator().manual_seed(1), device=CPU)
    B, T = 2, 6
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, B, T)).long()
    resident = init_cache(cfg, B, T, device=CPU)
    streamed = init_cache(cfg, B, T, device=CPU)
    streamer = StreamedDecoder(model, window=window)
    for t in range(T):
        want, resident = decode_step(model, resident, tokens[:, t])
        got, streamed = streamer.decode(streamed, tokens[:, t])
        assert torch.equal(got, want)
    assert torch.equal(streamed["k"], resident["k"]) and torch.equal(streamed["v"], resident["v"])
    assert streamed["len"] == T
    assert len(streamer._ring) <= streamer.window


@pytest.mark.parametrize("layers,window", [(2, 2), (6, 2), (6, 3)])
def test_streamed_decode_matches_the_reference(layers, window):
    jcfg = JC.get_reduced_config("llama3_2_1b").with_(num_layers=layers)
    params = j_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(TC.get_reduced_config("llama3_2_1b").with_(num_layers=layers),
                              jax.tree.map(np.asarray, params), device=CPU)
    B, T = 2, 6
    tokens = _tokens(jcfg.vocab_size, B, T, seed=3)
    jstream = JStreamedDecoder(params, jcfg, window=window, hw=JM.P100_PCIE)
    tstream = StreamedDecoder(model, window=window, hw=TM.P100_PCIE)
    jc = j_init_cache(jcfg, B, T)
    tc = init_cache(model.cfg, B, T, device=CPU)
    for t in range(T):
        jl, jc = jstream.decode(jc, jnp.asarray(tokens[:, t]))
        tl, tc = tstream.decode(tc, torch.from_numpy(tokens[:, t]).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        assert tstream.stats.uploaded_bytes == jstream.stats.uploaded_bytes
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **F32)
    assert tstream.stats.steps == jstream.stats.steps == T
    assert tstream.stats.modelled_step_s == jstream.stats.modelled_step_s > 0
    assert tstream.device_resident_bytes() == jstream.device_resident_bytes()
    assert sorted(tstream._ring) == sorted(jstream._ring)


def test_streaming_window_bounds_memory(monkeypatch):
    """As the JAX package's test: the device holds at most ``window`` slices,
    and the port allocates exactly ``window`` slots and reuses them."""
    cfg = TC.get_reduced_config("llama3_2_1b").with_(num_layers=6)
    model = init_params(cfg, generator=torch.Generator().manual_seed(1), device=CPU)
    streamer = StreamedDecoder(model, window=2)
    made = []
    new_slot = streamer._new_slot
    monkeypatch.setattr(streamer, "_new_slot", lambda: made.append(1) or new_slot())
    cache = init_cache(cfg, 1, 4, device=CPU)
    for _ in range(3):
        _, cache = streamer.decode(cache, torch.zeros(1, dtype=torch.long))
    assert streamer.device_resident_bytes() < sum(streamer.layer_nbytes) / 2
    assert len(streamer._ring) <= 2 and len(made) == 2
    assert sorted(streamer._ring) == [0, 5]            # layer 0 prefetched for step 4
    # every layer once a step, and layer 0 once more ahead of the first step
    assert streamer.stats.uploaded_bytes == (3 * 6 + 1) * streamer.layer_nbytes[0]
    layer0 = dict(model.blocks[0].named_parameters())
    for name, p in streamer._ring[0].block.named_parameters():
        assert torch.equal(p, layer0[name])


def test_streamed_decode_raises_past_the_cache():
    cfg = TC.get_reduced_config("llama3_2_1b")
    model = init_params(cfg, generator=torch.Generator().manual_seed(1), device=CPU)
    streamer = StreamedDecoder(model, window=2)
    cache = init_cache(cfg, 1, 2, device=CPU)
    tok = torch.zeros(1, dtype=torch.long)
    for _ in range(2):
        _, cache = streamer.decode(cache, tok)
    uploaded = streamer.stats.uploaded_bytes
    with pytest.raises(CacheFullError, match="len 2: the cache holds 2"):
        streamer.decode(cache, tok)
    assert cache["len"] == 2 and streamer.stats.uploaded_bytes == uploaded


@pytest.mark.parametrize("offload", [False, True])
def test_launcher_decodes_on_the_cpu(offload, capsys):
    argv = ["--arch", "llama3_2_1b", "--reduced", "--device", "cpu"]
    assert launch_serve.main(argv + (["--offload"] if offload else [])) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("arch=llama3.2-1b batch=4 device=cpu")
    assert (f"modelled, {TM.H100.name}=" in line) == offload


def test_launcher_refuses_an_unported_family(capsys):
    """Streaming is ported for the dense and vlm families only, as in the
    reference: ``--offload`` on any other exits 2 and names them."""
    assert launch_serve.main(["--arch", "mamba2_1_3b", "--reduced", "--device", "cpu",
                              "--offload"]) == 2
    assert "--offload supports dense/vlm families, not ssm" in capsys.readouterr().err
