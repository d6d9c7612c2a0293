"""``models/graph.py::DecodeGraph`` replayed on a card, for every family at
the reduced configs: every step's logits and the final cache ``torch.equal``
to the eager ``decode_step`` from the same start, ``CacheFullError`` past the
cache's last slot with the cache unchanged, and a cache whose tensors were
replaced refused.  It needs a card and skips without one; it imports no JAX,
so it runs where the card is::

    python -m pytest -q -m cuda tests/test_torch_decode_graph_cuda.py

``chip_smoke.py --model``, ``--moe`` and ``--ssm`` run the same replay at
the published widths.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.models import (  # noqa: E402
    CacheFullError,
    DecodeGraph,
    decode_step,
    init_cache,
    init_params,
)

ARCHS = ["llama3_2_1b", "internvl2_76b", "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b",
         "mamba2_1_3b", "zamba2_1_2b", "whisper_medium"]
B, STEPS, MAX_LEN = 3, 7, 8


def _cache(cfg):
    cache = init_cache(cfg, B, MAX_LEN, enc_len=5, device="cuda")
    if cfg.encdec:
        cache["enc_k"].normal_(generator=torch.Generator("cuda").manual_seed(1))
        cache["enc_v"].normal_(generator=torch.Generator("cuda").manual_seed(2))
    return cache


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_replay_equals_the_eager_step(arch, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = TC.get_reduced_config(arch).with_(dtype=dtype)
    with torch.inference_mode():
        model = init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                            device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (B, STEPS),
                               generator=torch.Generator("cuda").manual_seed(3), device="cuda")
        eager, graphed = _cache(cfg), _cache(cfg)
        graph = DecodeGraph(model, graphed)
        for t in range(STEPS):
            want, eager = decode_step(model, eager, tokens[:, t])
            got, graphed = graph(graphed, tokens[:, t])
            assert torch.equal(got, want), (arch, dtype, t)
        assert graph.replays == STEPS - graph.WARMUP_STEPS and graph.capture_s > 0
        assert graph.pool_bytes >= 0
        assert all(torch.equal(eager[k], graphed[k]) for k in eager if k != "len")
        assert graphed["len"] == eager["len"] == STEPS
        got, graphed = graph(graphed, tokens[:, 0])            # the last slot
        if cfg.family != "ssm":             # a pure ssm cache has no length
            kept = {k: v.clone() for k, v in graphed.items() if k != "len"}
            with pytest.raises(CacheFullError):
                graph(graphed, tokens[:, 1])
            assert graphed["len"] == MAX_LEN
            assert all(torch.equal(kept[k], graphed[k]) for k in kept)
        other = dict(graphed)
        with pytest.raises(ValueError, match="cache tensors it was made with"):
            graph(other, tokens[:, 1])
        key = next(k for k in graphed if k != "len")
        graphed[key] = graphed[key].clone()
        with pytest.raises(ValueError, match="cache tensors it was made with"):
            graph(graphed, tokens[:, 1])
