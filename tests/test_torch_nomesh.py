"""The port's single-device paths are the same computation with the mesh
paths in the package: ``forward``, ``decode_step`` and ``make_train_step``
(two microbatches, AdamW) with no mesh give, bit for bit, what they gave
before the mesh paths were written.

``DIGESTS`` holds the SHA-1 (first 16 hex digits) of each reduced arch's
outputs, taken from the package as it stood before the mesh paths, on the
CPU with one thread: the forward logits (vision patches and encoder
inputs where the family takes them), three decode steps' logits (encdec's
``enc_k``/``enc_v`` seeded), and one training step's loss, gradient norm
and updated parameters.  ``digests`` computes them; the test runs it with
one thread, as they were taken.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402

B, S, ENC, MAX_LEN = 4, 16, 8, 8

DIGESTS = {
    "llama3_2_1b": {"forward": "b46271b0f1bf5ee6", "decode": "4c56c6742cd939d5",
                   "train": "cbc694660d20ca0b"},
    "granite_34b": {"forward": "7d8244dbe56d6a9f", "decode": "0730a798383373a3",
                   "train": "f69570a3a34deb7e"},
    "tinyllama_1_1b": {"forward": "a3812937d0419500", "decode": "f4cf3bca19b8b3ef",
                      "train": "7d065a14475829b2"},
    "qwen2_5_14b": {"forward": "6f5edf3000cb49bb", "decode": "bed086c8c86ac841",
                   "train": "e52a9ff5798aa57b"},
    "qwen3_moe_30b_a3b": {"forward": "e2fe804aac516518", "decode": "eb64cf2bc77a3346",
                         "train": "d2893f1238027e86"},
    "deepseek_v2_lite_16b": {"forward": "af08721fcf5edb15", "decode": "118d9eeb58f3ea48",
                            "train": "3cff80adf671c64b"},
    "zamba2_1_2b": {"forward": "32b1bfd029a554d4", "decode": "2bd06be9173b0820",
                   "train": "59573f62f40a7603"},
    "whisper_medium": {"forward": "b430dae9a5017c26", "decode": "5525d5ba6b3b1d41",
                      "train": "c5d228f2a203715f"},
    "internvl2_76b": {"forward": "875b8add8c6c2cd0", "decode": "054af9a09a0d2df1",
                     "train": "ab8476989757220e"},
    "mamba2_1_3b": {"forward": "79a8fd6a6e548525", "decode": "d0a0c4e22dec7408",
                   "train": "4368d03ebb5f3331"},
}


def _sha(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(arch: str) -> dict:
    """The three digests of ``arch``'s reduced config, seeded weights and
    inputs."""
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    cfg = TC.get_reduced_config(arch)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    tokens, labels = chunk[:, :-1], chunk[:, 1:]
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.from_numpy(
            rng.standard_normal((B, cfg.vision_patches, cfg.d_model)).astype(np.float32))
    if cfg.encdec:
        extra["enc_inputs"] = torch.from_numpy(
            rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32))
    out = {}
    with torch.no_grad():
        out["forward"] = _sha(forward(model, tokens, **extra))
    cache = init_cache(cfg, B, MAX_LEN, enc_len=ENC if cfg.encdec else 0, device="cpu")
    if cfg.encdec:
        for key in ("enc_k", "enc_v"):
            cache[key].copy_(torch.from_numpy(
                rng.standard_normal(tuple(cache[key].shape)).astype(np.float32)))
    logits = []
    with torch.inference_mode():
        for t in range(3):
            step_logits, cache = decode_step(model, cache, tokens[:, t])
            logits.append(step_logits)
    out["decode"] = _sha(*logits)
    step = make_train_step(cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1), microbatches=2)
    state = adamw_init(dict(model.named_parameters()))
    _, _, metrics = step(model, state, {"tokens": tokens, "labels": labels, **extra})
    out["train"] = _sha(metrics["loss"], metrics["grad_norm"], *model.parameters())
    return out


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_no_mesh_paths_are_bit_identical_to_before(arch, one_thread):
    assert digests(arch) == DIGESTS[arch]


if __name__ == "__main__":
    # print the digests of the package on PYTHONPATH, one thread
    import json
    torch.set_num_threads(1)
    print(json.dumps({a: digests(a) for a in TC.ARCH_IDS}, indent=1))
