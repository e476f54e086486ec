"""Port parity: MobileNetV2 and its frozen embedder (``models/backbones.py``)
against JAX's flax MobileNetV2 on the CPU. JAX's variables go through
``flatten_variables`` -> ``.npz`` -> the port's ``load_backbone_weights``;
the embeddings then agree within 1e-5 of their largest."""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu.models import backbones as jbackbones
from audio_edge_ml_pipeline_torch.models import backbones as tbackbones
from audio_edge_ml_pipeline_torch.models.deep import params_to_flax

SIZE = 48  # the input side: 224 is slow on the CPU


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """JAX's MobileNetV2 variables (every BatchNorm's scale, bias and
    statistics moved off their init), written by flatten_variables."""
    model = jbackbones.MobileNetV2()
    variables = model.init(jax.random.PRNGKey(5), jnp.zeros((1, SIZE, SIZE, 3)))
    flat = jbackbones.flatten_variables(variables)
    rng = np.random.default_rng(2)
    for k in flat:
        if k.endswith(("/mean", "/bias")):
            flat[k] = rng.normal(0.0, 0.1, flat[k].shape).astype(np.float32)
        elif k.endswith(("/var", "/scale")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    path = tmp_path_factory.mktemp("mbv2") / "mbv2.npz"
    np.savez(path, **flat)
    variables, n_loaded, n_skipped = jbackbones.load_backbone_weights(dict(variables), path)
    assert (n_loaded, n_skipped) == (len(flat), 0)
    return model, variables, flat, path


def test_module_tree_is_the_flax_tree(jax_model):
    """Every flax key has its tensor in the port's module, of the same shape."""
    _, _, flat, _ = jax_model
    ours = params_to_flax(tbackbones.MobileNetV2().state_dict())
    assert sorted(ours) == sorted(flat)
    assert all(ours[k].shape == flat[k].shape for k in flat)
    assert "p/_InvertedResidual_16/_ConvBN_2/Conv_0/kernel" in ours


@pytest.mark.parametrize("batch,seed", [(1, 0), (3, 1)])
def test_embeddings_match_flax_with_jax_weights(jax_model, batch, seed):
    model, variables, flat, path = jax_model
    net = tbackbones.MobileNetV2()
    assert tbackbones.load_backbone_weights(net, path) == (len(flat), 0)
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (batch, SIZE, SIZE, 3)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    embed = tbackbones.mobilenet_v2_embedder(SIZE, str(path), device="cpu")
    with torch.inference_mode():
        out = embed(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (batch, 1280)
    assert float(np.max(np.abs(out - ref))) <= 1e-5 * float(np.max(np.abs(ref)))


def test_embedder_is_cached_per_key(jax_model):
    _, _, _, path = jax_model
    a = tbackbones.mobilenet_v2_embedder(SIZE, str(path), device="cpu")
    assert tbackbones.mobilenet_v2_embedder(SIZE, str(path), device="cpu") is a
    assert tbackbones.mobilenet_v2_embedder(SIZE + 16, str(path), device="cpu") is not a


@pytest.mark.parametrize("weights", [None, "no/such/file.npz"])
def test_random_init_warns(caplog, weights):
    """Without a weights file the embedder keeps its seeded random init and
    logs JAX's RANDOM-INIT warning; the same seed gives the same network."""
    tbackbones._EMBED_CACHE.clear()
    with caplog.at_level(logging.WARNING, logger="audio_edge_ml_pipeline_torch.models.backbones"):
        embed = tbackbones.mobilenet_v2_embedder(32, weights, device="cpu")
    assert any("RANDOM-INIT" in r.getMessage() for r in caplog.records)
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    tbackbones._EMBED_CACHE.clear()
    again = tbackbones.mobilenet_v2_embedder(32, weights, device="cpu")
    with torch.inference_mode():
        a, b = embed(x), again(x)
    assert a.shape == (2, 1280) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b)


@pytest.mark.parametrize("width", [0.35, 0.5, 0.75, 1.0, 1.3, 1.4])
def test_make_divisible_matches_jax(width):
    for c in (16, 24, 32, 64, 96, 160, 320, 1280):
        assert tbackbones._make_divisible(c * width) == jbackbones._make_divisible(c * width)


def test_embedder_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbackbones.mobilenet_v2_embedder(32)
