"""Port parity: the CNN and the .npz bundle format of
audio_edge_ml_pipeline_torch.models.deep against the JAX package's flax
CNNModule and bundle I/O (CPU, float32)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import layers as tlayers

TOL = 1e-5  # logits, float32 convolutions summed in different orders


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


ARCHS = {
    # the flagship's strides on the FeatureSet layout (40, 501, 1): flax SAME
    # pads the stride-2 layer asymmetrically (0 before, 1 after)
    "strided": dict(filters=(8, 16, 16), first_stride=4, second_stride=2),
    # pooling blocks instead of strides
    "pooled": dict(filters=(4, 8), first_stride=1, second_stride=1),
}


def _flax_cnn(arch, n_classes, input_shape, seed):
    module = jdeep.CNNModule(arch["filters"], dropout=0.3, n_classes=n_classes,
                             first_stride=arch["first_stride"], second_stride=arch["second_stride"])
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, *input_shape), jnp.float32), train=False)["params"]
    return module, params


def _torch_cnn(arch, n_classes, in_channels=1):
    return tdeep.CNNModule(arch["filters"], 0.3, n_classes, arch["first_stride"], arch["second_stride"],
                           in_channels=in_channels).eval()


@pytest.mark.parametrize("layout", [(40, 501, 1), (501, 40, 1), (40, 37, 1)], ids=["featureset", "entry", "short"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_logits_match_flax_with_carried_weights(rng, name, layout):
    arch = ARCHS[name]
    module, params = _flax_cnn(arch, 27, layout, seed=3)
    x = rng.random((2, *layout), dtype=np.float32)
    theirs = np.asarray(module.apply({"params": params}, jnp.asarray(x), train=False))
    net = _torch_cnn(arch, 27)
    net.load_state_dict(tdeep.params_from_flax(jdeep._flatten_params(params)))
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    assert ours.shape == theirs.shape == (2, 27)
    assert np.max(np.abs(ours - theirs)) <= TOL


def test_same_padding_is_flax_same():
    assert tlayers.same_padding(126, 2) == (0, 1)   # flagship layer 2 on the time axis
    assert tlayers.same_padding(40, 4) == (0, 0)    # layer 1 on the mel axis
    assert tlayers.same_padding(501, 4) == (1, 1)
    assert tlayers.same_padding(20, 1) == (1, 1)


def test_flax_params_round_trip_exactly():
    _, params = _flax_cnn(ARCHS["strided"], 5, (40, 101, 1), seed=0)
    flat = jdeep._flatten_params(params)
    back = tdeep.params_to_flax(tdeep.params_from_flax(flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def _jax_bundle(tmp_path, rng, input_shape=(40, 101, 1), n_classes=5):
    arch = {"type": "cnn", "filters": [8, 16, 16], "dropout": 0.3, "n_classes": n_classes,
            "first_stride": 4, "second_stride": 2, "input_shape": list(input_shape)}
    _, params = _flax_cnn(ARCHS["strided"], n_classes, input_shape, seed=1)
    path = tmp_path / "jax_model.flax.npz"
    jdeep.save_model_bundle(path, arch, params, np.float32([0.4]), np.float32([0.09]))
    return path


def test_jax_bundle_gives_same_predict_proba(tmp_path, rng):
    path = _jax_bundle(tmp_path, rng)
    X = rng.random((5, 40, 101), dtype=np.float32)  # FeatureSet rows; the trainer adds the channel
    theirs = jdeep.load_any_model(path).predict_proba(X)
    ours_trainer = tdeep.load_any_model(path, device="cpu")
    assert isinstance(ours_trainer, tdeep.CNNTrainer)
    ours = ours_trainer.predict_proba(X)
    assert np.max(np.abs(ours - theirs)) <= 1e-6  # probabilities of logits within 1e-5
    np.testing.assert_array_equal(ours_trainer.predict(X), np.argmax(theirs, -1))


def test_port_bundle_loads_in_jax_with_identical_layout(tmp_path, rng):
    jax_path = _jax_bundle(tmp_path, rng)
    port = tdeep.load_any_model(jax_path, device="cpu")
    port_path = tmp_path / "port_model.flax.npz"
    port.save(port_path)
    arch_j, flat_j, mean_j, var_j = jdeep.load_model_bundle(jax_path)
    arch_p, flat_p, mean_p, var_p = jdeep.load_model_bundle(port_path)
    assert arch_p == arch_j
    assert sorted(flat_p) == sorted(flat_j)
    for k in flat_j:
        assert flat_p[k].shape == flat_j[k].shape and flat_p[k].dtype == flat_j[k].dtype
        np.testing.assert_array_equal(flat_p[k], flat_j[k])
    np.testing.assert_array_equal(mean_p, mean_j)
    np.testing.assert_array_equal(var_p, var_j)
    X = rng.random((3, 40, 101), dtype=np.float32)
    np.testing.assert_allclose(jdeep.load_any_model(port_path).predict_proba(X), port.predict_proba(X), atol=1e-6)


def test_initialize_is_seeded_and_saves_flax_layout(tmp_path):
    def make(seed):
        tr = tdeep.CNNTrainer(filters=[16, 64, 64], first_stride=4, second_stride=2, device="cpu")
        tr.initialize((40, 501, 1), 27, torch.Generator().manual_seed(seed))
        return tr

    a, b, c = make(0), make(0), make(1)
    for k, v in a._net.state_dict().items():
        assert torch.equal(v, b._net.state_dict()[k])
    assert not torch.equal(a._net.convs[0].weight, c._net.convs[0].weight)
    w = a._net.convs[2].weight.detach()
    assert abs(float(w.std()) - (1.0 / (64 * 9)) ** 0.5) < 0.1 * (1.0 / (64 * 9)) ** 0.5  # lecun normal
    path = tmp_path / "m.npz"
    a.save(path)
    arch, flat, mean, var = jdeep.load_model_bundle(path)
    assert arch["input_shape"] == [40, 501, 1] and arch["filters"] == [16, 64, 64]
    assert flat["p/Conv_0/kernel"].shape == (3, 3, 1, 16)
    assert flat["p/Dense_1/kernel"].shape == (128, 27)
    assert json.loads(json.dumps(arch)) == arch


def test_unported_trainer_names_raise(tmp_path, monkeypatch):
    """Every deep family of the JAX package loads in the port now, and
    data parallelism is ported: on a card it raises only when fewer cards
    than ``data_parallel`` are visible (no CPU fallback)."""
    path = tmp_path / "transformer.npz"
    tr = tdeep.TransformerTrainer(num_heads=2, ff_dim=8, n_blocks=1, device="cpu")
    tr.initialize((5, 6), 3, torch.Generator().manual_seed(0))
    tr.save(path)
    assert isinstance(tdeep.load_any_model(path, device="cpu"), tdeep.TransformerTrainer)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 CUDA cards but 1 are visible"):
        tdeep.CNNTrainer(device="cuda:0", data_parallel=2).fit(None, None, None, None, [], "r", tmp_path, None)
