"""Port parity: the ``efficientnet_teacher`` of audio_edge_ml_pipeline_torch
(``square_resize``, ``backbones.EfficientNetB0``, ``EfficientNetTeacherModule``,
the two-phase ``EfficientNetTeacherTrainer``, the revision gate and the
name-and-shape weight loader) against the JAX package's flax teacher,
``jax.image.resize`` and ``backbones.flatten_variables`` /
``load_backbone_weights``, on the CPU at image_size 32 (as JAX
tests/test_models.py). The flax teacher is built once for the module: its
variables come from the port's init through ``params_to_flax`` (a flax
``init`` of B0 costs about 20 s to compile here), with every BatchNorm moved
off its init so that the running statistics matter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import backbones as jbackbones
from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_torch.models import backbones as tbackbones
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.models.layers import BatchNorm

N_CLASSES = 5
SHAPE = (40, 101, 1)
ARCH = {"type": "efficientnet_teacher", "dropout": 0.0, "n_classes": N_CLASSES, "image_size": 32,
        "input_shape": list(SHAPE), "act": "silu"}
TEACHER_REL = 1e-4   # embedding and logits, over the logits' largest
RESIZE_REL = 1e-5    # the resize alone, on unit-normal inputs, over the image's largest |value|: both resize
#                      in float32 (at 501^2 -> 224 the gap is 1.04e-5 absolute on values up to 4.5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _seeded_net(seed: int) -> torch.nn.Module:
    """The port's teacher from flax's initializers, its BatchNorms moved off
    (scale 1, bias 0, mean 0, var 1)."""
    net = tdeep._MODULE_FACTORY["efficientnet_teacher"](ARCH)
    tdeep.init_weights_(net, torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                n = mod.weight.shape[0]
                for t, v in ((mod.weight, r.uniform(0.8, 1.2, n)), (mod.bias, r.normal(0, 0.1, n)),
                             (mod.mean, r.normal(0, 0.1, n)), (mod.var, r.uniform(0.5, 1.5, n))):
                    t.copy_(torch.from_numpy(v))
        net.head.bias.copy_(torch.from_numpy(r.normal(0, 0.1, N_CLASSES)))
    return net.eval()


def _flax_from_flat(module, flat, input_shape):
    """A flax variables dict of ``module`` holding ``flat`` (the template by
    ``jax.eval_shape``: no compile)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, *input_shape)), train=False))
    params = jdeep._unflatten_params(shapes["params"], flat)
    cols = jdeep._unflatten_collections({"batch_stats": shapes["batch_stats"]}, flat)
    return {"params": params, **cols}


@pytest.fixture(scope="module")
def teacher():
    """(port module, flax module, flax variables, jitted flax forward that
    also returns the backbone's embedding)."""
    net = _seeded_net(0)
    module = jdeep._MODULE_FACTORY["efficientnet_teacher"](ARCH)
    variables = _flax_from_flat(module, tdeep.params_to_flax(net.state_dict()), SHAPE)

    @jax.jit
    def forward(v, x):
        logits, state = module.apply(v, x, train=False, capture_intermediates=lambda mdl, _: mdl.name == "backbone")
        return logits, state["intermediates"]["backbone"]["__call__"][0]

    return net, module, variables, forward


def test_tree_has_the_flax_keys(teacher):
    """311 tensors (4.06 M values), every key the flax teacher has, the
    nested paths and the BatchNorm statistics included."""
    net, _, variables, _ = teacher
    flat = tdeep.params_to_flax(net.state_dict())
    theirs = jdeep._flatten_params(variables["params"])
    theirs.update(jdeep._flatten_collections({"batch_stats": variables["batch_stats"]}))
    assert sorted(flat) == sorted(theirs) and len(flat) == 311
    assert sum(v.size for v in flat.values()) == 4_055_969
    assert "p/backbone/_MBConvSE_3/_ConvBN_1/Conv_0/kernel" in flat and "p/head/kernel" in flat
    assert flat["p/backbone/_MBConvSE_0/Conv_0/kernel"].shape == (1, 1, 32, 8)     # SE: in_ch // 4 of the input
    assert flat["p/backbone/_MBConvSE_1/Conv_0/kernel"].shape == (1, 1, 96, 4)     # 16 // 4, biased
    assert "p/backbone/_MBConvSE_1/Conv_0/bias" in flat
    back = tdeep.params_from_flax(flat)
    assert sorted(back) == sorted(net.state_dict())


def test_embedding_and_logits_match_flax(teacher):
    net, _, variables, forward = teacher
    x = np.random.default_rng(1).normal(size=(3, *SHAPE)).astype(np.float32)
    logits, emb = (np.asarray(a) for a in forward(variables, jnp.asarray(x)))
    with torch.no_grad():
        ours_emb = net.embed(torch.from_numpy(x)).numpy()
        ours = net(torch.from_numpy(x)).numpy()
    scale = float(np.abs(logits).max())
    assert ours.shape == logits.shape == (3, N_CLASSES) and emb.shape == ours_emb.shape == (3, 1280)
    assert scale > 0.1   # the moved BatchNorms keep the signal alive through the 16 blocks
    assert np.abs(ours - logits).max() <= TEACHER_REL * scale
    assert np.abs(ours_emb - emb).max() <= TEACHER_REL * scale


@pytest.mark.parametrize("hw,size", [((501, 501), 224), ((501, 501), 32), ((40, 101), 224), ((40, 501), 32)],
                         ids=["501sq-224", "501sq-32", "upsample-101-224", "40x501-32"])
def test_resize_matches_jax_image_resize(hw, size):
    """``jax.image.resize`` antialiases when it shrinks; the port asks
    ``F.interpolate`` for antialias exactly then."""
    x = np.random.default_rng(2).normal(size=(2, *hw, 1)).astype(np.float32)
    side = max(hw)
    padded = jnp.pad(jnp.repeat(jnp.asarray(x), 3, axis=-1), ((0, 0), (0, side - hw[0]), (0, side - hw[1]), (0, 0)))
    theirs = np.asarray(jax.image.resize(padded, (2, size, size, 3), method="bilinear")).transpose(0, 3, 1, 2)
    ours = tdeep.square_resize(torch.from_numpy(x), size).numpy()
    assert ours.shape == theirs.shape == (2, 3, size, size)
    assert np.abs(ours - theirs).max() <= RESIZE_REL * np.abs(theirs).max()


def _fit(tmp_path, name, epochs, warmup, **kw):
    r = np.random.default_rng(3)
    y = np.repeat(np.arange(N_CLASSES), 4).astype(np.int32)
    X = r.normal(size=(len(y), 40, 24)).astype(np.float32)
    for c in range(N_CLASSES):
        X[y == c, c * 8 : c * 8 + 8] += 1.0
    steps: list[int] = []
    tt = get_model("efficientnet_teacher")(epochs=epochs, warmup_epochs=warmup, image_size=32, batch_size=8,
                                           dropout=0.0, learning_rate=1e-2, seed=1, device="cpu", **kw)
    tt.fit(X[:15], y[:15], X[15:], y[15:], [f"c{i}" for i in range(N_CLASSES)], name, tmp_path / name, None,
           epoch_callback=lambda e, logs: steps.append(e) and False)
    return tt, tmp_path / name / tdeep.MODEL_FILENAME, steps, X


@pytest.fixture(scope="module")
def init_bundle(tmp_path_factory):
    """A seeded teacher bundle for (40, 24) inputs: the warm start of the
    phase tests."""
    path = tmp_path_factory.mktemp("teacher") / "init.npz"
    net = _seeded_net(4)
    tdeep.save_model_bundle_flat(path, {**ARCH, "input_shape": [40, 24, 1]}, tdeep.params_to_flax(net.state_dict()),
                                 np.zeros(1, np.float32), np.ones(1, np.float32))
    return path


def test_phase1_moves_the_head_alone(tmp_path, init_bundle):
    _, bundle, steps, _ = _fit(tmp_path, "p1", epochs=2, warmup=2, pretrained_model=str(init_bundle))
    assert steps == [0, 1]
    _, before, _, _ = tdeep.load_model_bundle(init_bundle)
    _, after, _, _ = tdeep.load_model_bundle(bundle)
    assert sorted(before) == sorted(after)
    for k in before:
        if k.startswith("p/head/"):
            assert not np.array_equal(before[k], after[k]), k
        else:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_phase2_trains_the_backbone_but_not_its_statistics(tmp_path, init_bundle):
    """Phase 2 continues the metric steps after phase 1's, trains every
    parameter at lr x 0.1 and leaves every batch_stats leaf as it was: the
    backbone runs with train=False in both phases."""
    tt, bundle, steps, X = _fit(tmp_path, "p2", epochs=3, warmup=1, pretrained_model=str(init_bundle))
    assert steps == [0, 1, 2]
    assert (tt.epochs, tt.learning_rate) == (3, 1e-2)      # restored after the phases
    _, before, _, _ = tdeep.load_model_bundle(init_bundle)
    _, after, _, _ = tdeep.load_model_bundle(bundle)
    stats = [k for k in before if k.startswith("c/batch_stats/")]
    assert len(stats) == 98
    for k in stats:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    moved = [k for k in before if k.startswith("p/backbone/") and not np.array_equal(before[k], after[k])]
    assert len(moved) > 150
    jm = jdeep.load_any_model(bundle)                       # JAX reads the port-trained teacher
    np.testing.assert_array_equal(jm.predict(X[15:]), tt.predict(X[15:]))
    ours = tt._batched_logits(tt._prepare_input(X[15:]))
    theirs = np.asarray(jm._batched_logits(jm._prepare_input(X[15:])))
    assert np.abs(ours - theirs).max() <= TEACHER_REL * np.abs(theirs).max()


def test_jax_teacher_bundle_serves_in_the_port(tmp_path, teacher):
    net, _, variables, forward = teacher
    path = tmp_path / "jax_teacher.npz"
    jdeep.save_model_bundle(path, ARCH, variables["params"], np.zeros(1, np.float32), np.ones(1, np.float32),
                            collections={"batch_stats": variables["batch_stats"]})
    tm = tdeep.load_any_model(path, device="cpu")
    assert isinstance(tm, tdeep.EfficientNetTeacherTrainer)
    x = np.random.default_rng(5).normal(size=(2, 40, 101)).astype(np.float32)
    logits, _ = forward(variables, jnp.asarray(x[..., None]))
    ours = tm._batched_logits(tm._prepare_input(x))
    assert np.abs(ours - np.asarray(logits)).max() <= TEACHER_REL * np.abs(np.asarray(logits)).max()


def test_revision_gate_refuses_a_legacy_bundle(tmp_path, teacher):
    net = teacher[0]
    flat = tdeep.params_to_flax(net.state_dict())
    legacy = tmp_path / "legacy.npz"
    arch = {k: v for k, v in ARCH.items() if k != "act"}      # bundles before the silu rework have no marker
    tdeep.save_model_bundle_flat(legacy, arch, flat, np.zeros(1), np.ones(1))
    with pytest.raises(ValueError, match="relu6-legacy"):
        tdeep.load_any_model(legacy, device="cpu")
    with pytest.raises(ValueError, match="relu6-legacy"):
        tdeep.transfer_pretrained(flat, legacy)
    tdeep.save_model_bundle_flat(legacy, {**arch, "act": "relu6"}, flat, np.zeros(1), np.ones(1))
    with pytest.raises(ValueError, match="'relu6'"):
        tdeep.EfficientNetTeacherTrainer.load(legacy, device="cpu")


def test_flatten_variables_bundle_loads_by_name_and_shape(tmp_path):
    """A JAX ``flatten_variables`` file of a seeded B0 fills the port's
    backbone with every tensor matched, bit for bit, and the JAX loader
    reads the port's tensors back (a teacher takes a converted checkpoint
    through ``pretrained_model``: the next test)."""
    b0 = jbackbones.EfficientNetB0()
    shapes = jax.eval_shape(lambda: b0.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    r = np.random.default_rng(6)
    variables = jax.tree_util.tree_map(lambda s: jnp.asarray(r.normal(0, 0.1, s.shape), jnp.float32), dict(shapes))
    flat = jbackbones.flatten_variables(variables)
    path = tmp_path / "b0.npz"
    np.savez(path, **flat)

    ours = tbackbones.EfficientNetB0()
    assert tbackbones.load_backbone_weights(ours, path) == (len(flat), 0)
    back = tdeep.params_to_flax(ours.state_dict())
    assert sorted(back) == sorted(flat) and len(flat) == 309
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)

    net = tdeep._MODULE_FACTORY["efficientnet_teacher"](ARCH)     # keys under p/backbone/: no match
    with pytest.raises(ValueError, match="no tensors matched"):
        tbackbones.load_backbone_weights(net, path)

    np.savez(tmp_path / "port.npz", **back)
    _, n_loaded, n_skipped = jbackbones.load_backbone_weights(dict(variables), tmp_path / "port.npz")
    assert (n_loaded, n_skipped) == (309, 0)


def test_converted_checkpoint_warm_starts_the_teacher(tmp_path):
    """A ``--prefix backbone --bundle`` checkpoint: every backbone tensor
    transfers by name and shape, the head keeps its init."""
    net = _seeded_net(7)
    flat = {k: v for k, v in tdeep.params_to_flax(net.state_dict()).items() if "/backbone/" in k}
    ckpt = tmp_path / "converted_bundle.npz"
    tdeep.save_model_bundle_flat(ckpt, {"type": "efficientnet_b0_backbone", "source": "x", "act": "silu"}, flat,
                                 np.zeros(1, np.float32), np.ones(1, np.float32))
    tt = get_model("efficientnet_teacher")(image_size=32, pretrained_model=str(ckpt), device="cpu")
    X = np.random.default_rng(8).normal(size=(4, 40, 24, 1)).astype(np.float32)
    tt.prepare_fit(X, N_CLASSES)
    got = tdeep.params_to_flax(tt._net.state_dict())
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert not np.array_equal(got["p/head/kernel"], tdeep.params_to_flax(net.state_dict())["p/head/kernel"])


def test_teacher_defaults_equal_jax():
    ours = tdeep.EfficientNetTeacherTrainer(device="cpu", target_h=96, unfreeze_layers=20)
    theirs = jdeep.EfficientNetTeacherTrainer(target_h=96, unfreeze_layers=20)
    assert ours._architecture_params() == theirs._architecture_params()
    assert ours._arch((40, 501, 1), 10) == theirs._arch((40, 501, 1), 10)
    assert ours._prepare_input(np.zeros((2, 40, 50))).shape == (2, 40, 50, 1)
