"""The port's backbone-weight converter
(``audio_edge_ml_pipeline_torch.tools.convert_backbone_weights``) against
the repository's JAX tool (``tools/convert_backbone_weights.py``), which
stays as it is, on the cases of tests/test_backbones.py.

Every source kind (a torchvision-layout ``state_dict``, an ordered
``.npz``, Keras MobileNetV2 and EfficientNet-B0 built with
``weights=None`` and seeded statistics) and ``--prefix backbone --bundle``
must give the JAX tool's arrays byte for byte, under the same keys in the
same order. The port's backbones, loaded from the port's files, then
compute what the sources compute: the Keras models' embeddings within
1e-3 of the largest (tests/test_backbones.py's gate), the JAX embedder on
the same file within 1e-5 (tests/test_torch_mobilenet.py's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import convert_backbone_weights as jtool   # tools/ is on the path (tests/conftest.py)
from audio_edge_ml_pipeline_tpu.models import backbones as jbackbones
from audio_edge_ml_pipeline_torch.models import backbones as tbackbones
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.tools import convert_backbone_weights as tool

SIZE = 32      # the embedder's side in the torch-source cases
KERAS = 96     # the Keras models' side, as tests/test_backbones.py builds them


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same_files(ours, theirs):
    a, b = np.load(ours), np.load(theirs)
    assert a.files == b.files
    for k in b.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.fixture(scope="module")
def torch_source(tmp_path_factory):
    """A torch.save'd torchvision-style state_dict of seeded values (OIHW
    kernels, one num_batches_tracked a BatchNorm, a classifier head)."""
    root = tmp_path_factory.mktemp("wsrc")
    template = tool.backbone_template("mobilenet_v2")
    rng = np.random.default_rng(1)
    state = {}
    for i, k in enumerate(tool.mbv2_flax_key_order()):
        arr = rng.normal(0, 0.05, template[k]).astype(np.float32)
        if k.endswith("/var"):
            arr = (0.5 + np.abs(arr)).astype(np.float32)
        if k.endswith("/kernel"):
            arr = np.transpose(arr, (3, 2, 0, 1))
        state[f"features.{i}.w"] = torch.from_numpy(arr)
        if k.endswith("/var"):
            state[f"features.{i}.num_batches_tracked"] = torch.tensor(0)
    state["classifier.1.weight"] = torch.zeros(1000, 1280)
    state["classifier.1.bias"] = torch.zeros(1000)
    src = root / "mbv2.pth"
    torch.save(state, src)
    return root, src, state


def test_template_is_the_flax_template():
    """The port's modules give the flax init's keys and shapes, for both
    backbones, with nothing of JAX."""
    for arch, module in (("mobilenet_v2", jbackbones.MobileNetV2()), ("efficientnet_b0", jbackbones.EfficientNetB0())):
        variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
        flax = {k: v.shape for k, v in jbackbones.flatten_variables(dict(variables)).items()}
        ours = tool.backbone_template(arch)
        assert sorted(ours) == sorted(flax), arch
        assert all(tuple(ours[k]) == tuple(flax[k]) for k in flax), arch
    assert sorted(tool.mbv2_flax_key_order()) == sorted(tool.backbone_template("mobilenet_v2"))
    assert tool.mbv2_flax_key_order() == jtool.mbv2_flax_key_order()
    assert tool.keras_mbv2_layer_map() == jtool.keras_mbv2_layer_map()


def test_torch_state_dict_cli_is_the_jax_tools_bytes(torch_source):
    root, src, state = torch_source
    ours, theirs = root / "port.npz", root / "jax.npz"
    tool.main(["--src", str(src), "--out", str(ours), "--input-size", str(SIZE)])
    jtool.main(["--src", str(src), "--out", str(theirs), "--input-size", str(SIZE)])
    _same_files(ours, theirs)
    data = np.load(ours)
    assert data.files == tool.mbv2_flax_key_order()
    np.testing.assert_array_equal(data["p/_ConvBN_0/Conv_0/kernel"],
                                  np.transpose(state["features.0.w"].numpy(), (2, 3, 1, 0)))


def test_ordered_npz_source_is_the_jax_tools_bytes(torch_source, tmp_path):
    _, _, state = torch_source
    kept = [v.numpy() for k, v in state.items() if "num_batches" not in k and not k.startswith("classifier")]
    src = tmp_path / "ordered.npz"
    np.savez(src, *kept)
    tool.main(["--src", str(src), "--out", str(tmp_path / "port.npz")])
    jtool.main(["--src", str(src), "--out", str(tmp_path / "jax.npz")])
    _same_files(tmp_path / "port.npz", tmp_path / "jax.npz")


def test_converted_file_loads_into_both_embedders(torch_source):
    """The port's embedder takes every tensor of the port's file and embeds
    as JAX's embedder does on the same file."""
    root, src, _ = torch_source
    out = root / "embed.npz"
    tool.main(["--src", str(src), "--out", str(out)])
    net = tbackbones.MobileNetV2()
    assert tbackbones.load_backbone_weights(net, out) == (len(tool.mbv2_flax_key_order()), 0)
    x = np.random.default_rng(3).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ours = tbackbones.mobilenet_v2_embedder(SIZE, weights=str(out), device="cpu")(torch.from_numpy(x)).numpy()
    base = tbackbones.mobilenet_v2_embedder(SIZE, weights=None, device="cpu")(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jbackbones.mobilenet_v2_embedder(input_size=SIZE, weights=str(out))(jnp.asarray(x)))
    assert ours.shape == theirs.shape == (2, 1280)
    assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()
    assert not np.allclose(ours, base)   # the weights took effect


def test_converter_rejects_wrong_tensor_count():
    with pytest.raises(ValueError, match="tensors"):
        tool.convert_mobilenet_v2([np.zeros((3, 3))], tool.backbone_template("mobilenet_v2"))
    with pytest.raises(ValueError, match="source shape"):
        keys = tool.mbv2_flax_key_order()
        tool.convert_mobilenet_v2([np.zeros((1, 1, 1, 1))] * len(keys), tool.backbone_template("mobilenet_v2"))


def test_efficientnet_needs_a_keras_source(torch_source, tmp_path):
    _, src, _ = torch_source
    with pytest.raises(SystemExit, match="Keras"):
        tool.main(["--src", str(src), "--out", str(tmp_path / "x.npz"), "--arch", "efficientnet_b0"])


def _keras_model(tf, kind: str, seed: int):
    """A keras.applications model at weights=None with its BatchNorm
    parameters and statistics seeded, as tests/test_backbones.py makes it."""
    make = tf.keras.applications.MobileNetV2 if kind == "mobilenet_v2" else tf.keras.applications.EfficientNetB0
    model = make(weights=None, include_top=False, input_shape=(KERAS, KERAS, 3), pooling="avg")
    rng = np.random.default_rng(seed)
    for layer in model.layers:
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            gamma, beta, mean, var = layer.get_weights()
            layer.set_weights([
                (0.9 + 0.2 * rng.random(gamma.shape)).astype(np.float32),
                (0.05 * rng.standard_normal(beta.shape)).astype(np.float32),
                (0.05 * rng.standard_normal(mean.shape)).astype(np.float32),
                (0.8 + 0.4 * rng.random(var.shape)).astype(np.float32),
            ])
    return model


@pytest.fixture(scope="module")
def keras_sources(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    root = tmp_path_factory.mktemp("keras")
    out = {}
    for kind, seed in (("mobilenet_v2", 7), ("efficientnet_b0", 11)):
        model = _keras_model(tf, kind, seed)
        x = np.random.default_rng(seed).uniform(0, 1, (2, KERAS, KERAS, 3)).astype(np.float32)
        x = 2 * x - 1 if kind == "mobilenet_v2" else 255 * x   # B0 embeds its own rescaling by 1/255
        src = root / f"{kind}.keras"
        model.save(src)
        out[kind] = (src, x, np.asarray(model(tf.constant(x), training=False)))
    return root, out


@pytest.mark.parametrize("kind", ["mobilenet_v2", "efficientnet_b0"])
def test_keras_source_is_the_jax_tools_bytes_and_embeds_as_keras(keras_sources, kind):
    root, sources = keras_sources
    src, x, expected = sources[kind]
    ours, theirs = root / f"{kind}_port.npz", root / f"{kind}_jax.npz"
    args = ["--src", str(src), "--arch", kind, "--input-size", str(KERAS)]
    tool.main([*args, "--out", str(ours)])
    jtool.main([*args, "--out", str(theirs)])
    _same_files(ours, theirs)
    net = tbackbones.MobileNetV2() if kind == "mobilenet_v2" else tbackbones.EfficientNetB0()
    n = len(np.load(ours).files)
    assert n == (260 if kind == "mobilenet_v2" else 309)
    assert tbackbones.load_backbone_weights(net, ours) == (n, 0)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x / (1.0 if kind == "mobilenet_v2" else 255.0)).permute(0, 3, 1, 2)).numpy()
    assert np.abs(got - expected).max() <= 1e-3 * np.abs(expected).max()


def test_prefixed_bundle_is_the_jax_tools_bytes_and_warm_starts_the_teacher(keras_sources, tmp_path):
    """--prefix backbone --bundle: the JAX tool's file, whose 211 backbone
    parameters and their statistics warm-start the port's teacher while its
    head keeps its init."""
    _, sources = keras_sources
    src = sources["efficientnet_b0"][0]
    args = ["--src", str(src), "--arch", "efficientnet_b0", "--input-size", str(KERAS), "--prefix", "backbone",
            "--bundle"]
    tool.main([*args, "--out", str(tmp_path / "port.npz")])
    jtool.main([*args, "--out", str(tmp_path / "jax.npz")])
    _same_files(tmp_path / "port.npz", tmp_path / "jax.npz")
    arch, _, mean, var = tdeep.load_model_bundle(tmp_path / "port.npz")
    assert arch == {"type": "efficientnet_b0_backbone", "source": src.name, "act": "silu"}
    assert mean.tolist() == [0.0] and var.tolist() == [1.0]

    teacher = tdeep.EfficientNetTeacherModule(5, 0.1, image_size=KERAS)
    tdeep.init_weights_(teacher, torch.Generator().manual_seed(0))
    flat = tdeep.params_to_flax(teacher.state_dict())
    new, n = tdeep.transfer_pretrained(flat, tmp_path / "port.npz")
    data = np.load(tmp_path / "port.npz")
    assert n == sum(k.startswith("p/") for k in data.files) == 211
    np.testing.assert_array_equal(new["p/backbone/_ConvBN_0/Conv_0/kernel"], data["p/backbone/_ConvBN_0/Conv_0/kernel"])
    np.testing.assert_array_equal(new["c/batch_stats/backbone/_ConvBN_0/BatchNorm_0/mean"],
                                  data["c/batch_stats/backbone/_ConvBN_0/BatchNorm_0/mean"])
    np.testing.assert_array_equal(new["p/head/kernel"], flat["p/head/kernel"])


def test_forward_equivalence_torch_oracle(tmp_path):
    """tests/test_backbones.py's oracle on the port: an independent torch
    MobileNetV2 in torchvision's tensor order (Keras padding: a (0, 1)
    pad before each stride-2 3x3 conv; BatchNorm epsilon 1e-3) with seeded
    weights and statistics, converted by the port's tool and loaded into
    the port's MobileNetV2, computes the same embedding (1e-3 of the
    largest, that test's gate; the JAX tool's file is the same bytes)."""
    tnn = torch.nn

    class ConvBN(tnn.Sequential):
        def __init__(self, cin, cout, k=3, stride=1, groups=1, act=True):
            pad = [tnn.ZeroPad2d((0, 1, 0, 1))] if stride == 2 and k == 3 else []
            super().__init__(*pad, tnn.Conv2d(cin, cout, k, stride, 0 if pad else k // 2, groups=groups, bias=False),
                             tnn.BatchNorm2d(cout, eps=1e-3))
            self.act = act

        def forward(self, x):
            x = super().forward(x)
            return torch.clamp(x, 0.0, 6.0) if self.act else x

    class InvRes(tnn.Module):
        def __init__(self, cin, cout, stride, expand):
            super().__init__()
            h = cin * expand
            mods = [ConvBN(cin, h, k=1)] if expand != 1 else []
            self.conv = tnn.Sequential(*mods, ConvBN(h, h, 3, stride, groups=h), ConvBN(h, cout, k=1, act=False))
            self.res = stride == 1 and cin == cout

        def forward(self, x):
            return x + self.conv(x) if self.res else self.conv(x)

    feats, cin = [ConvBN(3, 32, stride=2)], 32
    for t, c, n, s in tbackbones.MBV2_CONFIG:
        for i in range(n):
            feats.append(InvRes(cin, c, s if i == 0 else 1, t))
            cin = c
    oracle = tnn.Sequential(*feats, ConvBN(cin, 1280, k=1))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, t in oracle.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.8 + 0.4 * torch.rand(t.shape, generator=g))
            elif name.endswith(("running_mean", ".bias")):
                t.copy_(0.05 * torch.randn(t.shape, generator=g))
            elif t.ndim == 1 and t.is_floating_point():
                t.copy_(0.9 + 0.2 * torch.rand(t.shape, generator=g))
            elif t.ndim == 4:
                t.copy_(torch.randn(t.shape, generator=g) / (t.shape[1] * t.shape[2] * t.shape[3]) ** 0.5)
    oracle.eval()
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, 3, 96, 96)).astype(np.float32))
    with torch.no_grad():
        want = oracle(x).mean(dim=(2, 3)).numpy()
    torch.save(oracle.state_dict(), tmp_path / "oracle.pth")
    tool.main(["--src", str(tmp_path / "oracle.pth"), "--out", str(tmp_path / "port.npz"), "--input-size", "96"])
    jtool.main(["--src", str(tmp_path / "oracle.pth"), "--out", str(tmp_path / "jax.npz"), "--input-size", "96"])
    _same_files(tmp_path / "port.npz", tmp_path / "jax.npz")
    net = tbackbones.MobileNetV2().eval()
    assert tbackbones.load_backbone_weights(net, tmp_path / "port.npz") == (len(tool.mbv2_flax_key_order()), 0)
    with torch.no_grad():
        got = net(x).numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
