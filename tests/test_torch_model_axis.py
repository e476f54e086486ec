"""The model axis of the port's collective layer (parallel/mesh.py) for
every deep family that JAX places: ``place_train_state`` on
``get_mesh(2, model_parallel=2)`` over two gloo ranks, then one
``make_sharded_train_step`` step, against the same step in one process.

JAX's GSPMD step is one function however it is sharded, so the sharded
step must compute the one-process step. Both run in float64, so they part
only by the order of their sums. Tolerances: the loss 1e-5 relative, every
tensor of the state after the step 1e-4 of that tensor's largest
(test_torch_parallel.py's gates for a data-parallel fit). A split layer
against the whole layer: 1e-12 of the largest, in float64.
"""

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_torch import entry
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models.layers import Projection
from audio_edge_ml_pipeline_torch.parallel import mesh as pm

CPU = "cpu"
LOSS_TOL, STATE_TOL = 1e-5, 1e-4

# DSCNNModule((8, 8), 0.0, 3), BiLSTMModule(8, 1, 0.0, 3, 6), TransformerModule(2, 16, 1, 0.0, 3, 8) and the
# teacher (EfficientNet-B0, its depthwise convolutions at 32 x 32), each with its input (rows, *shape)
FAMILIES = {
    "ds_cnn": ({"type": "ds_cnn", "filters": [8, 8], "dropout": 0.0, "n_classes": 3, "input_shape": [12, 16, 1]},
               (12, 16, 1)),
    "rnn": ({"type": "rnn", "units": 8, "n_layers": 1, "dropout": 0.0, "n_classes": 3, "input_shape": [10, 6]},
            (10, 6)),
    "transformer": ({"type": "transformer", "num_heads": 2, "ff_dim": 16, "n_blocks": 1, "dropout": 0.0,
                     "n_classes": 3, "input_shape": [10, 8]}, (10, 8)),
    "efficientnet_teacher": ({"type": "efficientnet_teacher", "n_classes": 4, "dropout": 0.0, "image_size": 32,
                              "act": "silu", "input_shape": [20, 24, 1]}, (20, 24, 1)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _seeded_state(arch: dict, seed: int) -> dict[str, np.ndarray]:
    """flax's init from ``seed``, every tensor then moved off it (biases off
    zero, BatchNorm statistics off 0 and 1), in float64; an LSTM's input-side
    bias stays zero, as the flax layout has none."""
    net = tdeep._MODULE_FACTORY[arch["type"]](arch)
    tdeep.init_weights_(net, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    state = {}
    for k, v in net.state_dict().items():
        v = v.to(torch.float64)
        if "bias_ih" not in k:
            noise = torch.rand(v.shape, generator=g, dtype=torch.float64)
            v = 0.5 + noise if k.endswith(".var") else v + 0.05 * (noise - 0.5)
        state[k] = v.numpy()
    return state


def _one_process_step(arch, state, X, y, lr=0.1):
    net = tdeep._MODULE_FACTORY[arch["type"]](arch).to(torch.float64)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    net.train()
    opt = torch.optim.SGD(net.parameters(), lr=lr)
    loss = torch.nn.functional.cross_entropy(net(torch.from_numpy(X)), torch.from_numpy(y.astype(np.int64)))
    loss.backward()
    opt.step()
    return float(loss.detach()), {k: v.detach().numpy() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("family,ranks", [*((f, 2) for f in sorted(FAMILIES)), ("ds_cnn", 4)])
def test_model_axis_step_matches_one_process(family, ranks):
    """Fault n: every family is placed on (data 1 x model 2) without raising,
    and its step is the one-process step; on (data 2 x model 2) too for the
    ds_cnn, whose BatchNorm moments are then the global batch's."""
    arch, shape = FAMILIES[family]
    state = _seeded_state(arch, 4)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((8, *shape))
    y = (np.arange(8) % arch["n_classes"]).astype(np.int32)
    loss, _, new, dims = pm.run_ranks(entry.sharded_step, (arch, state, X, y, 2, 1, "sgd", 0.1, False, "float64"),
                                      [CPU] * ranks, timeout=300)
    assert dims == {"data": ranks // 2, "model": 2}
    ref_loss, ref = _one_process_step(arch, state, X, y)
    assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss)
    assert sorted(new) == sorted(ref)
    for k, v in ref.items():
        assert new[k].dtype == np.float64, k
        assert _rel(new[k], v) <= STATE_TOL, k
    moved = [k for k in ref if "bias_ih" not in k and not k.endswith((".mean", ".var")) and _rel(ref[k], state[k]) > 0]
    assert len(moved) >= len([k for k in ref if "weight" in k or "kernel" in k]) // 2   # the step trained


def test_model_axis_places_what_column_splits_cuts():
    """Which layers a (model 2) placement splits: the transformer's
    projections and dense layers, the ds_cnn's depthwise and pointwise
    convolutions; the LSTM stays whole although param_shardings names its
    gate kernels sharded, as JAX's rule does for flax's (in, units) kernels."""
    from types import SimpleNamespace

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda i: (1, 2)[i])
    rnn = tdeep._MODULE_FACTORY["rnn"](FAMILIES["rnn"][0])
    rules = pm.param_shardings(rnn, mesh)
    assert rules["lstms.0.weight_ih_l0"][1].is_shard() and rules["lstms.0.weight_hh_l0_reverse"][1].is_shard()
    assert not rules["lstms.0.bias_hh_l0"][1].is_shard()
    assert pm.column_splits(rnn.lstms[0], 2) is None
    odd = tdeep._MODULE_FACTORY["rnn"]({**FAMILIES["rnn"][0], "units": 5})   # 20 stacked rows, 5 units: JAX's rule
    assert not pm.param_shardings(odd, mesh)["lstms.0.weight_ih_l0"][1].is_shard()
    tr = tdeep._MODULE_FACTORY["transformer"](FAMILIES["transformer"][0])
    assert pm.column_splits(tr.attns[0].query, 2) == {"kernel": 2, "bias": 1}
    assert pm.column_splits(tr.attns[0].out, 2) == {"kernel": 2}
    ds = tdeep._MODULE_FACTORY["ds_cnn"](FAMILIES["ds_cnn"][0])
    assert ds.convs[1].groups == 8 and pm.column_splits(ds.convs[1], 2) == {"weight": 0}
    assert pm.column_splits(torch.nn.Conv2d(6, 6, 3, groups=3), 2) is None   # 3 groups over 2 ranks: kept whole


def _split_vs_whole(layer, x, cotangent):
    y, gx, grads = pm.run_ranks(pm.split_layer_check, (layer, x, cotangent), [CPU] * 2, timeout=120)
    xw = x.clone().requires_grad_(True)
    yw = layer(xw)
    (yw * cotangent).sum().backward()
    assert y.shape == yw.shape
    assert _rel(y, yw.detach()) <= 1e-12
    assert _rel(gx, xw.grad) <= 1e-12
    for name, p in layer.named_parameters():
        assert _rel(grads[name], p.grad) <= 1e-12, name


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_split_equals_the_whole_layer(stride):
    """A depthwise 3x3 conv (8 channels, bias) split by channel over 2 ranks:
    its output, the input's gradient and the parameters' gradients are
    the whole layer's."""
    g = torch.Generator().manual_seed(stride)
    layer = torch.nn.Conv2d(8, 8, 3, stride, padding=1, groups=8).to(torch.float64)
    with torch.no_grad():
        layer.bias.normal_(generator=g)
    x = torch.randn(3, 8, 9, 10, generator=g, dtype=torch.float64)
    cot = torch.randn(layer(x).shape, generator=g, dtype=torch.float64)
    _split_vs_whole(layer, x, cot)


@pytest.mark.parametrize("kind", ["query", "out"])
def test_projection_split_equals_the_whole_layer(kind):
    """An attention projection split on its output features: a query's
    (d, heads, head_dim) kernel and (heads, head_dim) bias on head_dim, the
    output's (heads, head_dim, d) kernel on d with its (d,) bias whole."""
    g = torch.Generator().manual_seed(7)
    layer = (Projection((8, 2, 4), (2, 4), 8) if kind == "query" else Projection((2, 4, 8), (8,), 8)).double()
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(generator=g)
    x = torch.randn(3, 5, *layer.kernel.shape[: layer.kernel.dim() - layer.bias.dim()], generator=g,
                    dtype=torch.float64)
    cot = torch.randn(layer(x).shape, generator=g, dtype=torch.float64)
    _split_vs_whole(layer, x, cot)
