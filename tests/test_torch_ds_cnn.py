"""Port parity: the ``ds_cnn`` of audio_edge_ml_pipeline_torch (``DSCNNModule``
on ``layers.BatchNorm``, ``DSCNNTrainer``, its bundle with ``c/batch_stats``,
its quantized views and its C project) against the JAX package's flax
``DSCNNModule``, ``FlaxTrainer`` and bundle I/O, on the CPU at a small size:
filters [8, 16] on (16, 32) and (15, 33) inputs, 4 classes."""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.optimize import quantize as tq

N_CLASSES = 4
LOGIT_TOL = 1e-5   # eval logits, float32 convolutions summed in other orders
TRAIN_REL = 5e-6   # train-mode logits and new batch_stats vs flax, relative to the largest: flax's float32
#                    batch moments put its own logits up to 2.1e-6 from float64 in these cases, the port's
#                    stay within F64_REL of it
F64_REL = 1e-6     # the port's train-mode logits and statistics vs its own float64 forward pass
LOSS_REL = 1e-5    # the first step's loss (the gates of tests/test_torch_mlp_rnn.py)
GRAD_REL = 1e-4    # its gradients, relative to each tensor's largest


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _arch(shape, filters=(8, 16), first_stride=2, pool="avg", batch_norm=True):
    return {"type": "ds_cnn", "filters": list(filters), "dropout": 0.0, "n_classes": N_CLASSES,
            "first_stride": first_stride, "pool": pool, "batch_norm": batch_norm, "input_shape": [*shape, 1]}


def _flax_variables(arch, seed):
    """flax init of ``arch`` with its BatchNorms moved off their init (scale
    1, bias 0, mean 0, var 1), so that the running statistics matter and no
    gradient is zero in exact arithmetic: at bias 0 the network is invariant
    to a BatchNorm's scale when the next BatchNorm normalises its channel
    (the stem's, through ReLU, the pool and the depthwise conv), and float32
    roundoff is all that such a gradient holds."""
    module = jdeep._MODULE_FACTORY["ds_cnn"](arch)
    variables = module.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed)},
                            jnp.zeros((1, *arch["input_shape"])), train=False)
    r = np.random.default_rng(seed)
    draw = {"mean": lambda n: r.normal(0, 0.3, n), "var": lambda n: r.uniform(0.5, 2.0, n),
            "scale": lambda n: r.uniform(0.5, 1.5, n), "bias": lambda n: r.normal(0, 0.2, n)}

    def moved(path, v):
        keys = [str(getattr(p, "key", p)) for p in path]
        bn = any(k.startswith("BatchNorm") for k in keys)
        return jnp.asarray(draw[keys[-1]](v.shape), jnp.float32) if bn else v

    params = jax.tree_util.tree_map_with_path(moved, variables["params"])
    cols = jax.tree_util.tree_map_with_path(moved, {k: v for k, v in variables.items() if k != "params"})
    return module, params, cols


def _flat(params, cols):
    flat = jdeep._flatten_params(params)
    flat.update(jdeep._flatten_collections(cols))
    return flat


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


def _dataset(seed, shape=(16, 32), per_class=9):
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(N_CLASSES), per_class).astype(np.int32)
    X = r.normal(0, 0.5, size=(len(y), *shape)).astype(np.float32)
    for c in range(N_CLASSES):
        X[y == c, c * 3 : c * 3 + 3, :] += 1.0
    perm = r.permutation(len(y))
    return X[perm], y[perm]


# -- the module and the bundle layout ---------------------------------------


def test_keys_round_trip_with_batch_stats():
    """27 tensors at the JAX defaults: 5 bias-free convs, 5 BatchNorms (scale,
    bias; mean, var in c/batch_stats) and the head."""
    arch = {**_arch((40, 101), filters=(32, 32, 64))}
    _, params, cols = _flax_variables(arch, 0)
    flat = _flat(params, cols)
    assert len(flat) == 27
    state = tdeep.params_from_flax(flat)
    assert state["convs.1.weight"].shape == (32, 1, 3, 3)          # depthwise HWIO (3, 3, 1, 32)
    assert state["bns.4.mean"].shape == (64,) and "c/batch_stats/BatchNorm_4/var" in flat
    net = tdeep._MODULE_FACTORY["ds_cnn"](arch)
    net.load_state_dict(state, strict=True)
    assert net.convs[0].bias is None
    back = tdeep.params_to_flax(net.state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


CASES = [(pool, bn, stride, shape) for pool in ("avg", "max", "none") for bn in (True, False)
         for stride, shape in ((1, (16, 32)), (2, (16, 32)), (2, (15, 33)), (1, (15, 33)))]


@pytest.mark.parametrize("pool,bn,stride,shape", CASES,
                         ids=[f"{p}-{'bn' if b else 'nobn'}-s{s}-{h}x{w}" for p, b, s, (h, w) in CASES])
def test_logits_and_batch_stats_match_flax(pool, bn, stride, shape):
    arch = _arch(shape, first_stride=stride, pool=pool, batch_norm=bn)
    module, params, cols = _flax_variables(arch, 3)
    x = np.random.default_rng(1).normal(size=(6, *shape, 1)).astype(np.float32)
    net = tdeep._MODULE_FACTORY["ds_cnn"](arch)
    net.load_state_dict(tdeep.params_from_flax(_flat(params, cols)), strict=True)
    theirs = np.asarray(module.apply({"params": params, **cols}, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = net.eval()(torch.from_numpy(x)).numpy()
    assert ours.shape == theirs.shape == (6, N_CLASSES)
    assert np.max(np.abs(ours - theirs)) <= LOGIT_TOL

    # train mode at dropout 0: batch statistics, and the updated running ones
    out = module.apply({"params": params, **cols}, jnp.asarray(x), train=True, mutable=["batch_stats"],
                       rngs={"dropout": jax.random.PRNGKey(0)})
    theirs_t, new_cols = out
    stats, stats64 = {}, {}
    with torch.no_grad():
        ours_t = net.train()(torch.from_numpy(x), stats=stats).numpy()
        ours64 = net.double()(torch.from_numpy(x).double(), stats=stats64).numpy()
    net.float()
    assert _rel(ours_t, theirs_t) <= TRAIN_REL
    assert _rel(ours_t, ours64) <= F64_REL
    for k in stats64:
        assert _rel(stats[k].numpy(), stats64[k].numpy()) <= F64_REL, k
    expected = {k: v for k, v in tdeep.params_from_flax(jdeep._flatten_collections(new_cols)).items()}
    assert sorted(stats) == sorted(expected) == (sorted(k for k in net.state_dict() if k.endswith(("mean", "var")))
                                                 if bn else [])
    for k, v in expected.items():
        assert _rel(stats[k].numpy(), v.numpy()) <= TRAIN_REL, k
    # the forward pass threads the statistics out; it mutates nothing
    assert all(torch.equal(net.state_dict()[k], tdeep.params_from_flax(_flat(params, cols))[k]) for k in expected)


# -- the first step ---------------------------------------------------------


def _grad_capture():
    """An optax transformation whose new state is the gradient and whose
    update is zero (tests/test_torch_mlp_rnn.py)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def test_first_step_loss_gradients_and_batch_stats_match_flax_trainer(tmp_path):
    """36 rows at batch 8: the last batch holds 4 weighted rows and 4
    wrap-around padded ones, which BatchNorm's batch statistics see."""
    X, y = _dataset(0)
    bs, seed = 8, 3
    kwargs = dict(filters=[8, 16], first_stride=2, pool="avg", batch_norm=True)
    jt = jdeep.DSCNNTrainer(dropout=0.0, batch_size=bs, seed=seed, **kwargs)
    Xp = jt._prepare_input(X)
    arch = jt._arch(Xp.shape[1:], N_CLASSES)
    _, params0, cols0 = _flax_variables(arch, 7)
    bundle = tmp_path / "init.npz"
    jdeep.save_model_bundle(bundle, arch, params0, np.zeros(1, np.float32), np.ones(1, np.float32), collections=cols0)
    steps = -(-len(X) // bs)
    idx_mat, w_mat = tdeep.TorchTrainer._epoch_batches(np.random.default_rng(seed).permutation(len(X)), steps, bs)

    jt._arch_dict = arch
    jt._adapt_normalization(Xp)
    module = jt._module()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, *Xp.shape[1:])), train=False)
    params, cols, _ = jdeep.transfer_pretrained(variables["params"], {"batch_stats": variables["batch_stats"]},
                                                bundle)
    capture = _grad_capture()
    train_step = jt._make_train_step(module, capture, ("batch_stats",))

    tt = get_model("ds_cnn")(dropout=0.0, batch_size=bs, seed=seed, pretrained_model=str(bundle), device="cpu",
                             **kwargs)
    Xt = tt._prepare_input(X)
    tt.prepare_fit(Xt, N_CLASSES)
    tt._net.train()
    sgd = torch.optim.SGD([p for p in tt._net.parameters() if p.requires_grad], lr=0.0)   # keeps .grad
    for s in (0, steps - 1):
        start = {k: v.clone() for k, v in tt._net.state_dict().items()}
        _, j_cols, j_grads, j_loss, _ = train_step(params, cols, capture.init(params), jnp.asarray(Xp),
                                                   jnp.asarray(y), jnp.asarray(idx_mat[s]), jnp.asarray(w_mat[s]),
                                                   jax.random.PRNGKey(1))
        t_loss, _ = tt.train_step(sgd, torch.from_numpy(Xt), torch.from_numpy(y.astype(np.int64)),
                                  torch.from_numpy(idx_mat[s].astype(np.int64)), torch.from_numpy(w_mat[s]))
        assert abs(float(t_loss) - float(j_loss)) <= LOSS_REL * abs(float(j_loss))
        j_grads = jdeep._flatten_params(j_grads)
        t_grads = tdeep.params_to_flax({k: p.grad for k, p in tt._net.named_parameters()})
        assert sorted(t_grads) == sorted(j_grads)
        for k in j_grads:
            assert _rel(t_grads[k], j_grads[k]) <= GRAD_REL, (s, k)
        t_stats = {k: v for k, v in tdeep.params_to_flax(tt._net.state_dict()).items() if k.startswith("c/")}
        j_stats = jdeep._flatten_collections(j_cols)
        assert sorted(t_stats) == sorted(j_stats) and len(j_stats) == 6
        for k in j_stats:
            assert _rel(t_stats[k], j_stats[k]) <= TRAIN_REL, (s, k)
        # the SGD step at lr 0 left the parameters; only the statistics moved
        moved = [k for k, v in tt._net.state_dict().items() if not torch.equal(v, start[k])]
        assert sorted(moved) == sorted(k for k in start if k.endswith(("mean", "var")))
        tt._net.load_state_dict(start)


# -- a whole fit, and the bundle both ways -----------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A ds_cnn the port trained (3 epochs on 48 rows), its bundle, and
    validation rows."""
    root = tmp_path_factory.mktemp("ds")
    X, y = _dataset(2, per_class=15)
    tt = get_model("ds_cnn")(filters=[8, 16], epochs=3, batch_size=16, learning_rate=5e-3, seed=1, device="cpu")
    tt.fit(X[:48], y[:48], X[48:], y[48:], [f"c{i}" for i in range(N_CLASSES)], "ds", root / "run", None)
    return tt, root / "run" / tdeep.MODEL_FILENAME, X[48:]


def test_port_bundle_reads_in_jax_with_the_same_logits(trained):
    tt, bundle, Xv = trained
    arch, flat, _, _ = jdeep.load_model_bundle(bundle)
    assert arch["type"] == "ds_cnn" and sum(k.startswith("c/batch_stats/") for k in flat) == 6
    # training moved the running statistics off their init
    assert not np.allclose(flat["c/batch_stats/BatchNorm_0/var"], 1.0)
    jm = jdeep.load_any_model(bundle)
    assert type(jm).__name__ == "DSCNNTrainer"
    ours = tt._batched_logits(tt._prepare_input(Xv))
    theirs = np.asarray(jm._batched_logits(jm._prepare_input(Xv)))
    assert np.max(np.abs(ours - theirs)) <= LOGIT_TOL
    np.testing.assert_array_equal(tt.predict(Xv), jm.predict(Xv))


def test_jax_bundle_reads_in_the_port_with_the_same_logits(tmp_path):
    X, y = _dataset(4, per_class=10)
    jt = jdeep.DSCNNTrainer(filters=[8, 16], pool="max", epochs=2, batch_size=16, learning_rate=5e-3)
    jt.fit(X[:32], y[:32], X[32:], y[32:], [f"c{i}" for i in range(N_CLASSES)], "j", tmp_path, None)
    tm = tdeep.load_any_model(tmp_path / jdeep.MODEL_FILENAME, device="cpu")
    assert isinstance(tm, tdeep.DSCNNTrainer)
    ours = tm._batched_logits(tm._prepare_input(X[32:]))
    theirs = np.asarray(jt._batched_logits(jt._prepare_input(X[32:])))
    assert np.max(np.abs(ours - theirs)) <= LOGIT_TOL
    np.testing.assert_array_equal(tm.predict(X[32:]), jt.predict(X[32:]))


def test_quantized_views_keep_the_batch_stats(trained, tmp_path):
    """Both packages quantize the c/ keys alike, and the port's int8 view of
    the ds_cnn loads with its statistics and predicts."""
    from audio_edge_ml_pipeline_tpu.optimize import quantize as jq

    tt, bundle, Xv = trained
    for mode in ("dynamic_int8", "float16"):
        art = tmp_path / f"model_{mode}.npz"
        view = tq._quantize_deep_bundle(bundle, mode, art, tt._prepare_input(Xv), device="cpu")
        ours = np.load(art)
        jart = tmp_path / f"jax_{mode}.npz"
        jq._quantize_deep_bundle(bundle, mode, jart, tt._prepare_input(Xv))
        theirs = np.load(jart)
        assert sorted(ours.files) == sorted(theirs.files)
        assert any(k.startswith("c/batch_stats/") for k in ours.files)
        for k in theirs.files:
            if k != "__meta__":
                np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        state = view._net.state_dict() if hasattr(view, "_net") else view._inner._net.state_dict()
        _, flat_q, _, _, _, _ = tq.load_any_bundle(art)
        # the view's statistics are the artifact's (two dequantizations of the same int8 agree to an ulp)
        np.testing.assert_allclose(state["bns.2.var"].numpy(), flat_q["c/batch_stats/BatchNorm_2/var"], rtol=1e-6)
        assert view.predict(Xv).shape == (len(Xv),)


def test_port_trained_ds_cnn_compiles_to_c_with_the_same_forward(trained, tmp_path):
    """The port's codegen on the port's bundle: the BatchNorm, depthwise and
    avgpool kernels, gcc, and the C scores within 1e-4 of predict_proba."""
    from audio_edge_ml_pipeline_torch.deploy.codegen import ModelToC

    tt, bundle, Xv = trained
    gen = ModelToC(bundle, [f"c{i}" for i in range(N_CLASSES)], sample_rate=16000, n_mels=16, n_fft=512,
                   hop_length=160, duration=31 * 160 / 16000, board="generic", max_ram_kb=180)
    out = tmp_path / "cproj"
    gen.generate(out)
    assert {"dwconv2d", "batchnorm", "avgpool2d"} <= {p["op"] for p in gen.plan}
    exe = out / "host_runner"
    srcs = [out / "host_main.c"] + sorted((out / "src").glob("*.c"))
    r_cc = subprocess.run(["gcc", "-O2", "-std=c99", f"-I{out / 'src'}", "-o", str(exe), *map(str, srcs), "-lm"],
                          capture_output=True, text=True)
    assert r_cc.returncode == 0, r_cc.stderr
    for feat in Xv[:3]:
        (out / "feat.f32").write_bytes(feat.astype(np.float32).tobytes())
        run = subprocess.run([str(exe), "--predict-feat", str(out / "feat.f32")], capture_output=True, text=True)
        assert run.returncode == 0, run.stderr
        c_scores = np.array([float(v) for v in run.stdout.split()])
        ours = tt.predict_proba(feat[None])[0]
        assert c_scores.shape == ours.shape == (N_CLASSES,)
        assert np.max(np.abs(c_scores - ours)) <= 1e-4
        assert int(c_scores.argmax()) == int(ours.argmax())


def test_ds_cnn_defaults_equal_jax():
    ours, theirs = tdeep.DSCNNTrainer(device="cpu"), jdeep.DSCNNTrainer()
    assert ours._architecture_params() == theirs._architecture_params()
    assert ours._arch((40, 501, 1), 27) == theirs._arch((40, 501, 1), 27)
    for shape in ((3, 40), (3, 40, 50), (3, 40, 50, 1)):
        assert ours._prepare_input(np.zeros(shape)).shape == theirs._prepare_input(np.zeros(shape)).shape
