"""Port parity: the ``transformer`` of audio_edge_ml_pipeline_torch
(``TransformerModule`` on ``layers.SelfAttention`` and ``layers.LayerNorm``,
``TransformerTrainer``, its bundle) against the JAX package's flax
``TransformerModule`` (``nn.MultiHeadDotProductAttention``, LayerNorm
epsilon 1e-6), ``FlaxTrainer`` and bundle I/O, on the CPU at a small size:
d 10 with 4 heads (qkv features 8, fewer than d) and d 16 with 2 heads,
sequences of 7 steps, 4 classes."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import get_model

N_CLASSES = 4
LOGIT_TOL = 1e-5   # eval logits
TRAIN_REL = 1e-6   # train-mode logits at dropout 0, relative to the largest
LOSS_REL = 1e-5    # the first step's loss (the gates of tests/test_torch_mlp_rnn.py)
GRAD_REL = 1e-4    # its gradients, relative to each tensor's largest
CASES = {"d10h4": (10, dict(num_heads=4, ff_dim=16, n_blocks=2)),
         "d16h2": (16, dict(num_heads=2, ff_dim=24, n_blocks=1))}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _arch(name, steps=7):
    d, kw = CASES[name]
    return {"type": "transformer", **kw, "dropout": 0.0, "n_classes": N_CLASSES, "input_shape": [steps, d]}


def _flax_variables(arch, seed):
    """flax init of ``arch`` with its LayerNorms moved off scale 1, bias 0."""
    module = jdeep._MODULE_FACTORY["transformer"](arch)
    params = module.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed)},
                         jnp.zeros((1, *arch["input_shape"])), train=False)["params"]
    r = np.random.default_rng(seed)

    def moved(path, v):
        keys = [str(getattr(p, "key", p)) for p in path]
        if not any(k.startswith("LayerNorm") for k in keys):
            return v
        return jnp.asarray(r.uniform(0.5, 1.5, v.shape) if keys[-1] == "scale" else r.normal(0, 0.2, v.shape),
                           jnp.float32)

    return module, jax.tree_util.tree_map_with_path(moved, params)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


def _dataset(seed, d, steps=7, per_class=9):
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(N_CLASSES), per_class).astype(np.int32)
    X = r.normal(0, 0.5, size=(len(y), steps, d)).astype(np.float32)
    for c in range(N_CLASSES):
        X[y == c, :, c] += 1.0
    perm = r.permutation(len(y))
    return X[perm], y[perm]


@pytest.mark.parametrize("name", sorted(CASES))
def test_keys_round_trip_in_flax_shapes(name):
    """16 tensors a block and 4 for the head (36 at two blocks): the
    attention kernels (d, heads, head_dim) and (heads, head_dim, d) keep
    flax's shapes, qkv = 4 * (10 // 4) = 8 < d."""
    arch = _arch(name)
    _, params = _flax_variables(arch, 0)
    flat = jdeep._flatten_params(params)
    d, kw = CASES[name]
    heads, hd = kw["num_heads"], max(1, d // kw["num_heads"])
    assert len(flat) == 16 * kw["n_blocks"] + 4
    assert flat["p/MultiHeadDotProductAttention_0/query/kernel"].shape == (d, heads, hd)
    assert flat["p/MultiHeadDotProductAttention_0/out/kernel"].shape == (heads, hd, d)
    state = tdeep.params_from_flax(flat)
    assert state["attns.0.key.bias"].shape == (heads, hd) and state["lns.0.weight"].shape == (d,)
    net = tdeep._MODULE_FACTORY["transformer"](arch)
    net.load_state_dict(state, strict=True)
    back = tdeep.params_to_flax(net.state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_match_flax_in_eval_and_train_mode(name):
    arch = _arch(name)
    module, params = _flax_variables(arch, 3)
    x = np.random.default_rng(1).normal(size=(5, *arch["input_shape"])).astype(np.float32)
    net = tdeep._MODULE_FACTORY["transformer"](arch)
    net.load_state_dict(tdeep.params_from_flax(jdeep._flatten_params(params)), strict=True)
    theirs = np.asarray(module.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = net.eval()(torch.from_numpy(x)).numpy()
        ours_t = net.train()(torch.from_numpy(x), dropout_rate=0.0).numpy()
    theirs_t = np.asarray(module.apply({"params": params}, jnp.asarray(x), train=True,
                                       rngs={"dropout": jax.random.PRNGKey(0)}))
    assert ours.shape == theirs.shape == (5, N_CLASSES)
    assert np.max(np.abs(ours - theirs)) <= LOGIT_TOL
    assert _rel(ours_t, theirs_t) <= TRAIN_REL


def test_attention_alone_matches_flax():
    """One MultiHeadDotProductAttention at d 10, 4 heads, qkv 8, and the
    LayerNorm at epsilon 1e-6 on rows of variance 1e-6 (where torch's default
    1e-5 would show)."""
    from flax import linen as fnn

    from audio_edge_ml_pipeline_torch.models.layers import LayerNorm, SelfAttention

    x = np.random.default_rng(2).normal(size=(3, 6, 10)).astype(np.float32)
    mha = fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=8, out_features=10)
    p = mha.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x))["params"]
    p = jax.tree_util.tree_map(lambda v: v + 0.1 * jnp.ones_like(v), p)   # biases off zero
    theirs = np.asarray(mha.apply({"params": p}, jnp.asarray(x), jnp.asarray(x)))
    att = SelfAttention(10, 4, 2)
    att.load_state_dict({f"{k}.{leaf}": torch.tensor(np.asarray(v)) for k, sub in p.items()
                         for leaf, v in sub.items()})
    with torch.no_grad():
        assert np.max(np.abs(att(torch.from_numpy(x)).numpy() - theirs)) <= 1e-6
    row = (1e-3 * np.random.default_rng(3).normal(size=(2, 10))).astype(np.float32)
    theirs_ln = np.asarray(fnn.LayerNorm(epsilon=1e-6).apply({"params": {"scale": jnp.ones(10), "bias": jnp.zeros(10)}},
                                                            jnp.asarray(row)))
    with torch.no_grad():
        ours_ln = LayerNorm(10, eps=1e-6)(torch.from_numpy(row)).numpy()
    assert np.max(np.abs(ours_ln - theirs_ln)) <= 1e-5 * np.max(np.abs(theirs_ln))
    with torch.no_grad():
        torch_default = torch.nn.functional.layer_norm(torch.from_numpy(row), (10,)).numpy()
    assert np.max(np.abs(torch_default - theirs_ln)) > 0.1 * np.max(np.abs(theirs_ln))


def _grad_capture():
    """An optax transformation whose new state is the gradient and whose
    update is zero (tests/test_torch_mlp_rnn.py)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_step_loss_and_gradients_match_flax_trainer(tmp_path, name):
    d, kw = CASES[name]
    X, y = _dataset(0, d)               # 36 rows, batch 8: the last batch has 4 weighted rows
    bs, seed = 8, 3
    jt = jdeep.TransformerTrainer(dropout=0.0, batch_size=bs, seed=seed, **kw)
    Xp = jt._prepare_input(X)
    arch = jt._arch(Xp.shape[1:], N_CLASSES)
    _, params0 = _flax_variables(arch, 7)
    bundle = tmp_path / "init.npz"
    jdeep.save_model_bundle(bundle, arch, params0, np.zeros(d, np.float32), np.ones(d, np.float32))
    steps = -(-len(X) // bs)
    idx_mat, w_mat = tdeep.TorchTrainer._epoch_batches(np.random.default_rng(seed).permutation(len(X)), steps, bs)

    jt._arch_dict = arch
    jt._adapt_normalization(Xp)
    module = jt._module()
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, *Xp.shape[1:])), train=False)["params"]
    params, _, _ = jdeep.transfer_pretrained(params, {}, bundle)
    capture = _grad_capture()
    train_step = jt._make_train_step(module, capture, ())

    tt = get_model("transformer")(dropout=0.0, batch_size=bs, seed=seed, pretrained_model=str(bundle), device="cpu",
                                  **kw)
    Xt = tt._prepare_input(X)
    tt.prepare_fit(Xt, N_CLASSES)
    tt._net.train()
    sgd = torch.optim.SGD([p for p in tt._net.parameters() if p.requires_grad], lr=0.0)
    for s in (0, steps - 1):
        _, _, j_grads, j_loss, _ = train_step(params, {}, capture.init(params), jnp.asarray(Xp), jnp.asarray(y),
                                              jnp.asarray(idx_mat[s]), jnp.asarray(w_mat[s]), jax.random.PRNGKey(1))
        t_loss, _ = tt.train_step(sgd, torch.from_numpy(Xt), torch.from_numpy(y.astype(np.int64)),
                                  torch.from_numpy(idx_mat[s].astype(np.int64)), torch.from_numpy(w_mat[s]))
        assert abs(float(t_loss) - float(j_loss)) <= LOSS_REL * abs(float(j_loss))
        j_grads = jdeep._flatten_params(j_grads)
        t_grads = tdeep.params_to_flax({k: p.grad for k, p in tt._net.named_parameters()})
        assert sorted(t_grads) == sorted(j_grads)
        scale = max(float(np.abs(g).max()) for g in j_grads.values())
        for k in j_grads:
            if k.endswith("key/bias"):
                # zero in exact arithmetic (softmax ignores a shift shared by every key): roundoff on both sides
                assert max(np.abs(t_grads[k]).max(), np.abs(j_grads[k]).max()) <= 1e-6 * scale, (s, k)
                continue
            assert _rel(t_grads[k], j_grads[k]) <= GRAD_REL, (s, k)


def test_bundles_load_both_ways(tmp_path):
    d, kw = CASES["d10h4"]
    X, y = _dataset(5, d, per_class=10)
    names = [f"c{i}" for i in range(N_CLASSES)]
    tt = get_model("transformer")(epochs=2, batch_size=8, learning_rate=3e-3, device="cpu", **kw)
    tt.fit(X[:32], y[:32], X[32:], y[32:], names, "t", tmp_path / "port", None)
    jm = jdeep.load_any_model(tmp_path / "port" / tdeep.MODEL_FILENAME)
    assert type(jm).__name__ == "TransformerTrainer"
    ours = tt._batched_logits(tt._prepare_input(X[32:]))
    assert np.max(np.abs(ours - np.asarray(jm._batched_logits(jm._prepare_input(X[32:]))))) <= LOGIT_TOL
    np.testing.assert_array_equal(tt.predict(X[32:]), jm.predict(X[32:]))

    jt = jdeep.TransformerTrainer(epochs=2, batch_size=8, learning_rate=3e-3, **kw)
    jt.fit(X[:32], y[:32], X[32:], y[32:], names, "j", tmp_path / "jax", None)
    tm = tdeep.load_any_model(tmp_path / "jax" / jdeep.MODEL_FILENAME, device="cpu")
    assert isinstance(tm, tdeep.TransformerTrainer)
    theirs = np.asarray(jt._batched_logits(jt._prepare_input(X[32:])))
    assert np.max(np.abs(tm._batched_logits(tm._prepare_input(X[32:])) - theirs)) <= LOGIT_TOL
    assert tm._arch_dict == jt._arch_dict


def test_transformer_defaults_equal_jax():
    ours, theirs = tdeep.TransformerTrainer(device="cpu"), jdeep.TransformerTrainer()
    assert ours._architecture_params() == theirs._architecture_params() == {"num_heads": 4, "ff_dim": 128,
                                                                             "n_blocks": 2}
    assert ours._arch((40, 216), 27) == theirs._arch((40, 216), 27)
    for shape in ((3, 40), (3, 40, 216)):
        assert ours._prepare_input(np.zeros(shape)).shape == theirs._prepare_input(np.zeros(shape)).shape
