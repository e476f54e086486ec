"""The port's batched deep trials (audio_edge_ml_pipeline_torch/train/
tune_batched.py) against the JAX package's train/tune_batched.py, on the CPU.

A group of k = 3 trials starts from JAX's own vmapped init (carried in with
``models/deep.py::params_from_flax``: ``jax.random`` draws cannot be
reproduced in torch) and trains one epoch at dropout 0 with three learning
rates on JAX's batches; the stacked parameters must be within 1e-4 of JAX
``_get_runner``'s ``vm_epoch`` result, relative to each tensor's largest
entry (float32 convolutions and sums in other orders, through 6 Adam
steps), and the epoch losses within 1e-5 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.train import search as jsearch
from audio_edge_ml_pipeline_tpu.train import tune as jtune
from audio_edge_ml_pipeline_tpu.train import tune_batched as jtb
from audio_edge_ml_pipeline_torch.models.deep import params_from_flax
from audio_edge_ml_pipeline_torch.train import search as tsearch
from audio_edge_ml_pipeline_torch.train import tune as ttune
from audio_edge_ml_pipeline_torch.train import tune_batched as ttb

CPU = "cpu"
ARCHS = {
    "cnn": {"type": "cnn", "filters": [8, 16], "dropout": 0.0, "n_classes": 4, "first_stride": 2,
            "second_stride": 1, "input_shape": [32, 20, 1]},
    "mlp": {"type": "mlp", "hidden_units": [16, 8], "dropout": 0.0, "n_classes": 4, "input_shape": [20]},
    "rnn": {"type": "rnn", "units": 8, "n_layers": 1, "dropout": 0.0, "n_classes": 4, "input_shape": [12, 20]},
    "ds_cnn": {"type": "ds_cnn", "filters": [8, 16], "dropout": 0.0, "n_classes": 4, "first_stride": 2,
               "pool": "avg", "batch_norm": True, "input_shape": [32, 20, 1]},
    "transformer": {"type": "transformer", "num_heads": 4, "ff_dim": 16, "n_blocks": 1, "dropout": 0.0,
                    "n_classes": 4, "input_shape": [12, 10]},
}
LRS = np.array([1e-3, 3e-3, 1e-2], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    """The data fixture of tests/test_tune_batched.py."""
    rng = np.random.default_rng(0)
    N, T, F, K = 160, 32, 20, 4
    X = rng.standard_normal((N, T, F)).astype(np.float32)
    y = rng.integers(0, K, N).astype(np.int32)
    for c in range(K):
        X[y == c, :, c * 4:(c + 1) * 4] += 1.5
    return X, y, X[:40], y[:40], K


def _flat(tree, prefix="p"):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}") if isinstance(v, dict) else {f"{prefix}/{k}": np.asarray(v)})
    return out


def _inputs(name: str):
    rng = np.random.default_rng(1)
    arch = ARCHS[name]
    X = rng.standard_normal((96, *arch["input_shape"])).astype(np.float32)
    y = rng.integers(0, 4, 96).astype(np.int32)
    idx_mat = rng.permutation(96).reshape(6, 16).astype(np.int32)
    return arch, X, y, idx_mat


def _jax_epoch(arch, X, y, idx_mat):
    """JAX's vmapped init of 3 trials, and their parameters (with their
    BatchNorm statistics, ``c/batch_stats/`` keys) and mean losses after one
    vm_epoch at dropout 0. The BatchNorm scales and biases start off their
    init (1, 0): at bias 0 the ds_cnn is invariant to its stem BatchNorm's
    scale, whose gradient is then float32 roundoff, which Adam lifts to whole
    steps of another sign in each package."""
    module, vm_epoch, _, tx = jtb._get_runner(json.dumps(arch, sort_keys=True))
    variables = jax.vmap(lambda key: module.init({"params": key, "dropout": key}, jnp.zeros((1,) + X.shape[1:]),
                                                 train=False))(jax.random.split(jax.random.PRNGKey(0), 3))
    r = np.random.default_rng(3)

    def moved(path, v):
        keys = [str(getattr(k, "key", k)) for k in path]
        if not any(k.startswith("BatchNorm") for k in keys):
            return v
        return jnp.asarray(r.uniform(0.5, 1.5, v.shape) if keys[-1] == "scale" else r.normal(0, 0.2, v.shape),
                           jnp.float32)

    params = jax.tree_util.tree_map_with_path(moved, variables["params"])
    cols = {c: v for c, v in variables.items() if c != "params"}
    after, cols_after, _, _, losses = vm_epoch(
        params, cols, jax.vmap(tx.init)(params), jnp.asarray(LRS), jnp.zeros(3),
        jax.vmap(jax.random.PRNGKey)(jnp.arange(1, 4)), jnp.asarray(X), jnp.asarray(y), jnp.asarray(idx_mat))
    before = {**_flat(jax.tree.map(np.asarray, params)), **_flat(jax.tree.map(np.asarray, cols), "c")}
    after = {**_flat(jax.tree.map(np.asarray, after)), **_flat(jax.tree.map(np.asarray, cols_after), "c")}
    return before, after, np.asarray(losses)


def _states(flat, k=3):
    return [params_from_flax({key: v[i] for key, v in flat.items()}) for i in range(k)]


@pytest.mark.parametrize("draw", [
    {"filters": [8, 16], "batch_size": 32, "learning_rate": 1e-3, "dropout": 0.1},
    {"filters": [8, 16], "batch_size": 16, "learning_rate": 1e-3, "dropout": 0.1, "epochs": 4},
    {"filters": [16, 16], "batch_size": 32, "learning_rate": 9e-3, "dropout": 0.4, "epochs": 9},
    {"units": 64, "n_layers": 2, "learning_rate": 2e-3},
])
def test_shape_key_equals_jax(draw):
    assert ttb.shape_key(draw) == jtb.shape_key(draw)
    assert ttb.shape_key({**draw, "learning_rate": 0.5, "dropout": 0.0}) == ttb.shape_key(draw)


@pytest.mark.parametrize("name", ["cnn", "mlp", "rnn", "ds_cnn", "transformer"])
def test_group_epoch_matches_jax_vm_epoch(name):
    """The ds_cnn's BatchNorm statistics travel as stacked state and must
    match JAX's threaded ``batch_stats``. The transformer's key biases are
    left out: softmax ignores a shift shared by every key, so their gradient
    is zero in exact arithmetic, they never reach the output, and Adam turns
    each package's roundoff into steps of its own."""
    arch, X, y, idx_mat = _inputs(name)
    before, after, jax_losses = _jax_epoch(arch, X, y, idx_mat)
    group = ttb.TrialGroup(arch, _states(before), LRS, np.zeros(3), CPU, noise_seeds=range(3))
    losses = group.epoch(torch.from_numpy(X), torch.from_numpy(y.astype(np.int64)), idx_mat).numpy()
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5, atol=0)
    expected = _states(after)
    assert sorted(group.params) == sorted(expected[0])
    for key, p in group.params.items():
        if key.startswith("lstms") and "bias_ih" in key:   # no flax counterpart: held at zero
            assert not p.requires_grad and not p.detach().any()
            continue
        if key.endswith("key.bias"):
            continue
        ref = torch.stack([e[key] for e in expected])
        assert float((p.detach() - ref).abs().max() / ref.abs().max()) <= 1e-4, key


@pytest.mark.parametrize("name", ["ds_cnn", "transformer"])
def test_four_trial_group_equals_the_trials_alone_in_float64(name):
    """A 4-trial group's first epoch at dropout 0 in float64 against each
    trial trained alone: losses 1e-5 and parameters (and the ds_cnn's
    BatchNorm statistics) 1e-4 relative. In float32 the ds_cnn's stem
    BatchNorm scale, whose gradient at bias 0 is roundoff, moves by 2e-5 of
    its size between the two (Adam lifts roundoff to whole steps)."""
    arch, X, y, idx_mat = _inputs(name)
    states = ttb.init_states(arch, 4, seed=11)
    lrs = np.array([3e-4, 1e-3, 3e-3, 9e-3])
    Xt, yt = torch.from_numpy(X).double(), torch.from_numpy(y.astype(np.int64))
    group = ttb.TrialGroup(arch, states, lrs, np.zeros(4), CPU, torch.float64, noise_seeds=range(4))
    losses = group.epoch(Xt, yt, idx_mat).numpy()
    if name == "ds_cnn":
        assert any(k.endswith(".var") for k in group.params)
    for i in range(4):
        alone = ttb.TrialGroup(arch, [states[i]], lrs[i : i + 1], np.zeros(1), CPU, torch.float64, noise_seeds=[i])
        loss_alone = alone.epoch(Xt, yt, idx_mat).numpy()[0]
        assert abs(losses[i] - loss_alone) <= 1e-5 * abs(loss_alone)
        for key, p in alone.params.items():
            t = p.detach()[0]
            assert float((group.params[key].detach()[i] - t).abs().max()) <= 1e-4 * float(t.abs().max()), (i, key)
        if name == "ds_cnn":   # the statistics moved off their init
            assert not torch.equal(alone.params["bns.0.var"][0], states[i]["bns.0.var"].double())


@pytest.mark.parametrize("name", ["cnn", "mlp", "rnn", "transformer"])   # the ds_cnn: in float64, below
def test_each_trial_of_a_group_equals_the_trial_alone(name):
    arch, X, y, idx_mat = _inputs(name)
    states = ttb.init_states(arch, 3, seed=7)
    rates = np.array([0.0, 0.0, 0.0], np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int64))
    group = ttb.TrialGroup(arch, states, LRS, rates, CPU, noise_seeds=range(3))
    group.epoch(Xt, yt, idx_mat)
    for i in range(3):
        alone = ttb.TrialGroup(arch, [states[i]], LRS[i : i + 1], rates[i : i + 1], CPU, noise_seeds=[i])
        alone.epoch(Xt, yt, idx_mat)
        for key, p in alone.params.items():
            t = p.detach()[0]
            scale = max(float(t.abs().max()), 1e-30)
            assert float((group.params[key].detach()[i] - t).abs().max()) <= 1e-5 * scale, (i, key)
        np.testing.assert_allclose(group.logits(Xt[:16])[i], alone.logits(Xt[:16])[0], rtol=0, atol=1e-5)


def test_runtime_dropout_is_per_trial_and_off_in_eval():
    arch = ARCHS["mlp"]
    group = ttb.TrialGroup(arch, ttb.init_states(arch, 3, seed=0), LRS, [0.0, 0.5, 0.9], CPU, noise_seeds=range(3))
    x = torch.ones((64, 20))
    with torch.no_grad():
        train = group.runner.forward(group.params, group.rates, x, group._noise(x))[0]
        train2 = group.runner.forward(group.params, group.rates, x, group._noise(x))[0]
        evals = group.runner.logits(group.params, group.rates, x)
    assert torch.equal(train[0], evals[0])              # rate 0: no mask
    assert not torch.equal(train[1], train2[1])         # rate 0.5: a new mask each call
    assert not torch.equal(train[1], evals[1])
    assert torch.equal(evals, group.runner.logits(group.params, group.rates, x))


def test_train_trial_group_applies_each_trials_lr(data):
    X, y, Xv, yv, K = data
    draws = [{"filters": [8, 16], "first_stride": 2, "batch_size": 32, "learning_rate": lr, "dropout": dr}
             for lr, dr in [(3e-3, 0.1), (1e-5, 0.5)]]   # one sane, one crippled
    res = ttb.train_trial_group("cnn", draws, X, y, Xv, yv, K, sweep_epochs=4, seed=1, device=CPU)
    assert len(res) == 2 and all(len(r["history"]) == 4 for r in res)
    assert res[0]["val_accuracy"] > res[1]["val_accuracy"] + 0.1
    assert set(res[0]) == {"val_accuracy", "val_f1_macro", "history"}


def test_run_study_batched_draws_as_jax_and_marks_pruned_trials(data):
    """The first round's draws equal JAX's (the same TPE stream), and a
    pruner's verdicts reach the study's states as in JAX."""
    X, y, Xv, yv, K = data
    space = {"learning_rate": {"type": "loguniform", "low": 1e-4, "high": 1e-2},
             "dropout": {"type": "float", "low": 0.05, "high": 0.4}}

    class PruneAllAfterFirst:
        def should_prune(self, study, record):
            return record.number > 0 and len(record.intermediate) >= 1

    states, results = {}, {}
    for name, search, tune, tb, kw in (("jax", jsearch, jtune, jtb, {}), ("port", tsearch, ttune, ttb, {"device": CPU})):
        study = search.create_study(sampler=search.TPESampler(seed=0), pruner=PruneAllAfterFirst())
        results[name] = tb.run_study_batched(
            study, space, {"filters": [8], "batch_size": 32}, tune.sample_search_space, "cnn",
            X, y, Xv, yv, K, n_trials=3, sweep_epochs=2, batch_k=3, seed=0, **kw)
        states[name] = [(t.state, t.params, len(t.intermediate)) for t in study.trials]
    assert states["port"] == states["jax"]
    assert [s for s, _, _ in states["port"]] == ["COMPLETE", "PRUNED", "PRUNED"]
    assert set(results["port"]) == set(results["jax"]) == {0}


def test_a_failed_group_marks_its_trials_fail(data, monkeypatch, caplog):
    X, y, Xv, yv, K = data

    def boom(*a, **kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(ttb, "train_trial_group", boom)
    study = tsearch.create_study(sampler=tsearch.TPESampler(seed=0), pruner=tsearch.NopPruner())
    results = ttb.run_study_batched(study, {"learning_rate": [1e-3, 1e-2]}, {"filters": [8]},
                                    ttune.sample_search_space, "cnn", X, y, Xv, yv, K, n_trials=2,
                                    sweep_epochs=1, batch_k=2, device=CPU)
    assert results == {} and [t.state for t in study.trials] == ["FAIL", "FAIL"]
    assert "trial group failed: out of memory" in caplog.text


@pytest.mark.parametrize("name", ["cnn", "rnn"])
def test_trials_split_over_devices_equal_the_unsplit_group(data, name, caplog):
    """4 trials with dropout on, split over 3 devices (parts of 2, 1 and 1
    trials): each trial's history and predictions equal the unsplit group's,
    its weights and masks following the trial, not the part."""
    X, y, Xv, yv, K = data
    if name == "rnn":
        X, Xv = X[:, :6, :5], Xv[:, :6, :5]
    knobs = {"cnn": {"filters": [8, 16], "first_stride": 2}, "rnn": {"units": 4}}[name]
    draws = [{**knobs, "batch_size": 32, "learning_rate": lr, "dropout": 0.3}
             for lr in (3e-3, 1e-3, 3e-4, 9e-3)]
    caplog.set_level("INFO")
    whole = ttb.train_trial_group(name, draws, X, y, Xv, yv, K, sweep_epochs=2, seed=1, device=CPU)
    split = ttb.train_trial_group(name, draws, X, y, Xv, yv, K, sweep_epochs=2, seed=1, device=CPU,
                                  devices=[CPU] * 3)
    assert "trial batch of 4 (4 real) sharded over 3 devices" in caplog.text
    for a, b in zip(whole, split):
        np.testing.assert_allclose(b["history"], a["history"], rtol=0, atol=1e-12)
        assert b["val_f1_macro"] == pytest.approx(a["val_f1_macro"], abs=1e-12)


def test_trial_masks_follow_the_trial():
    """A group's dropout masks come from each trial's own generator: trial i
    of a group draws what it draws alone."""
    arch = {**ARCHS["mlp"], "dropout": 0.0}
    states = ttb.init_states(arch, 3, seed=0)
    x = torch.ones((8, 20))
    group = ttb.TrialGroup(arch, states, LRS, [0.5, 0.5, 0.5], CPU, noise_seeds=[10, 11, 12])
    noise = group._noise(x)
    alone = ttb.TrialGroup(arch, states[1:2], LRS[1:2], [0.5], CPU, noise_seeds=[11])
    assert [n.shape[0] for n in noise] == [3] * len(noise) and len(noise) == 2   # the hidden layer's two masks
    for n, m in zip(noise, alone._noise(x)):
        assert torch.equal(n[1], m[0]) and not torch.equal(n[0], n[1])


def test_modules_without_a_runtime_rate_keep_nn_dropout():
    """The sequential trainer's path: no dropout_rate, the module's own
    nn.Dropout's rate (a new mask a call in train mode, none in eval)."""
    from audio_edge_ml_pipeline_torch.models.deep import _MODULE_FACTORY

    net = _MODULE_FACTORY["mlp"]({**ARCHS["mlp"], "dropout": 0.5}).train()
    x = torch.ones((8, 20))
    assert not torch.equal(net(x), net(x))
    net.eval()
    assert torch.equal(net(x), net(x, dropout_rate=0.9))
