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
    """JAX's vmapped init of 3 trials, and their parameters and mean losses
    after one vm_epoch at dropout 0."""
    module, vm_epoch, _, tx = jtb._get_runner(json.dumps(arch, sort_keys=True))
    variables = jax.vmap(lambda key: module.init({"params": key, "dropout": key}, jnp.zeros((1,) + X.shape[1:]),
                                                 train=False))(jax.random.split(jax.random.PRNGKey(0), 3))
    params = variables["params"]
    cols = {c: v for c, v in variables.items() if c != "params"}
    after, _, _, _, losses = vm_epoch(params, cols, jax.vmap(tx.init)(params), jnp.asarray(LRS), jnp.zeros(3),
                                      jax.vmap(jax.random.PRNGKey)(jnp.arange(1, 4)), jnp.asarray(X),
                                      jnp.asarray(y), jnp.asarray(idx_mat))
    return _flat(jax.tree.map(np.asarray, params)), _flat(jax.tree.map(np.asarray, after)), np.asarray(losses)


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


@pytest.mark.parametrize("name", ["cnn", "mlp", "rnn"])
def test_group_epoch_matches_jax_vm_epoch(name):
    arch, X, y, idx_mat = _inputs(name)
    before, after, jax_losses = _jax_epoch(arch, X, y, idx_mat)
    group = ttb.TrialGroup(arch, _states(before), LRS, np.zeros(3), CPU)
    losses = group.epoch(torch.from_numpy(X), torch.from_numpy(y.astype(np.int64)), idx_mat).numpy()
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5, atol=0)
    expected = _states(after)
    for key, p in group.params.items():
        if key.startswith("lstms") and "bias_ih" in key:   # no flax counterpart: held at zero
            assert not p.requires_grad and not p.detach().any()
            continue
        ref = torch.stack([e[key] for e in expected])
        assert float((p.detach() - ref).abs().max() / ref.abs().max()) <= 1e-4, key


@pytest.mark.parametrize("name", ["cnn", "mlp", "rnn"])
def test_each_trial_of_a_group_equals_the_trial_alone(name):
    arch, X, y, idx_mat = _inputs(name)
    states = ttb.init_states(arch, 3, seed=7)
    rates = np.array([0.0, 0.0, 0.0], np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int64))
    group = ttb.TrialGroup(arch, states, LRS, rates, CPU)
    group.epoch(Xt, yt, idx_mat)
    for i in range(3):
        alone = ttb.TrialGroup(arch, [states[i]], LRS[i : i + 1], rates[i : i + 1], CPU)
        alone.epoch(Xt, yt, idx_mat)
        for key, p in alone.params.items():
            t = p.detach()[0]
            scale = max(float(t.abs().max()), 1e-30)
            assert float((group.params[key].detach()[i] - t).abs().max()) <= 1e-5 * scale, (i, key)
        np.testing.assert_allclose(group.logits(Xt[:16])[i], alone.logits(Xt[:16])[0], rtol=0, atol=1e-5)


def test_runtime_dropout_is_per_trial_and_off_in_eval():
    arch = ARCHS["mlp"]
    group = ttb.TrialGroup(arch, ttb.init_states(arch, 3, seed=0), LRS, [0.0, 0.5, 0.9], CPU)
    x = torch.ones((64, 20))
    with torch.no_grad():
        train = group.runner.logits(group.params, group.rates, x, train=True)
        train2 = group.runner.logits(group.params, group.rates, x, train=True)
        evals = group.runner.logits(group.params, group.rates, x, train=False)
    assert torch.equal(train[0], evals[0])              # rate 0: no mask
    assert not torch.equal(train[1], train2[1])         # rate 0.5: a new mask each call
    assert not torch.equal(train[1], evals[1])
    assert torch.equal(evals, group.runner.logits(group.params, group.rates, x, train=False))


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


def test_several_cards_raise_instead_of_one(data, monkeypatch):
    X, y, Xv, yv, K = data
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttb.train_trial_group("cnn", [{"filters": [8]}], X, y, Xv, yv, K, 1, devices=4,
                              device=torch.device("cuda", 0))


def test_modules_without_a_runtime_rate_keep_nn_dropout():
    """The sequential trainer's path: no dropout_rate, the module's own
    nn.Dropout (a new mask a call in train mode, none in eval)."""
    from audio_edge_ml_pipeline_torch.models.deep import _MODULE_FACTORY

    net = _MODULE_FACTORY["mlp"]({**ARCHS["mlp"], "dropout": 0.5}).train()
    x = torch.ones((8, 20))
    assert not torch.equal(net(x), net(x))
    net.eval()
    assert torch.equal(net(x), net(x, dropout_rate=0.9))
