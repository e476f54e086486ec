"""Port parity: the ``mlp`` and ``rnn`` trainers of audio_edge_ml_pipeline_torch
(``MLPModule``, ``BiLSTMModule``, their trainers, the flax key layout of their
bundles, the train CLI on runs 1-3 of ``configs/training.yaml``'s schema)
against the JAX package's flax modules, ``FlaxTrainer`` and train CLI, on the
CPU at a small size: 4 classes, (3, 4) vectors for the mlp, 5 steps of 6
features and 8 units for the rnn."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import get_model

N_CLASSES = 4
REL = 1e-5   # loss and gradients: float32 sums in other orders
CASES = {    # name -> (trainer kwargs, feature shape)
    "mlp": (dict(hidden_units=[16, 8]), (3, 4)),
    "rnn": (dict(units=8, n_layers=1), (5, 6)),
    "rnn2": (dict(units=8, n_layers=2), (5, 6)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _model(name):
    return name.rstrip("2")


def _dataset(seed, shape, per_class=9):
    """Rows with a class-dependent offset on part of the last axis."""
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(N_CLASSES), per_class).astype(np.int32)
    X = r.normal(0, 0.5, size=(len(y), *shape)).astype(np.float32)
    for c in range(N_CLASSES):
        X[y == c, ..., c % shape[-1]] += 1.0
    perm = r.permutation(len(y))
    return X[perm], y[perm]


def _jax_trainer(name, **kw):
    kwargs, _ = CASES[name]
    return {"mlp": jdeep.MLPTrainer, "rnn": jdeep.RNNTrainer}[_model(name)](**kwargs, **kw)


def _jax_bundle(name, path, Xp, seed=7):
    """A flax-initialised bundle of ``name`` for inputs like ``Xp``: both
    trainers warm-start from it."""
    jt = _jax_trainer(name, dropout=0.0)
    jt._arch_dict = jt._arch(Xp.shape[1:], N_CLASSES)
    module = jt._module()
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, *Xp.shape[1:])), train=False)["params"]
    jdeep.save_model_bundle(path, jt._arch_dict, params, np.zeros(Xp.shape[-1], np.float32),
                            np.ones(Xp.shape[-1], np.float32))
    return path


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(float(np.max(np.abs(b))), 1e-30))


# -- the modules and the bundle layout --------------------------------------


@pytest.mark.parametrize("n_layers", [1, 2])
def test_lstm_keys_round_trip(n_layers):
    """flax's per-gate cells -> one bidirectional nn.LSTM a layer -> the same
    flax keys and arrays, bias_ih zero and absent from the bundle."""
    module = jdeep.BiLSTMModule(8, n_layers, 0.0, 3)
    flat = jdeep._flatten_params(module.init(jax.random.PRNGKey(n_layers), jnp.zeros((1, 5, 6)))["params"])
    state = tdeep.params_from_flax(flat)
    assert sorted(k for k in flat if "LSTM" in k) == sorted(
        f"p/OptimizedLSTMCell_{c}/{g}/{kind}" for c in range(2 * n_layers)
        for g, kind in [(f"i{x}", "kernel") for x in "ifgo"] + [(f"h{x}", k) for x in "ifgo" for k in ("kernel", "bias")])
    assert state["lstms.0.weight_ih_l0"].shape == (32, 6) and state["lstms.0.weight_hh_l0_reverse"].shape == (32, 8)
    np.testing.assert_array_equal(state["lstms.0.weight_ih_l0"][16:24].numpy(),
                                  flat["p/OptimizedLSTMCell_0/ig/kernel"].T)   # gate order i, f, g, o
    np.testing.assert_array_equal(state["lstms.0.bias_hh_l0_reverse"][8:16].numpy(), flat["p/OptimizedLSTMCell_1/hf/bias"])
    assert not any(state[k].any() for k in state if "bias_ih" in k)
    net = tdeep.BiLSTMModule(8, n_layers, 0.0, 3, 6)
    net.load_state_dict(state, strict=True)
    back = tdeep.params_to_flax(net.state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_a_nonzero_input_bias_has_no_bundle_key():
    net = tdeep.BiLSTMModule(4, 1, 0.0, 2, 3)
    assert not net.lstms[0].bias_ih_l0.requires_grad and not net.lstms[0].bias_ih_l0.any()
    with torch.no_grad():
        net.lstms[0].bias_ih_l0[0] = 1.0
    with pytest.raises(ValueError, match="bias_ih"):
        tdeep.params_to_flax(net.state_dict())


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_logits_match_flax_from_carried_weights(rng, name):
    kwargs, shape = CASES[name]
    Xp = rng.normal(size=(6, int(np.prod(shape)) if name == "mlp" else shape[0], shape[-1])).astype(np.float32)
    Xp = Xp.reshape(6, -1) if name == "mlp" else Xp
    jt = _jax_trainer(name, dropout=0.0)
    jt._arch_dict = jt._arch(Xp.shape[1:], N_CLASSES)
    module = jt._module()
    params = module.init(jax.random.PRNGKey(3), jnp.zeros((1, *Xp.shape[1:])), train=False)["params"]
    theirs = np.asarray(module.apply({"params": params}, jnp.asarray(Xp)))
    net = tdeep._MODULE_FACTORY[_model(name)](jt._arch_dict)
    net.load_state_dict(tdeep.params_from_flax(jdeep._flatten_params(params)), strict=True)
    ours = net.eval()(torch.from_numpy(Xp)).detach().numpy()
    assert ours.shape == theirs.shape == (6, N_CLASSES)
    assert np.max(np.abs(ours - theirs)) <= 1e-5


def test_initialize_uses_flax_initializers():
    tr = tdeep.RNNTrainer(units=16, n_layers=2, device="cpu")
    tr.initialize((40, 216), 27, torch.Generator().manual_seed(0))
    lstm = tr._net.lstms[1]
    for gate in lstm.weight_hh_l0_reverse.detach().chunk(4):   # orthogonal, gate by gate
        np.testing.assert_allclose((gate @ gate.T).numpy(), np.eye(16), atol=1e-5)
    w = lstm.weight_ih_l0.detach()                             # lecun normal on fan-in 2 x 16
    assert abs(float(w.std()) - (1 / 32) ** 0.5) < 0.15 * (1 / 32) ** 0.5
    assert not any(getattr(lstm, k).any() for k in ("bias_ih_l0", "bias_hh_l0", "bias_hh_l0_reverse"))
    flat = tdeep.params_to_flax(tr._net.state_dict())
    assert flat["p/OptimizedLSTMCell_0/ii/kernel"].shape == (216, 16) and flat["p/Dense_1/kernel"].shape == (64, 27)


def test_registry_serves_the_port_trainers(tmp_path):
    assert get_model("mlp") is tdeep.MLPTrainer and get_model("rnn") is tdeep.RNNTrainer
    assert tdeep.MLPTrainer(device="cpu")._prepare_input(np.zeros((2, 3, 4))).shape == (2, 12)
    assert tdeep.RNNTrainer(device="cpu")._prepare_input(np.zeros((2, 40))).shape == (2, 40, 1)
    tr = tdeep.RNNTrainer(units=4, device="cpu")
    tr.initialize((40, 216), 5, torch.Generator().manual_seed(1))
    tr.save(tmp_path / "rnn.npz")
    served = tdeep.load_any_model(tmp_path / "rnn.npz", device="cpu")
    assert isinstance(served, tdeep.RNNTrainer)
    X = np.random.default_rng(0).normal(size=(3, 40, 216)).astype(np.float32)
    np.testing.assert_array_equal(served.predict_proba(X), tr.predict_proba(X))


# -- the first step ---------------------------------------------------------


def _grad_capture():
    """An optax transformation whose new state is the gradient and whose
    update is zero: one train step of the JAX trainer hands back its loss
    and its exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_step_loss_and_gradients_match_flax_trainer(tmp_path, name):
    kwargs, shape = CASES[name]
    X, y = _dataset(0, shape)            # 36 rows, batch 8: the last batch has 4 weighted rows
    bs, seed = 8, 3
    jt = _jax_trainer(name, dropout=0.0, batch_size=bs, seed=seed)
    Xp = jt._prepare_input(X)
    bundle = _jax_bundle(name, tmp_path / "init.npz", Xp)
    steps = -(-len(X) // bs)
    idx_mat, w_mat = tdeep.TorchTrainer._epoch_batches(np.random.default_rng(seed).permutation(len(X)), steps, bs)

    jt._arch_dict = jt._arch(Xp.shape[1:], N_CLASSES)
    jt._adapt_normalization(Xp)
    module = jt._module()
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, *Xp.shape[1:])), train=False)["params"]
    params, _, _ = jdeep.transfer_pretrained(params, {}, bundle)
    capture = _grad_capture()
    train_step = jt._make_train_step(module, capture, ())

    tt = get_model(_model(name))(dropout=0.0, batch_size=bs, seed=seed, pretrained_model=str(bundle), device="cpu",
                                 **kwargs)
    Xt = tt._prepare_input(X)
    np.testing.assert_array_equal(Xt, Xp)
    tt.prepare_fit(Xt, N_CLASSES)
    np.testing.assert_array_equal(tt._norm_mean.numpy(), np.asarray(jt._norm_mean))
    np.testing.assert_array_equal(tt._norm_var.numpy(), np.asarray(jt._norm_var))
    tt._net.train()
    sgd = torch.optim.SGD([p for p in tt._net.parameters() if p.requires_grad], lr=0.0)  # keeps .grad
    for s in (0, steps - 1):
        _, _, j_grads, j_loss, j_acc = train_step(params, {}, capture.init(params), jnp.asarray(Xp), jnp.asarray(y),
                                                  jnp.asarray(idx_mat[s]), jnp.asarray(w_mat[s]), jax.random.PRNGKey(1))
        j_grads = jdeep._flatten_params(j_grads)
        t_loss, t_acc = tt.train_step(sgd, torch.from_numpy(Xt), torch.from_numpy(y.astype(np.int64)),
                                      torch.from_numpy(idx_mat[s].astype(np.int64)), torch.from_numpy(w_mat[s]))
        t_grads = tdeep.params_to_flax({k: p.grad for k, p in tt._net.named_parameters()})
        assert abs(float(t_loss) - float(j_loss)) <= REL * abs(float(j_loss))
        assert float(t_acc) == pytest.approx(float(j_acc), abs=1e-7)
        assert sorted(t_grads) == sorted(j_grads)
        for k in j_grads:
            assert _rel(t_grads[k], j_grads[k]) <= REL, (s, k)


# -- a whole fit ------------------------------------------------------------


def _fit_both(name, tmp_path, epochs=2):
    kwargs, shape = CASES[name]
    X, y = _dataset(1, shape, per_class=10)
    Xtr, ytr, Xva, yva = X[:32], y[:32], X[32:], y[32:]
    names = [f"c{i}" for i in range(N_CLASSES)]
    kw = dict(dropout=0.0, batch_size=8, epochs=epochs, seed=5)
    jt = _jax_trainer(name, **kw)
    bundle = _jax_bundle(name, tmp_path / "init.npz", jt._prepare_input(Xtr))
    logs = {"jax": [], "torch": []}
    jt._extra["pretrained_model"] = str(bundle)
    jt.fit(Xtr, ytr, Xva, yva, names, "j", tmp_path / "jax", None,
           epoch_callback=lambda e, lg: logs["jax"].append(lg) and False)
    tt = get_model(_model(name))(pretrained_model=str(bundle), device="cpu", **kwargs, **kw)
    tt.fit(Xtr, ytr, Xva, yva, names, "t", tmp_path / "torch", None,
           epoch_callback=lambda e, lg: logs["torch"].append(lg) and False)
    return tt, logs, Xva


@pytest.mark.parametrize("name", ["mlp", "rnn"])
def test_two_epoch_fit_matches_flax_trainer(tmp_path, name):
    """Per-epoch losses within 1e-5 relative and final weights within 5e-6
    absolute after 8 Adam steps at lr 1e-3 (see test_torch_train.py)."""
    _, logs, _ = _fit_both(name, tmp_path)
    assert len(logs["jax"]) == len(logs["torch"]) == 2
    for lj, lt in zip(logs["jax"], logs["torch"]):
        for key in ("loss", "val_loss"):
            assert lt[key] == pytest.approx(lj[key], rel=1e-5), key
        for key in ("accuracy", "val_accuracy"):
            assert lt[key] == pytest.approx(lj[key], abs=1e-6), key
    arch_j, flat_j, mean_j, var_j = jdeep.load_model_bundle(tmp_path / "jax" / jdeep.MODEL_FILENAME)
    arch_t, flat_t, mean_t, var_t = jdeep.load_model_bundle(tmp_path / "torch" / tdeep.MODEL_FILENAME)
    assert arch_t == arch_j
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=0, atol=5e-6, err_msg=k)
    np.testing.assert_array_equal(mean_t, mean_j)
    np.testing.assert_array_equal(var_t, var_j)
    info_t = json.loads((tmp_path / "torch" / "model_info.json").read_text())
    info_j = json.loads((tmp_path / "jax" / "model_info.json").read_text())
    assert info_t["params"] == info_j["params"] and info_t["val_accuracy"] == info_j["val_accuracy"]


@pytest.mark.parametrize("name", ["mlp", "rnn"])
def test_port_bundle_reads_in_jax_with_the_same_logits(tmp_path, name):
    tt, _, Xva = _fit_both(name, tmp_path, epochs=1)
    jm = jdeep.load_any_model(tmp_path / "torch" / tdeep.MODEL_FILENAME)
    assert type(jm).__name__ == type(tt).__name__
    ours = tt._batched_logits(tt._prepare_input(Xva))
    theirs = np.asarray(jm._batched_logits(jm._prepare_input(Xva)))
    assert np.max(np.abs(ours - theirs)) <= 1e-5
    np.testing.assert_array_equal(tt.predict(Xva), jm.predict(Xva))


def test_port_trained_mlp_compiles_to_c_with_the_same_forward(tmp_path):
    """tests/test_codegen.py's recipe on an mlp bundle the port trained: the
    C forward within 1e-4 of the port's probabilities."""
    import subprocess

    from audio_edge_ml_pipeline_torch.deploy.codegen import ModelToC

    X, y = _dataset(4, (4, 3), per_class=20)     # 4 mels x 3 frames, flattened to 12
    trainer = tdeep.MLPTrainer(hidden_units=[16, 8], epochs=5, batch_size=16, learning_rate=5e-3, device="cpu")
    trainer.fit(X[:64], y[:64], X[64:], y[64:], list("abcd"), "cg", tmp_path / "run", None)
    gen = ModelToC(tmp_path / "run" / tdeep.MODEL_FILENAME, list("abcd"), sample_rate=16000, n_mels=4, n_fft=512,
                   hop_length=160, duration=2 * 160 / 16000, board="nicla_vision", max_ram_kb=180)
    out = tmp_path / "cproj"
    gen.generate(out)
    exe = out / "host_runner"
    srcs = [out / "host_main.c"] + sorted((out / "src").glob("*.c"))
    r_cc = subprocess.run(["gcc", "-O2", "-std=c99", f"-I{out / 'src'}", "-o", str(exe), *map(str, srcs), "-lm"],
                          capture_output=True, text=True)
    assert r_cc.returncode == 0, r_cc.stderr
    for feat in X[64:67]:
        (out / "feat.f32").write_bytes(feat.astype(np.float32).tobytes())
        run = subprocess.run([str(exe), "--predict-feat", str(out / "feat.f32")], capture_output=True, text=True)
        assert run.returncode == 0, run.stderr
        c_scores = np.array([float(v) for v in run.stdout.split()])
        ours = trainer.predict_proba(feat[None])[0]
        assert c_scores.shape == ours.shape == (N_CLASSES,)
        assert np.max(np.abs(c_scores - ours)) <= 1e-4
