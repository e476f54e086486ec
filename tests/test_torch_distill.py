"""Port parity: the ``distillation_cnn`` of audio_edge_ml_pipeline_torch
(``kd_row_losses``, ``DistillationCNNTrainer``) against the JAX package's
``DistillationCNNTrainer`` on the CPU, and ``configs/experiments/
fsc22-nicla-kd.yaml`` (teacher, then student) through the port's train CLI
at a tiny size: image_size 32, a few epochs, 10 of 12 synthetic classes."""

import json
import logging
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_torch.features.base import FeatureSet
from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.train import train as ttrain
from audio_edge_ml_pipeline_torch.utils import tracking as ttracking

REPO = Path(__file__).resolve().parent.parent
N_CLASSES = 4
KD_LOSS_REL = 1e-6   # the loss on the same student / teacher logits
LOSS_REL = 1e-5      # one student step (the gates of tests/test_torch_mlp_rnn.py)
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield
    ttracking.set_tracking_uri(None)


def _grad_capture():
    """An optax transformation whose new state is the gradient and whose
    update is zero (tests/test_torch_mlp_rnn.py)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


class _GivenLogits:
    """A stand-in flax module whose logits are its one parameter ``s``."""

    def apply(self, variables, x, train=False, rngs=None):
        return variables["params"]["s"]


@pytest.mark.parametrize("temperature,alpha", [(4.0, 0.7), (2.0, 0.3), (1.0, 1.0)])
def test_kd_loss_matches_jax_on_the_same_logits(temperature, alpha):
    """JAX's own KD step on given student logits (a padded batch: 6 rows of
    weight 1, 2 of weight 0) against ``kd_row_losses``, loss and gradient."""
    r = np.random.default_rng(0)
    n, b = 20, 8
    teacher = np.log(np.exp(r.normal(0, 2, (n, 5))) / np.exp(r.normal(0, 2, (n, 5))).sum(1, keepdims=True)
                     + 1e-8).astype(np.float32)
    s = r.normal(0, 3, (b, 5)).astype(np.float32)
    y = r.integers(0, 5, n).astype(np.int32)
    idx = r.permutation(n)[:b].astype(np.int32)
    w = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    jt = jdeep.DistillationCNNTrainer(temperature=temperature, alpha=alpha)
    jt._teacher_logits = teacher
    jt._norm_mean, jt._norm_var = jnp.zeros(1), jnp.ones(1)
    capture = _grad_capture()
    params = {"s": jnp.asarray(s)}
    _, _, j_grad, j_loss, _ = jt._make_train_step(_GivenLogits(), capture)(
        params, {}, capture.init(params), jnp.zeros((n, 1)), jnp.asarray(y), jnp.asarray(idx), jnp.asarray(w),
        jax.random.PRNGKey(0))
    st = torch.tensor(s, requires_grad=True)
    ti = torch.from_numpy(idx.astype(np.int64))
    rows = tdeep.kd_row_losses(st, torch.from_numpy(y.astype(np.int64))[ti], torch.from_numpy(teacher)[ti],
                               temperature, alpha)
    loss = (rows * torch.from_numpy(w)).sum() / torch.from_numpy(w).sum().clamp_min(1.0)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) <= KD_LOSS_REL * abs(float(j_loss))
    assert _rel(st.grad.numpy(), np.asarray(j_grad["s"])) <= 1e-5


def _dataset(seed, shape=(16, 24), per_class=9, n_classes=N_CLASSES):
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(n_classes), per_class).astype(np.int32)
    X = r.uniform(0, 0.4, size=(len(y), *shape)).astype(np.float32)
    for c in range(n_classes):
        X[y == c, (c * 2) % shape[0] : (c * 2) % shape[0] + 2, :] += 0.5
    perm = r.permutation(len(y))
    return X[perm], y[perm]


def test_first_student_step_matches_flax_trainer(tmp_path):
    """One KD step of the [16, 16, 16] student from the same weights and
    teacher logits, on the full batch and on the wrap-around padded last one."""
    X, y = _dataset(0)                    # 36 rows, batch 8
    bs, seed = 8, 3
    teacher = np.log(np.random.default_rng(1).dirichlet(np.ones(N_CLASSES), len(X)) + 1e-8).astype(np.float32)
    jt = jdeep.DistillationCNNTrainer(dropout=0.0, batch_size=bs, seed=seed)
    Xp = jt._prepare_input(X)
    jt._arch_dict = jt._arch(Xp.shape[1:], N_CLASSES)
    jt._adapt_normalization(Xp)
    module = jt._module()
    params = module.init(jax.random.PRNGKey(5), jnp.zeros((1, *Xp.shape[1:])), train=False)["params"]
    bundle = tmp_path / "init.npz"
    jdeep.save_model_bundle(bundle, jt._arch_dict, params, np.zeros(1, np.float32), np.ones(1, np.float32))
    jt._teacher_logits = teacher
    capture = _grad_capture()
    train_step = jt._make_train_step(module, capture)
    steps = -(-len(X) // bs)
    idx_mat, w_mat = tdeep.TorchTrainer._epoch_batches(np.random.default_rng(seed).permutation(len(X)), steps, bs)

    tt = get_model("distillation_cnn")(dropout=0.0, batch_size=bs, seed=seed, pretrained_model=str(bundle),
                                       device="cpu")
    Xt = tt._prepare_input(X)
    tt.prepare_fit(Xt, N_CLASSES)
    tt.set_teacher_logits(teacher)
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
        for k in j_grads:
            assert _rel(t_grads[k], j_grads[k]) <= GRAD_REL, (s, k)


def test_teacher_of_either_package_and_either_knob(tmp_path, caplog):
    """A JAX-trained teacher bundle (a cnn) through the port's
    load_any_model, named by ``teacher_model`` or ``teacher_model_path``:
    the student's targets are log(p + 1e-8) of its probabilities on the
    training rows. Without a teacher the student trains on plain CE and
    says so; its bundle reads in JAX."""
    X, y = _dataset(2, per_class=12)
    names = [f"c{i}" for i in range(N_CLASSES)]
    jteacher = jdeep.CNNTrainer(filters=[4, 8], first_stride=2, epochs=2, batch_size=16)
    jteacher.fit(X[:40], y[:40], X[40:], y[40:], names, "t", tmp_path / "teacher", None)
    tpath = tmp_path / "teacher" / jdeep.MODEL_FILENAME
    expected = np.log(tdeep.load_any_model(tpath, device="cpu").predict_proba(X[:40]) + 1e-8)
    np.testing.assert_allclose(expected, np.log(jteacher.predict_proba(X[:40]) + 1e-8), rtol=0, atol=1e-5)
    for knob in ("teacher_model", "teacher_model_path"):
        st = get_model("distillation_cnn")(filters=[4, 8], epochs=1, batch_size=16, device="cpu", **{knob: str(tpath)})
        assert st.teacher_model == str(tpath)
        st.fit(X[:40], y[:40], X[40:], y[40:], names, "s", tmp_path / knob, None)
        np.testing.assert_array_equal(st._teacher_logits.numpy(), expected.astype(np.float32))
        assert st._architecture_params()["teacher_model"] == str(tpath)
    plain = get_model("distillation_cnn")(filters=[4, 8], epochs=1, batch_size=16, device="cpu")
    with caplog.at_level(logging.WARNING):
        plain.fit(X[:40], y[:40], X[40:], y[40:], names, "p", tmp_path / "plain", None)
    assert "without teacher_model: training with plain CE" in caplog.text
    jm = jdeep.load_any_model(tmp_path / "plain" / tdeep.MODEL_FILENAME)
    assert type(jm).__name__ == "DistillationCNNTrainer"
    np.testing.assert_array_equal(jm.predict(X[40:]), plain.predict(X[40:]))


def test_jax_student_bundle_serves_in_the_port(tmp_path):
    """A flax-initialised [16, 16, 16] student written by the JAX package:
    the port's load_any_model serves it with flax's logits."""
    X, _ = _dataset(6, per_class=2)
    jt = jdeep.DistillationCNNTrainer(dropout=0.0)
    Xp = jt._prepare_input(X)
    arch = jt._arch(Xp.shape[1:], N_CLASSES)
    module = jdeep._MODULE_FACTORY["distillation_cnn"](arch)
    params = module.init(jax.random.PRNGKey(2), jnp.zeros((1, *Xp.shape[1:])), train=False)["params"]
    jdeep.save_model_bundle(tmp_path / "student.npz", arch, params, np.zeros(1, np.float32), np.ones(1, np.float32))
    tm = tdeep.load_any_model(tmp_path / "student.npz", device="cpu")
    assert isinstance(tm, tdeep.DistillationCNNTrainer)
    theirs = np.asarray(module.apply({"params": params}, jnp.asarray(Xp / np.sqrt(1.0 + 1e-6))))   # norm (0, 1)
    assert np.max(np.abs(tm._batched_logits(tm._prepare_input(X)) - theirs)) <= 1e-5


def test_student_defaults_equal_jax():
    ours, theirs = tdeep.DistillationCNNTrainer(device="cpu"), jdeep.DistillationCNNTrainer()
    assert ours._architecture_params() == theirs._architecture_params()
    assert ours._arch((40, 501, 1), 10) == theirs._arch((40, 501, 1), 10)
    assert ours._prepare_input(np.zeros((2, 40, 50))).shape == theirs._prepare_input(np.zeros((2, 40, 50))).shape


# -- the KD recipe through the train CLI ------------------------------------

CLASSES = [f"synth{c:02d}" for c in range(12)]


def kd_config_copy(train_dir: Path, test_dir: Path, out_dir: Path) -> Path:
    """configs/experiments/fsc22-nicla-kd.yaml at a tiny size: its
    FeatureSets and output moved, ``class_filter`` rewritten to 10 of the
    synthetic class names, the teacher at image_size 32 for 2 epochs (1 of
    warm-up), and the commented student step enabled with ``teacher_model``
    on the teacher's bundle, for 2 epochs."""
    doc = yaml.safe_load((REPO / "configs" / "experiments" / "fsc22-nicla-kd.yaml").read_text())
    assert [r["model"] for r in doc["runs"]] == ["efficientnet_teacher"] and len(doc["class_filter"]) == 10
    doc.update(features_dir=str(train_dir), features_test_dir=str(test_dir), output_dir=str(out_dir / "models"),
               class_filter=CLASSES[1:11])
    teacher = doc["runs"][0]
    teacher["params"].update(image_size=32, warmup_epochs=1, epochs=2)
    doc["runs"].append({"model": "distillation_cnn", "name": "fsc22_nicla_kd_student", "params": {
        "teacher_model": str(out_dir / "models" / teacher["name"] / tdeep.MODEL_FILENAME),
        "filters": [16, 16, 16], "temperature": 4.0, "alpha": 0.7, "epochs": 2, "batch_size": 16,
        "learning_rate": 0.001}})
    path = out_dir / "fsc22-nicla-kd.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


def _featureset(path, seed, per_class):
    X, y = _dataset(seed, shape=(16, 24), per_class=per_class, n_classes=len(CLASSES))
    FeaturePipeline.save(FeatureSet(features=X, feature_type="audio_mel_spec", modality="audio",
                                    metadata=[{} for _ in y], labels=y, label_names=CLASSES), path)
    return X, y


def test_kd_recipe_runs_through_the_port_train_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _featureset(tmp_path / "mel_train", 3, per_class=5)
    Xte, yte = _featureset(tmp_path / "mel_val", 4, per_class=2)
    cfg = kd_config_copy(tmp_path / "mel_train", tmp_path / "mel_val", tmp_path)
    ttrain.main(["--config", str(cfg), "--device", "cpu"])
    models = tmp_path / "models"
    shortlist = json.loads((models / "shortlist.json").read_text())
    assert sorted(c["model"] for c in shortlist["candidates"]) == ["distillation_cnn", "efficientnet_teacher"]
    teacher = tdeep.load_any_model(models / "fsc22_nicla_kd_teacher" / tdeep.MODEL_FILENAME, device="cpu")
    student = tdeep.load_any_model(models / "fsc22_nicla_kd_student" / tdeep.MODEL_FILENAME, device="cpu")
    assert teacher._arch_dict["n_classes"] == student._arch_dict["n_classes"] == 10
    assert teacher._arch_dict["image_size"] == 32 and student._arch_dict["filters"] == [16, 16, 16]
    info = json.loads((models / "fsc22_nicla_kd_student" / "model_info.json").read_text())
    assert info["params"]["teacher_model"].endswith("fsc22_nicla_kd_teacher/model.flax.npz")
    runs = {r.run_name.rsplit("_", 2)[0]: r for r in ttracking.search_runs("fsc22-nicla-kd")}
    assert "test_val_accuracy" in runs["fsc22_nicla_kd_student"].metrics

    # the student's project: gcc, and the C scores within 1e-4 of predict_proba
    from audio_edge_ml_pipeline_torch.deploy.codegen import ModelToC

    gen = ModelToC(models / "fsc22_nicla_kd_student" / tdeep.MODEL_FILENAME, CLASSES[1:11], sample_rate=16000,
                   n_mels=16, n_fft=512, hop_length=160, duration=23 * 160 / 16000, board="nicla_vision",
                   max_ram_kb=180)
    out = tmp_path / "cproj"
    gen.generate(out)
    exe = out / "host_runner"
    srcs = [out / "host_main.c"] + sorted((out / "src").glob("*.c"))
    r_cc = subprocess.run(["gcc", "-O2", "-std=c99", f"-I{out / 'src'}", "-o", str(exe), *map(str, srcs), "-lm"],
                          capture_output=True, text=True)
    assert r_cc.returncode == 0, r_cc.stderr
    for feat in Xte[:2]:
        (out / "feat.f32").write_bytes(feat.astype(np.float32).tobytes())
        run = subprocess.run([str(exe), "--predict-feat", str(out / "feat.f32")], capture_output=True, text=True)
        assert run.returncode == 0, run.stderr
        c_scores = np.array([float(v) for v in run.stdout.split()])
        ours = student.predict_proba(feat[None])[0]
        assert np.max(np.abs(c_scores - ours)) <= 1e-4 and int(c_scores.argmax()) == int(ours.argmax())
