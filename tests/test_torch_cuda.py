"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need an NVIDIA card and skip without one: a CUDA kernel has no CPU
mode. This file imports neither jax nor the JAX package, so it also runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_torch.ops import golden, mel_kernel, mel_unfolded


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's GEMMs in full float32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,sr,n_fft,hop,n_mels", [
    (4, 80000, 16000, 512, 160, 40), (1, 32000, 16000, 512, 160, 40), (3, 16077, 16000, 512, 160, 40),
    (2, 600, 16000, 512, 160, 40), (2, 66150, 22050, 1024, 512, 128), (2, 80000, 16000, 320, 160, 40),
    (3, 16077, 16000, 400, 160, 40), (2, 80000, 16000, 400, 160, 40), (2, 80000, 16000, 640, 160, 40),
    (3, 16077, 16000, 480, 160, 40), (2, 66150, 22050, 2048, 512, 128), (2, 32000, 16000, 2048, 160, 40),
])
def test_mel_folded_matches_plain_version(cuda_device, batch, n, sr, n_fft, hop, n_mels):
    """The FFT sizes go to csrc/mel_rfft.cu (four passes at n_fft 480 and 2048)."""
    rng = np.random.default_rng(batch * 100003 + n)
    y = torch.from_numpy((0.3 * rng.standard_normal((batch, n))).astype(np.float32)).to(cuda_device)
    before, dense_before = mel_kernel.counter.launches, mel_kernel.counter_dense.launches
    out = mel_kernel.mel_power_folded(y, sr, n_mels, n_fft, hop)
    torch.cuda.synchronize()
    assert mel_kernel.counter.launches == before + 1
    assert mel_kernel.counter_dense.launches == dense_before  # the FFT route, not the dense kernel
    assert out.shape == (batch, 1 + n // hop, n_mels) and out.is_contiguous()
    plain = mel_kernel.mel_power_folded_plain(y, sr, n_mels, n_fft, hop)
    scale = plain.abs().amax(dim=(1, 2), keepdim=True)
    # float32 sums in another order: ~1e-7 of each clip's peak power
    assert float(((out - plain).abs() / scale).max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("module,entry,plain", [
    (mel_kernel, "mel_power_folded", "mel_power_folded_plain"),
    (mel_unfolded, "mel_power_unfolded", "mel_power_unfolded_plain"),
])
@pytest.mark.parametrize("n_fft", [6, 482, 2050])
def test_dense_route_matches_plain_version(cuda_device, module, entry, plain, n_fft):
    """M = 3, 241 and 1025 have no FFT plan: each entry launches its dense kernel."""
    rng = np.random.default_rng(n_fft)
    y = torch.from_numpy((0.3 * rng.standard_normal((3, 16077))).astype(np.float32)).to(cuda_device)
    before, dense_before = module.counter.launches, module.counter_dense.launches
    out = getattr(module, entry)(y, n_fft=n_fft)
    torch.cuda.synchronize()
    assert module.counter.launches == before + 1 and module.counter_dense.launches == dense_before + 1
    ref = getattr(module, plain)(y, n_fft=n_fft)
    scale = ref.abs().amax(dim=(1, 2), keepdim=True)
    assert out.shape == (3, 1 + 16077 // 160, 40)
    assert float(((out - ref).abs() / scale).max()) <= 1e-6


@pytest.mark.cuda
def test_mel_feature_on_the_card_meets_the_golden_gate(cuda_device):
    rng = np.random.default_rng(5)
    t = np.arange(80000) / 16000
    y = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(80000)).astype(np.float32)
    lengths = torch.tensor([80000, 30001], device=cuda_device)
    batch = np.stack([y, np.r_[y[:30001], np.zeros(80000 - 30001, np.float32)]])
    dense_before = mel_kernel.counter_dense.launches
    feat = mel_kernel.mel_spec_feature(torch.from_numpy(batch).to(cuda_device), lengths=lengths).cpu().numpy()
    assert mel_kernel.counter_dense.launches == dense_before  # through csrc/mel_rfft.cu
    assert np.max(np.abs(feat[0] - golden.mel_spec_feature(y))) <= 1e-5
    assert np.max(np.abs(feat[1, :, : 1 + 30001 // 160] - golden.mel_spec_feature(y[:30001]))) <= 1e-5


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda_device):
    y = torch.zeros((2, 4000), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        mel_kernel.mel_power_folded(y)
    with pytest.raises(ValueError):
        mel_kernel.mel_power_folded(torch.zeros((4000, 2), device=cuda_device).T)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,sr,n_fft,hop,n_mels", [
    (4, 80000, 16000, 512, 160, 40), (1, 32000, 16000, 512, 160, 40),
    (3, 16077, 16000, 512, 160, 40), (2, 66150, 22050, 1024, 512, 128), (2, 80000, 16000, 400, 160, 40),
    (3, 16077, 16000, 480, 160, 40), (2, 66150, 22050, 2048, 512, 128),
])
def test_mel_unfolded_matches_plain_version(cuda_device, batch, n, sr, n_fft, hop, n_mels):
    """The FFT sizes go to csrc/mel_rfft.cu, as for the folded entry."""
    rng = np.random.default_rng(batch * 100003 + n)
    y = torch.from_numpy((0.3 * rng.standard_normal((batch, n))).astype(np.float32)).to(cuda_device)
    before, dense_before = mel_unfolded.counter.launches, mel_unfolded.counter_dense.launches
    out = mel_unfolded.mel_power_unfolded(y, sr, n_mels, n_fft, hop)
    torch.cuda.synchronize()
    assert mel_unfolded.counter.launches == before + 1
    assert mel_unfolded.counter_dense.launches == dense_before  # the FFT route, not the dense kernel
    assert out.shape == (batch, 1 + n // hop, n_mels) and out.is_contiguous()
    plain = mel_unfolded.mel_power_unfolded_plain(y, sr, n_mels, n_fft, hop)
    scale = plain.abs().amax(dim=(1, 2), keepdim=True)
    # float32 sums in another order: ~1e-7 of each clip's peak power
    assert float(((out - plain).abs() / scale).max()) <= 1e-6


@pytest.mark.cuda
def test_mel_unfolded_raises_instead_of_falling_back(cuda_device):
    with pytest.raises(ValueError, match="even n_fft"):
        mel_unfolded.mel_power_unfolded(torch.zeros((2, 4000), device=cuda_device), n_fft=511)
    with pytest.raises(TypeError):
        mel_unfolded.mel_power_unfolded(torch.zeros((2, 4000), dtype=torch.float64, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,sr,n_fft,hop,n_mels", [
    (2, 66150, 22050, 1024, 512, 128), (3, 16077, 16000, 512, 160, 40), (2, 80000, 16000, 400, 160, 40),
    (3, 16077, 16000, 480, 160, 40), (2, 66150, 22050, 2048, 512, 128), (2, 66150, 22050, 2048, 1024, 128),
    (3, 16077, 16000, 482, 160, 40), (2, 66150, 22050, 2050, 512, 128), (2, 44100, 22050, 4096, 1024, 128),
])
def test_mel_folded_float64_instantiation_matches_plain_version(cuda_device, batch, n, sr, n_fft, hop, n_mels):
    """precise=True launches the routed kernel's float64 instantiation
    (mel_rfft.cu's on its sizes, mel_folded.cu's elsewhere; at n_fft 2048,
    hop 1024 the FFT kernel's tiles shrink to fit); the plain version's
    products run in float64 too, so the two meet at float32 rounding of the
    result."""
    rng = np.random.default_rng(batch * 7919 + n)
    y = torch.from_numpy((0.3 * rng.standard_normal((batch, n))).astype(np.float32)).to(cuda_device)
    before, f64_before = mel_kernel.counter.launches, mel_kernel.counter_f64.launches
    dense_before = mel_kernel.counter_dense.launches
    out = mel_kernel.mel_power_folded(y, sr, n_mels, n_fft, hop, precise=True)
    torch.cuda.synchronize()
    assert mel_kernel.counter.launches == before + 1 and mel_kernel.counter_f64.launches == f64_before + 1
    assert mel_kernel.counter_dense.launches == dense_before + (mel_kernel.route(n_fft) == "dense")
    plain = mel_kernel.mel_power_folded_plain(y, sr, n_mels, n_fft, hop)
    assert float(((out - plain).abs() / plain.abs().clamp_min(1e-30)).max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [511, 401])
def test_mel_feature_at_odd_n_fft_on_the_card(cuda_device, n_fft):
    """Odd n_fft has no fold: the framed basis product (torch ops), one frame
    fewer than n_frames_for, no kernel launch, within 1e-5 of golden."""
    rng = np.random.default_rng(n_fft)
    y = (0.3 * rng.standard_normal((2, 16000))).astype(np.float32)
    before = mel_kernel.counter.launches
    feat = mel_kernel.mel_spec_feature(torch.from_numpy(y).to(cuda_device), n_fft=n_fft).cpu().numpy()
    assert mel_kernel.counter.launches == before and feat.shape == (2, 40, 100)
    for i in range(2):
        assert np.max(np.abs(feat[i] - golden.mel_spec_feature(y[i], n_fft=n_fft))) <= 1e-5


@pytest.mark.cuda
def test_mfcc_and_classical_features_on_the_card_with_tf32_allowed(cuda_device):
    """The MFCC and classical features meet their golden gates on the card
    whatever the TF32 flags say, and leave the flags as they were."""
    from audio_edge_ml_pipeline_torch.ops import audio_features

    rng = np.random.default_rng(11)
    t = np.arange(66150) / 22050
    y = np.stack([(0.5 * np.sin(2 * np.pi * (220 + 97 * i) * t) + 0.05 * rng.standard_normal(66150))
                  for i in range(3)]).astype(np.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yd = torch.from_numpy(y).to(cuda_device)
        seq = audio_features.mfcc_seq_feature(yd).cpu().numpy()
        vec = audio_features.classical_feature_vector(yd).cpu().numpy()
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for i in range(3):
        assert np.max(np.abs(seq[i] - golden.mfcc_seq_feature(y[i].astype(np.float64)))) <= 1e-5
        gold = golden.classical_feature_vector(y[i].astype(np.float64))
        assert np.max(np.abs(vec[i] - gold) / np.maximum(np.abs(gold), 1.0)) <= 1e-4


def _blobs(n_classes=6, per_class=40, dim=32, seed=3):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((n_classes, dim)) * 1.2
    y = np.repeat(np.arange(n_classes), per_class).astype(np.int32)
    X = (means[y] + rng.standard_normal((len(y), dim))).astype(np.float32)
    return X, y


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_svm_solve_captured_equals_eager_on_the_card(cuda_device, kernel):
    """The APG loop replayed from a CUDA graph launches the eager loop's
    kernels: the same result bit for bit; and after 400 steps (as the CPU
    tests hold the port to JAX) within 1e-4 of max(u) of the CPU's (float32
    sums in other orders)."""
    from audio_edge_ml_pipeline_torch.models import classical_core as cc

    X, y = _blobs()
    gamma, _, idx, ypm, u = cc.svm_problem(X, y, 6, 1.0)
    args = [torch.from_numpy(a) for a in (X, idx.astype(np.int64), ypm, u)]
    card = [a.to(cuda_device) for a in args]
    eager = [t.cpu() for t in cc.svm_fit(*card, gamma, kernel, 400, capture=False)]
    captured = [t.cpu() for t in cc.svm_fit(*card, gamma, kernel, 400)]   # captured by default on a card
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))
    on_cpu = cc.svm_fit(*args, gamma, kernel, 400)
    assert float((captured[0] - on_cpu[0]).abs().max()) <= 1e-4 * float(u.max())


@pytest.mark.cuda
def test_classical_core_on_the_card_matches_the_cpu_with_tf32_allowed(cuda_device):
    """svm, LDA, PCA, kNN and k-means fits on the card against the CPU with
    both TF32 flags on: the core pins full float32 itself and leaves the
    flags as they were."""
    from audio_edge_ml_pipeline_torch.models import classical as tcl
    from audio_edge_ml_pipeline_torch.models import classical_core as cc

    X, y = _blobs(27, 30, 64, seed=11)
    Xq = X[::3] + np.float32(0.1)

    def fits(dev):
        svm = cc.fit_svm_np(X, y, 27, C=10.0, iters=400, device=dev)
        pca = cc.fit_scaler_pca_np(X, 12, dev)
        centres, inertia = tcl.KMeansTrainer(n_init=4, device=dev)._lloyd(X, 27)
        return {"dec": cc.svm_decision_np(Xq, svm, dev), "pred": cc.predict_svm_np(Xq, svm, dev),
                "lda": cc.fit_lda_np(X, y, 27, dev)["lda_coef"], "Z": cc.transform_scaler_pca_np(Xq, pca, dev),
                "knn": tcl._knn_counts(Xq, X, y, 5, 27, "minkowski", torch.device(dev)),
                "centres": centres, "inertia": np.float32(inertia)}

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        card = fits(cuda_device)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    cpu = fits("cpu")
    for key, tol in (("dec", 1e-4), ("lda", 1e-4), ("Z", 1e-4), ("centres", 1e-4), ("inertia", 1e-5)):
        assert np.abs(card[key] - cpu[key]).max() <= tol * np.abs(cpu[key]).max(), key
    np.testing.assert_array_equal(card["pred"], cpu["pred"])
    np.testing.assert_array_equal(card["knn"], cpu["knn"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["svm", "lda", "knn", "kmeans", "pca_svm", "pca_lda", "pca_knn"])
def test_classical_bundle_fitted_on_the_card_serves_on_the_cpu(cuda_device, tmp_path, name):
    from audio_edge_ml_pipeline_torch.models import get_model

    X, y = _blobs()
    kw = {"svm": {"iters": 200}, "pca_svm": {"n_components": 8, "iters": 200}, "pca_lda": {"n_components": 8},
          "pca_knn": {"n_components": 8}, "kmeans": {"n_init": 3}}.get(name, {})
    trainer = get_model(name)(**kw, device=cuda_device)
    trainer.fit(X, y, X[::4], y[::4], list("abcdef"), name, tmp_path, None)
    on_cpu = get_model(name).load(tmp_path / f"{name}.npz", device="cpu")
    np.testing.assert_array_equal(on_cpu.predict(X), trainer.predict(X))


def _cv_problem(cuda_device, X, y, n_folds=4):
    """The fold-batched svm CV inputs of a C = 1 cell, on the CPU and on the card."""
    from audio_edge_ml_pipeline_torch.train import search_cv as sc

    fold_of = sc.stratified_fold_ids(y, n_folds, seed=0)
    _, idx, ypm, cw = sc._fold_ovo_arrays(y, fold_of, int(y.max()) + 1)
    W = np.stack([fold_of != f for f in range(n_folds)]).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (X, W, idx.astype(np.int64), ypm, cw)]
    return cpu, [a.to(cuda_device) for a in cpu]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,iters", [("rbf", 400), ("linear", 2000)])
def test_fold_batched_svm_cv_on_the_card(cuda_device, kernel, iters):
    """svm_cv (F folds x P pairs as one batch of QPs) on the card: captured
    equals eager bit for bit, and the decision values of all rows and folds
    are within 1e-4 of their largest of the CPU's, with both TF32 flags on.
    The linear kernel runs 2000 steps: after 400 its dual is far from
    converged, and a 1e-7 relative change of the input moves the CPU's own
    decisions by up to 4.1e-5 of their largest on these rows (1.4e-4 on
    tests/test_search_jax.py's; 2.8e-6 after 2000; the rbf kernel's 2.3e-6
    after 400: scripts/torch_tune_sensitivity.py)."""
    from audio_edge_ml_pipeline_torch.models import classical_core as cc

    X, y = _blobs()
    cpu, card = _cv_problem(cuda_device, X, y)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        eager = cc.svm_cv(*card, 0.0, kernel, "scale", iters, capture=False).cpu()
        captured = cc.svm_cv(*card, 0.0, kernel, "scale", iters).cpu()   # captured by default on a card
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert torch.equal(eager, captured)
    on_cpu = cc.svm_cv(*cpu, 0.0, kernel, "scale", iters)
    assert captured.shape == on_cpu.shape == (4, len(X), 15)
    assert float((captured - on_cpu).abs().max()) <= 1e-4 * float(on_cpu.abs().max())


@pytest.mark.cuda
def test_pca_lda_knn_cv_on_the_card(cuda_device):
    from audio_edge_ml_pipeline_torch.models import classical_core as cc

    X, y = _blobs(27, 30, 64, seed=11)
    cpu, card = _cv_problem(cuda_device, X, y, n_folds=5)
    onehot = torch.eye(27)[torch.from_numpy(y).long()]
    out = {}
    for name, (Xd, W) in (("cpu", cpu[:2]), ("card", card[:2])):
        Z = cc.pca_cv(Xd, W, 12)
        oh = onehot.to(Z.device)
        out[name] = [t.cpu() for t in (cc.lda_cv(Z, oh, W), cc.knn_cv(Z, W, oh, 5, "minkowski"), Z)]
    (lda_cpu, knn_cpu, Z_cpu), (lda_card, knn_card, Z_card) = out["cpu"], out["card"]
    assert float((lda_card - lda_cpu).abs().max()) <= 1e-4 * float(lda_cpu.abs().max())
    sign = torch.sign((Z_card * Z_cpu).sum(1, keepdim=True))
    assert float((Z_card * sign - Z_cpu).abs().max()) <= 1e-4 * float(Z_cpu.abs().max())
    assert torch.equal(knn_card, knn_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn", "mlp", "rnn"])
def test_batched_trial_group_on_the_card_matches_the_cpu(cuda_device, name):
    """One epoch of a group of 3 trials (three learning rates, dropout 0,
    the same seeded init and batches) on the card and on the CPU, in
    float64: epoch losses within 1e-5 and parameters within 1e-4 of each
    tensor's largest, relative. (In float32 Adam lifts roundoff on
    near-zero gradients to whole steps: an epoch then differs from itself
    by more than that under a 1e-7 change of its input.)"""
    from audio_edge_ml_pipeline_torch.train import tune_batched as tb

    archs = {"cnn": {"type": "cnn", "filters": [16, 64, 64], "dropout": 0.0, "n_classes": 27, "first_stride": 4,
                     "second_stride": 2, "input_shape": [40, 501, 1]},
             "mlp": {"type": "mlp", "hidden_units": [256, 128], "dropout": 0.0, "n_classes": 27, "input_shape": [302]},
             "rnn": {"type": "rnn", "units": 32, "n_layers": 1, "dropout": 0.0, "n_classes": 27,
                     "input_shape": [40, 216]}}
    arch = archs[name]
    rng = np.random.default_rng(0)
    X = rng.standard_normal((128, *arch["input_shape"]))
    y = rng.integers(0, 27, 128)
    idx_mat = rng.permutation(128).reshape(4, 32)
    states = tb.init_states(arch, 3, seed=0)
    lrs = [1e-3, 3e-3, 1e-2]
    groups, losses = {}, {}
    for dev in ("cpu", cuda_device):
        g = tb.TrialGroup(arch, states, lrs, [0.0] * 3, dev, torch.float64, noise_seeds=range(3))
        losses[str(dev)] = g.epoch(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), idx_mat).cpu()
        groups[str(dev)] = g
    card, cpu = groups[str(cuda_device)], groups["cpu"]
    assert float(((losses[str(cuda_device)] - losses["cpu"]).abs() / losses["cpu"].abs()).max()) <= 1e-5
    for key, p in cpu.params.items():
        ref = p.detach()
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((card.params[key].detach().cpu() - ref).abs().max()) <= 1e-4 * scale, key


@pytest.mark.cuda
def test_optimize_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """Every mode of a small cnn bundle built with its view on the card and
    on the CPU: the same artifacts (the arithmetic is numpy on the host) and
    view probabilities within 1e-4 (float32 convolutions in other orders)."""
    from audio_edge_ml_pipeline_torch.models.deep import CNNTrainer
    from audio_edge_ml_pipeline_torch.optimize import quantize as tq

    seeded = CNNTrainer(filters=[8, 16], first_stride=2, device="cpu")
    seeded.initialize((16, 51, 1), 3, torch.Generator().manual_seed(0))
    bundle = tmp_path / "model.flax.npz"
    seeded.save(bundle)
    X = np.random.default_rng(0).random((24, 16, 51), dtype=np.float32)
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for mode in ("fp32", *tq.DEEP_MODES):
            built = {}
            for dev in ("cpu", cuda_device):
                out_dir = tmp_path / dev.type if isinstance(dev, torch.device) else tmp_path / dev
                out_dir.mkdir(exist_ok=True)
                trainer = tq.load_trainer_any(bundle, "cnn", device=dev)
                view, art, size_kb = tq.build_mode(trainer, bundle, mode, out_dir, X)
                built[str(dev)] = (view.predict_proba(X), art, size_kb, view)
            (p_cpu, a_cpu, s_cpu, _), (p_card, a_card, s_card, v_card) = built["cpu"], built[str(cuda_device)]
            inner = getattr(v_card, "_inner", v_card)
            assert inner.device.type == "cuda", mode
            assert s_cpu == s_card
            d_cpu, d_card = np.load(a_cpu), np.load(a_card)
            assert sorted(d_cpu.files) == sorted(d_card.files)
            for k in d_cpu.files:
                assert d_cpu[k].dtype == d_card[k].dtype
                np.testing.assert_array_equal(d_cpu[k], d_card[k], err_msg=f"{mode} {k}")
            assert float(np.abs(p_card - p_cpu).max()) <= 1e-4, mode
    finally:
        torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
def test_cqt_on_the_card_matches_the_cpu_and_golden(cuda_device):
    """audio_cqt's float64 products on the card: the feature within 1e-6 of
    the CPU's and 1e-5 of golden, with TF32 allowed (no float32 product is
    on the path); a clip alone equals it inside the batch."""
    from audio_edge_ml_pipeline_torch.ops import dsp

    rng = np.random.default_rng(12)
    t = np.arange(3 * 22050) / 22050
    y = np.stack([0.5 * np.sin(2 * np.pi * (110 + 150 * i) * (1 + 0.1 * t) * t) + 0.02 * rng.standard_normal(len(t))
                  for i in range(5)]).astype(np.float32)
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = dsp.cqt_feature(torch.from_numpy(y).to(cuda_device)).cpu().numpy()
        alone = dsp.cqt_feature(torch.from_numpy(y[2:3]).to(cuda_device)).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    cpu = dsp.cqt_feature(torch.from_numpy(y)).numpy()
    assert card.shape == (5, 84, 1 + y.shape[1] // 512)
    assert float(np.abs(card - cpu).max()) <= 1e-6
    assert float(np.abs(card[2] - alone[0]).max()) <= 1e-6
    for i in (0, 4):
        assert float(np.abs(card[i] - golden.cqt_feature(y[i].astype(np.float64))).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cell,block", [(128, 128, (8, 8), (2, 2)), (96, 80, (16, 8), (1, 2))])
def test_image_descriptors_on_the_card_match_the_numpy_oracle(cuda_device, h, w, cell, block):
    """ops/imgdsp.py on the card: LBP and the gray histogram bit for bit,
    HOG within 1e-5, the whole vector within 2e-4 of the numpy oracle."""
    from audio_edge_ml_pipeline_torch.features import image
    from audio_edge_ml_pipeline_torch.ops import imgdsp

    rng = np.random.default_rng(h + w)
    imgs = np.stack([rng.random((h, w), dtype=np.float32), np.full((h, w), 0.5, np.float32),
                     (np.kron(rng.random((h // 8, w // 8)) > 0.5, np.ones((8, 8))) * 0.8 + 0.1).astype(np.float32),
                     np.clip(rng.normal(0.5, 0.2, (h, w)), 0, 1).astype(np.float32)])
    out = imgdsp.classical_image_vector_batch(torch.from_numpy(imgs).to(cuda_device), cell=cell,
                                              block=block).cpu().numpy()
    n_hog = out.shape[1] - 96
    for i, g in enumerate(imgs):
        ref = image.classical_image_vector(g, cell=cell, block=block)
        np.testing.assert_array_equal(out[i, n_hog : n_hog + 90], ref[n_hog : n_hog + 90])
        assert float(np.abs(out[i, :n_hog] - ref[:n_hog]).max()) <= 1e-5
        assert float(np.abs(out[i] - ref).max()) <= 2e-4


@pytest.mark.cuda
def test_mobilenet_embedder_on_the_card_matches_the_cpu(cuda_device):
    """The frozen MobileNetV2 at 224 on the card against the CPU, the same
    seeded init, cuDNN in full float32: within 1e-4 of the largest."""
    from audio_edge_ml_pipeline_torch.models.backbones import mobilenet_v2_embedder

    x = np.random.default_rng(1).uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            card = mobilenet_v2_embedder(224, device=cuda_device)(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
            cpu = mobilenet_v2_embedder(224, device="cpu")(torch.from_numpy(x)).numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    assert card.shape == (2, 1280)
    assert float(np.abs(card - cpu).max()) <= 1e-4 * float(np.abs(cpu).max())


@pytest.mark.cuda
def test_compile_stage_candidates_match_the_eager_forward(cuda_device, tmp_path):
    """compile_xla's CUDA graph and each torch.compile candidate of its
    --tune-flags search give the eager forward's logits (TF32 off), on a
    seeded flagship-width cnn bundle."""
    from audio_edge_ml_pipeline_torch.compilation import compile_xla
    from audio_edge_ml_pipeline_torch.features.base import FeatureSet
    from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
    from audio_edge_ml_pipeline_torch.models.deep import CNNTrainer

    trainer = CNNTrainer(filters=[16, 64, 64], first_stride=4, second_stride=2, device="cpu")
    trainer.initialize((40, 501, 1), 27, torch.Generator().manual_seed(0))
    trainer.save(tmp_path / "model.flax.npz")
    X = np.random.default_rng(2).random((40, 40, 501), dtype=np.float32)
    FeaturePipeline.save(FeatureSet(features=X, feature_type="audio_mel_spec", modality="audio",
                                    metadata=[{} for _ in X], labels=np.arange(40) % 27,
                                    label_names=[str(i) for i in range(27)]), tmp_path / "feats")
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, forward, xb = compile_xla.load_forward(tmp_path / "model.flax.npz", tmp_path / "feats", 32, cuda_device)
        eager = forward(xb).clone()
        compile_xla.capture_graph(forward, xb)()   # one captured and dropped, as the CLI's plain run leaves it
        graph = compile_xla.capture_graph(forward, xb)
        assert float((graph() - eager).abs().max()) <= 1e-5
        _, record = compile_xla.flag_search(forward, xb, len(xb))
        # replayed after the reduce-overhead candidate cleared cuBLAS's workspaces while it recorded
        assert float((graph() - eager).abs().max()) <= 1e-5
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    assert [c["flags"].get("mode", c["flags"]["backend"]) for c in record["candidates"]] == \
        ["eager", "cuda_graph", "default", "reduce-overhead"]
    for c in record["candidates"]:
        assert "error" not in c, c
        assert c["max_abs_diff_vs_eager"] <= 1e-5 and c["latency_ms_per_sample"] > 0


@pytest.mark.cuda
def test_audio_processor_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The ingestion preprocessor's .npy files on the card against the CPU
    within 1e-5, through the native WAV reader."""
    from audio_edge_ml_pipeline_torch.data import native_wavio
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav
    from audio_edge_ml_pipeline_torch.serve.audio_processor import AudioPreprocessor

    rng = np.random.default_rng(8)
    (tmp_path / "in").mkdir()
    for i in range(3):
        write_wav(tmp_path / "in" / f"{i}.wav", (0.3 * rng.standard_normal(80000 - 1000 * i)).astype(np.float32), 16000)
    assert native_wavio.available()
    before = mel_kernel.counter.launches
    assert AudioPreprocessor(device=cuda_device).process_dataset(tmp_path / "in", tmp_path / "card") == 3
    assert mel_kernel.counter.launches == before + 3
    assert AudioPreprocessor(device="cpu").process_dataset(tmp_path / "in", tmp_path / "cpu") == 3
    for i in range(3):
        card, cpu = np.load(tmp_path / "card" / f"{i}.npy"), np.load(tmp_path / "cpu" / f"{i}.npy")
        assert card.shape == (40, 501) and float(np.abs(card - cpu).max()) <= 1e-5


def _zipf_docs(seed: int, n_docs: int = 240, vocab: int = 3000) -> tuple[list[str], list[str]]:
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}q" for i in range(vocab)])
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    docs = [" ".join(rng.choice(words, int(rng.integers(20, 120)), p=p / p.sum())) + f" topic{i % 6}"
            for i in range(n_docs)]
    return docs, [f"c{i % 6}" for i in range(n_docs)]


@pytest.mark.cuda
def test_tfidf_weighting_and_lsa_on_the_card_match_the_cpu(cuda_device):
    """ops/textops.py and ops/lsa.py: the TF-IDF rows within 1e-12 in
    float64, the randomized SVD's singular values and rows within 1e-8, each
    tensor on the card."""
    from audio_edge_ml_pipeline_torch.features.vectorize import TfidfVectorizer
    from audio_edge_ml_pipeline_torch.ops.lsa import truncated_svd

    docs, _ = _zipf_docs(1)
    rows = {}
    for dev in (cuda_device, torch.device("cpu")):
        vec = TfidfVectorizer(max_features=2000, ngram_range=(1, 2), sublinear_tf=True, device=dev)
        x = vec.fit_transform(docs, dtype=torch.float64)
        assert x.device.type == vec.idf_.device.type == dev.type
        svd, out = truncated_svd(x, 60)
        assert svd.components.device.type == out.device.type == dev.type
        rows[dev.type] = (x.cpu(), svd.singular_values.cpu(), out.cpu())
    (x_card, s_card, r_card), (x_cpu, s_cpu, r_cpu) = rows["cuda"], rows["cpu"]
    assert float((x_card - x_cpu).abs().max()) <= 1e-12
    assert float(((s_card - s_cpu).abs() / s_cpu).max()) <= 1e-8
    assert float((r_card - r_cpu).abs().max()) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["text_tfidf", "text_bow", "text_char_ngram", "text_sentence_embed",
                                  "text_bert_tokens"])
def test_text_extractors_on_the_card_match_the_cpu(cuda_device, name):
    """bow and token ids equal, tfidf and char rows within 1e-7, LSA rows
    within 1e-5, the same vocabulary."""
    from audio_edge_ml_pipeline_torch import features

    docs, labels = _zipf_docs(2)
    loader = [(None, labels[i], {"text": d}) for i, d in enumerate(docs)]
    card, cpu = features.get(name)(device=cuda_device), features.get(name)(device="cpu")
    fs_card, fs_cpu = card.extract_dataset(loader), cpu.extract_dataset(loader)
    assert fs_card.features.shape == fs_cpu.features.shape and list(fs_card.labels) == list(fs_cpu.labels)
    gap = float(np.abs(fs_card.features.astype(np.float64) - fs_cpu.features).max())
    assert gap <= {"text_bow": 0.0, "text_bert_tokens": 0.0, "text_sentence_embed": 1e-5}.get(name, 1e-7)
    if name in ("text_tfidf", "text_bow", "text_char_ngram"):
        assert card._vectorizer.vocabulary_ == cpu._vectorizer.vocabulary_
        assert card._vectorizer.device.type == "cuda"
    if name == "text_sentence_embed":
        assert card._lsa[1].components.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tabular_classical", "tabular_polynomial"])
@pytest.mark.parametrize("scaler", ["standard", "minmax", "robust"])
def test_tabular_extractors_on_the_card_match_the_cpu(cuda_device, name, scaler):
    """Within 1e-6 of each column's largest value, the statistics on the
    card."""
    from audio_edge_ml_pipeline_torch import features

    rng = np.random.default_rng(3)
    loader = []
    for i in range(500):
        row = {"age": int(rng.integers(17, 90)), "hours": float(rng.normal(40, 12)), "gain": float(rng.lognormal(8, 1)),
               "work": str(rng.choice(["private", "state", "self"])), "sex": str(rng.choice(["f", "m"]))}
        if i % 7 == 0:
            row["hours"] = float("nan")
        if i % 11 == 0:
            row["work"] = float("nan")
        loader.append((None, f"c{i % 2}", row))
    card = features.get(name)(scaler=scaler, device=cuda_device)
    cpu = features.get(name)(scaler=scaler, device="cpu")
    fs_card, fs_cpu = card.extract_dataset(loader), cpu.extract_dataset(loader)
    assert card._transformer.num_imputer.statistics_.device.type == "cuda"
    assert card._transformer.scaler.scale_.device.type == "cuda"
    scale = np.abs(fs_cpu.features).max(axis=0)
    gap = np.abs(fs_card.features - fs_cpu.features) / np.where(scale > 0, scale, 1.0)
    assert fs_card.features.shape == fs_cpu.features.shape and float(gap.max()) <= 1e-6


# -- the parallel layer (NCCL tests need 2 cards; gloo shares one) ---------------


@pytest.fixture()
def two_cards(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards: NCCL refuses two ranks on one card")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _svm_problem(device, seed=0):
    from audio_edge_ml_pipeline_torch.models import classical_core as cc

    r = np.random.default_rng(seed)
    X = np.concatenate([r.standard_normal((30, 6)) + k for k in range(3)]).astype(np.float32)
    y = np.repeat(np.arange(3), 30)
    gamma, _, idx, ypm, u = cc.svm_problem(X, y, 3, 1.0)
    args = [torch.from_numpy(a).to(device) for a in (X, idx.astype(np.int64), ypm, u)]
    return cc, args, gamma


@pytest.mark.cuda
def test_captured_solve_on_a_card_that_is_not_current_equals_the_current_card(two_cards):
    cc, args0, gamma = _svm_problem(two_cards[0])
    torch.cuda.set_device(two_cards[0])
    ref = [t.cpu() for t in cc.svm_fit(*args0, gamma, "rbf", 100, capture=True)]
    args1 = [a.to(two_cards[1]) for a in args0]
    out = cc.svm_fit(*args1, gamma, "rbf", 100, capture=True)
    torch.cuda.synchronize(two_cards[1])
    assert all(t.device == two_cards[1] for t in out)
    for a, b in zip(out, ref):
        assert float((a.cpu() - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
def test_captured_solve_uses_the_streams_of_its_tensors_card(cuda_device, monkeypatch):
    """One card: the current device pinned, every stream the capture makes
    or waits on is the tensors' card's."""
    cc, args, gamma = _svm_problem(torch.device("cuda", 0))
    torch.cuda.set_device(0)
    made, captures, real, real_graph = [], [], torch.cuda.Stream, torch.cuda.graph

    def stream(*a, **kw):
        s = real(*a, **kw)
        made.append(s.device)
        return s

    def graph(g, *a, stream=None, **kw):
        captures.append(None if stream is None else stream.device)
        return real_graph(g, *a, stream=stream, **kw)

    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    eager = [t.cpu() for t in cc.svm_fit(*args, gamma, "rbf", 50, capture=False)]
    captured = [t.cpu() for t in cc.svm_fit(*args, gamma, "rbf", 50, capture=True)]
    assert made and all(d == args[0].device for d in made)
    assert captures == [args[0].device]   # captured on a stream of the tensors' card, not torch's default one
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


@pytest.mark.cuda
def test_two_gloo_ranks_sharing_a_card_fit_as_one_process(cuda_device, tmp_path):
    from audio_edge_ml_pipeline_torch.models import get_model

    r = np.random.default_rng(1)
    y = (np.arange(48) % 3).astype(np.int32)
    X = r.uniform(0, 0.4, (48, 12, 16)).astype(np.float32)
    for c in range(3):
        X[y == c, c * 3 : c * 3 + 3] += 0.5
    kw = dict(filters=[4, 8], epochs=2, batch_size=8, seed=1, dropout=0.0, device="cuda:0")
    one = get_model("ds_cnn")(**kw)
    one.fit(X[:40], y[:40], X[40:], y[40:], list("abc"), "one", tmp_path / "one", None)
    two = get_model("ds_cnn")(**kw, data_parallel=2, data_parallel_devices=["cuda:0", "cuda:0"],
                              data_parallel_backend="gloo")
    two.fit(X[:40], y[:40], X[40:], y[40:], list("abc"), "two", tmp_path / "two", None)
    s1, s2 = one._net.state_dict(), two._net.state_dict()
    for k in s1:
        assert float((s2[k] - s1[k]).abs().max()) <= 1e-4 * max(float(s1[k].abs().max()), 1e-30), k


@pytest.mark.cuda
def test_extraction_split_on_one_card_equals_one_call(cuda_device):
    from audio_edge_ml_pipeline_torch.features import get

    x = (0.3 * np.random.default_rng(2).standard_normal((5, 16000))).astype(np.float32)
    before = mel_kernel.counter.launches
    split = get("audio_mel_spec")(duration=1.0, devices=["cuda:0", "cuda:0"])._device_batch(x, None)
    assert mel_kernel.counter.launches == before + 2   # one launch a part
    np.testing.assert_array_equal(split, get("audio_mel_spec")(duration=1.0, device="cuda:0")._device_batch(x, None))


@pytest.mark.cuda
def test_data_parallel_fit_over_two_cards_equals_one_card(two_cards, tmp_path):
    from audio_edge_ml_pipeline_torch.models import get_model

    r = np.random.default_rng(4)
    y = (np.arange(48) % 3).astype(np.int32)
    X = r.uniform(0, 0.4, (48, 12, 16)).astype(np.float32)
    kw = dict(filters=[4, 8], first_stride=2, epochs=2, batch_size=8, seed=1, dropout=0.0, device="cuda:0")
    one = get_model("cnn")(**kw)
    one.fit(X[:40], y[:40], X[40:], y[40:], list("abc"), "one", tmp_path / "one", None)
    two = get_model("cnn")(**kw, data_parallel=2)
    two.fit(X[:40], y[:40], X[40:], y[40:], list("abc"), "two", tmp_path / "two", None)
    s1, s2 = one._net.state_dict(), two._net.state_dict()
    for k in s1:
        assert float((s2[k] - s1[k]).abs().max()) <= 1e-4 * max(float(s1[k].abs().max()), 1e-30), k


@pytest.mark.cuda
def test_splits_over_two_cards_equal_one_card(two_cards):
    from audio_edge_ml_pipeline_torch.features import get
    from audio_edge_ml_pipeline_torch.train import search_cv, tune_batched

    r = np.random.default_rng(0)
    Xc = np.concatenate([r.standard_normal((24, 8)) + k for k in range(4)]).astype(np.float32)
    yc = np.repeat(np.arange(4), 24).astype(np.int32)
    fold_of = search_cv.stratified_fold_ids(yc, 4, seed=0)
    one = search_cv._CVEngine(Xc, yc, fold_of, 4, device=two_cards[0])
    split = search_cv._CVEngine(Xc, yc, fold_of, 4, device=two_cards[0], devices=2)
    assert [p.device for p in split.parts] == two_cards
    d1, d2 = one.svm_decisions({"C": 1.0}), split.svm_decisions({"C": 1.0})
    assert float(np.abs(d2 - d1).max() / np.abs(d1).max()) <= 1e-4
    Xd = r.standard_normal((64, 16, 8)).astype(np.float32)
    yd = (np.arange(64) % 4).astype(np.int32)
    draws = [{"filters": [4], "batch_size": 16, "learning_rate": 1e-3 * (i + 1), "dropout": 0.1} for i in range(4)]
    whole = tune_batched.train_trial_group("cnn", draws, Xd, yd, Xd[:16], yd[:16], 4, 1, seed=0, device=two_cards[0])
    parts = tune_batched.train_trial_group("cnn", draws, Xd, yd, Xd[:16], yd[:16], 4, 1, seed=0, device=two_cards[0],
                                           devices=2)
    assert [t["history"] for t in parts] == [t["history"] for t in whole]
    x = (0.3 * r.standard_normal((6, 16000))).astype(np.float32)
    np.testing.assert_array_equal(get("audio_mel_spec")(duration=1.0)._device_batch(x, None),
                                  get("audio_mel_spec")(duration=1.0, device="cuda:0")._device_batch(x, None))


@pytest.mark.cuda
def test_dryrun_multichip_on_two_cards(two_cards):
    from audio_edge_ml_pipeline_torch.entry import dryrun_multichip

    assert dryrun_multichip(2).startswith("dryrun_multichip OK: mesh=(1 data x 2 model) on cuda (nccl)")
