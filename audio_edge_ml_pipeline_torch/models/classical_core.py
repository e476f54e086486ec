"""Classical model core in PyTorch: PCA, LDA, and the one-vs-one kernel SVM.

Counterpart of the JAX package's ``models/classical_jax.py``, function by
function: the jitted ``kernels()`` namespace there becomes the plain tensor
functions below, which run where their tensors lie, and the host
orchestration (``*_np``: numpy in, numpy out) takes ``device=`` as every
entry point of the port does (the first CUDA card unless the caller passes
``device="cpu"``).

- **PCA**: standard scaling, then the N x N Gram matrix's eigendecomposition
  (``torch.linalg.eigh``, cuSOLVER on a card), largest-|loading|-positive
  component signs.
- **LDA**: class means by one-hot products, pooled within-class covariance,
  an eigendecomposition solve with the relative rank cutoff
  ``r * eps(float32) * ev_max``; for D > N - 1 the fit runs in the span of
  the centred data and the coefficients are composed back.
- **SVM**: every one-vs-one dual QP at once, as one batch: the full kernel
  matrix, per-pair Gram blocks gathered from it, ``iters`` accelerated
  projected-gradient steps with gradient restart, each with a 64-step
  bisection projection onto {0 <= a <= u, y.a = 0}; no early exit and no
  host sync inside the loop. On a card the step is captured once in a CUDA
  graph and replayed ``iters`` times (the same kernels, so the same result
  as the eager loop, which the CPU runs): an eager step is some 740 small
  launches, and the host cannot issue them as fast as the card runs them.
  Then the libsvm-style intercept, Platt sigmoids and pairwise coupling on
  the host, as in JAX.

Precision: JAX computes every product at ``Precision.HIGHEST``. Here each
tensor function runs under ``full_float32``, so its float32 products stay
full float32 whatever the caller's TF32 setting, which is restored after.
A TF32 Gram matrix would move the SVM's dual coefficients far beyond the
1e-4 the tests hold them to; float64 would change the result compared with
JAX. No hand kernel: all of this is work the JAX package leaves to XLA.

- **Cross-validation** (the tuning stage, ``train/search_cv.py``): the
  fold-batched programs ``svm_cv``, ``pca_cv``, ``lda_cv`` and ``knn_cv``
  take the folds as weight vectors ``w (F, N)`` over one resident ``X`` and
  return every row's scores for every fold. JAX's ``vmap`` over folds is a
  leading fold axis here: the SVM flattens F folds x P pairs into one batch
  of F * P QPs for ``_solve_qps`` (one captured CUDA graph a solve, not F),
  and the PCA runs one batched ``torch.linalg.eigh`` over (F, N, N).
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

BISECTION_STEPS = 64   # of the projection in every APG step, as in JAX


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products on a card in full float32 (no TF32) inside,
    whether the caller allowed TF32 with ``allow_tf32`` or with
    ``set_float32_matmul_precision``; the caller's setting is restored on
    the way out. Also a decorator.

    Through ``torch.backends.cuda.matmul.allow_tf32`` alone: its setter
    keeps the generic precision and cuBLAS's in step, where setting the
    generic one also moves the CPU's (oneDNN) setting, and torch 2.11
    then refuses to read the generic one after a later ``allow_tf32``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _tensor(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: (..., n), zero rows for indices outside [0, n).
    Unlike ``F.one_hot`` it does not check its indices, so a card does not
    wait for the host in a loop that calls it."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


# -- scaler + PCA ------------------------------------------------------------


@full_float32()
def fit_scaler_pca(X: torch.Tensor, n_components: int):
    """StandardScaler + PCA via the N x N Gram eigendecomposition.
    Returns (mean, scale, pca_mean, components[D, k])."""
    mean = X.mean(0)
    scale = X.std(0, correction=0)
    scale = torch.where(scale == 0.0, 1.0, scale)
    Xs = (X - mean) / scale
    pmean = Xs.mean(0)
    Xc = Xs - pmean
    w, U = torch.linalg.eigh(Xc @ Xc.T)   # ascending
    w = w.flip(0)[:n_components].clamp_min(0.0)
    U = U.flip(1)[:, :n_components]
    comp = (Xc.T @ U) / w.sqrt().clamp_min(1e-12)[None, :]
    # deterministic sign: the largest-|.| loading of each component > 0
    j = comp.abs().argmax(0)
    sgn = torch.sign(comp[j, torch.arange(comp.shape[1], device=comp.device)])
    return mean, scale, pmean, comp * torch.where(sgn == 0, 1.0, sgn)[None, :]


@full_float32()
def transform_scaler_pca(X, mean, scale, pmean, comp) -> torch.Tensor:
    return ((X - mean) / scale - pmean) @ comp


# -- LDA ---------------------------------------------------------------------


@full_float32()
def fit_lda(Z: torch.Tensor, y: torch.Tensor, n_classes: int):
    """Closed-form LDA: pooled within-class covariance, rank-cutoff
    eigendecomposition solve. Returns (coef[r, K], intercept[K]). A class
    absent from ``y`` keeps a zero mean row and a prior floored at 1e-12
    (finite, so quantization scales stay finite), as in JAX."""
    N = Z.shape[0]
    onehot = one_hot(y, n_classes, Z.dtype)
    counts = onehot.sum(0)
    means = (onehot.T @ Z) / counts.clamp_min(1.0)[:, None]
    Zc = Z - means[y.long()]
    Sw = (Zc.T @ Zc) / max(N - n_classes, 1)
    coef = _sw_pinv_solve(Sw, means.T)   # (r, K)
    priors = counts / N
    intercept = -0.5 * (means.T * coef).sum(0) + torch.log(priors.clamp_min(1e-12))
    return coef, intercept


def _sw_pinv_solve(Sw: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve Sw @ coef = B by eigendecomposition with the relative rank
    cutoff dim * eps(dtype) * ev_max: directions below it are dropped, not
    ridge-inflated (``classical_jax._sw_pinv_solve`` gives the reason)."""
    ev, V = torch.linalg.eigh(Sw)   # ascending; Sw (..., r, r), B (..., r, K)
    rcond = Sw.shape[-1] * torch.finfo(Sw.dtype).eps
    keep = ev > rcond * ev[..., -1:].clamp_min(1e-30)
    inv = torch.where(keep, 1.0 / ev.clamp_min(1e-30), 0.0)
    return V @ (inv[..., None] * (V.mT @ B))


@full_float32()
def linear_decision(X, coef, intercept) -> torch.Tensor:
    return X @ coef + intercept


# -- SVM ---------------------------------------------------------------------


def _pair_dist_sq(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., NA, NB) of the rows of A (..., NA, D) to
    those of B (..., NB, D), as |a|^2 - 2 a.b + |b|^2, clipped at 0."""
    sq = (A * A).sum(-1)[..., :, None] - 2.0 * (A @ B.mT) + (B * B).sum(-1)[..., None, :]
    return sq.clamp_min(0.0)


def _kernel_matrix(A: torch.Tensor, B: torch.Tensor, gamma, kind: str) -> torch.Tensor:
    """rbf or linear kernel matrix, batched over any leading axes (``gamma``
    a float, or a tensor that broadcasts against (..., NA, NB))."""
    if kind == "rbf":
        return torch.exp(-gamma * _pair_dist_sq(A, B))
    return A @ B.mT


def _clip(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, 0, u)."""
    return torch.minimum(x.clamp_min(0.0), u)


def _project(z: torch.Tensor, ypm: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Exact projection of each pair's z onto {0 <= a <= u, ypm.a = 0} by
    bisection over the hyperplane multiplier (g is monotone in it): a fixed
    BISECTION_STEPS steps, the branch a ``torch.where``."""
    span = z.abs().amax(-1) + u.amax(-1) + 1.0   # (P,)
    lo, hi = -span, span
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        g = (_clip(z - mid[:, None] * ypm, u) * ypm).sum(-1)
        pos = g > 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    lam = 0.5 * (lo + hi)
    return _clip(z - lam[:, None] * ypm, u)


def _apg_step(Q, eta, ones, ypm, u):
    """One accelerated projected-gradient step (with gradient restart) over
    every pair at once: (a, z, th) -> (a', z', th'). No host sync."""

    def step(a, z, th):
        g = torch.bmm(Q, z[:, :, None])[:, :, 0] - ones
        a_new = _project(z - eta * g, ypm, u)
        # gradient restart: momentum fighting the descent direction
        restart = (g * (a_new - a)).sum(-1) > 0.0
        th = torch.where(restart, 1.0, th)
        th_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * th * th))
        mom = ((th - 1.0) / th_new)[:, None]
        z_new = a_new + torch.where(restart[:, None], 0.0, mom * (a_new - a))
        return a_new, z_new, th_new

    return step


def _apg_eager(step, a, z, th, iters: int):
    """``iters`` steps, one launch per operation (the CPU's loop)."""
    for _ in range(iters):
        a, z, th = step(a, z, th)
    return a, z, th


def _apg_captured(step, a, z, th, iters: int):
    """``iters`` steps on a card: one step captured in a CUDA graph that
    writes its result back into its own inputs, replayed ``iters`` times.
    The same kernels on the same shapes as ``_apg_eager``. The streams and
    the capture are those of the tensors' card, whichever card is current
    (a CV fold part may live on another one)."""
    if not a.is_cuda:
        raise RuntimeError(f"the captured APG loop is a CUDA graph: its tensors are on {a.device}, not a card")
    state = [a.clone(), z.clone(), th.clone()]
    with torch.cuda.device(a.device):
        current = torch.cuda.current_stream(a.device)
        side = torch.cuda.Stream(a.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):   # warm-up outside the capture (cuBLAS workspaces); leaves state as it was
            step(*state)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # the capture on this card's stream: torch.cuda.graph's own default stream is made once, on the card
        # that was current at its first capture, and a capture there records nothing of this card's work
        with torch.cuda.graph(graph, stream=side):
            for buf, new in zip(state, step(*state)):
                buf.copy_(new)
        for _ in range(iters):
            graph.replay()
    return state


@full_float32()
def _solve_qps(Kp: torch.Tensor, ypm: torch.Tensor, u: torch.Tensor, iters: int, capture: bool | None = None):
    """Accelerated projected gradient (+ gradient restart) over a batch of
    OvO dual QPs. Kp (P, M, M); returns (alpha[P, M], b[P], f[P, M]) where
    f holds the training decision values without b. ``capture`` (default:
    on a card) runs the loop as a replayed CUDA graph."""
    Q = ypm[:, :, None] * ypm[:, None, :] * Kp
    # Lipschitz bound per pair: max row sum of |Q| >= lambda_max
    L = Q.abs().sum(-1).amax(-1)
    eta = (1.0 / L.clamp_min(1e-12))[:, None]
    ones = torch.where(u > 0, 1.0, 0.0)
    step = _apg_step(Q, eta, ones, ypm, u)
    a0 = torch.zeros_like(u)
    th0 = torch.ones(u.shape[0], dtype=u.dtype, device=u.device)
    loop = _apg_captured if (Kp.is_cuda if capture is None else capture) else _apg_eager
    alpha, _, _ = loop(step, a0, a0.clone(), th0, iters)

    # intercept: mean over free SVs, else midpoint of the KKT interval
    f = torch.bmm(Kp, (alpha * ypm)[:, :, None])[:, :, 0]   # decision w/o b
    tol = 1e-6 * u.amax(-1, keepdim=True).clamp_min(1e-12)
    valid = u > 0
    free = valid & (alpha > tol) & (alpha < u - tol)
    nfree = free.sum(-1)
    b_free = torch.where(free, ypm - f, 0.0).sum(-1) / nfree.clamp_min(1)
    lo_set = valid & (((ypm > 0) & (alpha <= tol)) | ((ypm < 0) & (alpha >= u - tol)))
    hi_set = valid & (((ypm > 0) & (alpha >= u - tol)) | ((ypm < 0) & (alpha <= tol)))
    b_lo = torch.where(lo_set, ypm - f, -torch.inf).amax(-1)
    b_hi = torch.where(hi_set, ypm - f, torch.inf).amin(-1)
    b_lo = torch.where(torch.isfinite(b_lo), b_lo, 0.0)
    b_hi = torch.where(torch.isfinite(b_hi), b_hi, 0.0)
    b = torch.where(nfree > 0, b_free, 0.5 * (b_lo + b_hi))
    return alpha, b, f


@full_float32()
def svm_fit(X, idx, ypm, u, gamma: float, kernel: str, iters: int = 500, capture: bool | None = None):
    """Solve every OvO dual QP at once. Returns (alpha[P, M], b[P], f[P, M]):
    f + b are the per-pair training decision values (Platt fitting takes
    them as they are).

    X (N, D) float32; idx (P, M) int64 sample indices (0 on padding); ypm
    (P, M) in {+1, -1, 0}; u (P, M) box upper bounds (0 on padding)."""
    Kfull = _kernel_matrix(X, X, gamma, kernel)
    Kp = Kfull[idx[:, :, None], idx[:, None, :]]   # (P, M, M)
    return _solve_qps(Kp, ypm, u, iters, capture)


@full_float32()
def svm_decision(Xq, Xsv, Asv, b, gamma: float, kernel: str) -> torch.Tensor:
    """OvO decision values (B, P): one kernel matrix against the union of
    support vectors, then a dense (Nsv, P) contraction."""
    return _kernel_matrix(Xq, Xsv, gamma, kernel) @ Asv.T + b[None, :]


# -- batched cross-validation programs (tuning stage) --------------------------


def _per_fold(X: torch.Tensor, n_folds: int) -> torch.Tensor:
    """One X (N, D) shared by every fold as a (F, N, D) view, or X as it is
    when it already has a fold axis (the pca_* feature spaces)."""
    return X.expand(n_folds, *X.shape) if X.dim() == 2 else X


def _weighted_gamma_scale(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sklearn gamma='scale' on each fold's weighted (train) rows:
    1 / (D * var(X_fold)) with the variance over all matrix entries. X (F,
    N, D), w (F, N) -> (F,)."""
    D = X.shape[-1]
    tot = (w.sum(-1) * D).clamp_min(1.0)
    mean = (X * w[..., None]).sum((-2, -1)) / tot
    var = (((X - mean[:, None, None]) ** 2) * w[..., None]).sum((-2, -1)) / tot
    return 1.0 / (D * var).clamp_min(1e-12)


@full_float32()
def svm_cv(X, w, idx, ypm, u, gamma: float, kernel: str, gamma_mode: str, iters: int,
           capture: bool | None = None) -> torch.Tensor:
    """Every fold's OvO SVM at once: solve the F x P pair QPs on each fold's
    train rows (encoded by idx / ypm / u, (F, P, M)) as one batch of F * P
    and return the decision values of ALL N rows for every fold, (F, N, P);
    the caller scores each fold's validation rows. X is (N, D), shared by
    the folds, or (F, N, D); w (F, N) the train-row weights, which enter
    only through gamma 'scale'. ``capture`` as in ``_solve_qps``."""
    n_folds, P, M = idx.shape
    Xf = _per_fold(X, n_folds)
    N, D = Xf.shape[1:]
    if gamma_mode == "scale":
        g = _weighted_gamma_scale(Xf, w)
    elif gamma_mode == "auto":
        g = torch.full((n_folds,), 1.0 / D, dtype=Xf.dtype, device=Xf.device)
    else:
        g = torch.full((n_folds,), float(gamma), dtype=Xf.dtype, device=Xf.device)
    Kfull = _kernel_matrix(Xf, Xf, g[:, None, None], kernel)   # (F, N, N)
    fold = torch.arange(n_folds, device=Xf.device)[:, None, None, None]
    Kp = Kfull[fold, idx[:, :, :, None], idx[:, :, None, :]]   # (F, P, M, M)
    alpha, b, _ = _solve_qps(Kp.reshape(n_folds * P, M, M), ypm.reshape(n_folds * P, M),
                             u.reshape(n_folds * P, M), iters, capture)
    # dual coefficients over all N rows; padding (index 0, ypm 0) adds 0
    A = torch.zeros((n_folds, P, N), dtype=Xf.dtype, device=Xf.device).scatter_add_(
        2, idx, (alpha * ypm.reshape(n_folds * P, M)).reshape(n_folds, P, M))
    return Kfull @ A.mT + b.reshape(n_folds, 1, P)


@full_float32()
def pca_cv(X: torch.Tensor, w: torch.Tensor, n_components: int) -> torch.Tensor:
    """Each fold's scaler + PCA fitted on its weighted rows (w = 0 rows
    ignored), through the sqrt(w)-scaled Gram eigendecomposition, then ALL
    rows transformed: X (N, D), w (F, N) -> Z (F, N, k). Component signs are
    left as ``eigh`` gives them, as in JAX: the kernels, distances and LDA
    downstream do not depend on them."""
    tot = w.sum(-1).clamp_min(1.0)[:, None]   # (F, 1)
    mean = (w @ X) / tot   # (F, D)
    diff = X[None] - mean[:, None, :]
    var = ((diff * diff) * w[..., None]).sum(1) / tot
    scale = var.sqrt()
    scale = torch.where(scale == 0.0, 1.0, scale)
    Xs = diff / scale[:, None, :]
    pmean = (Xs * w[..., None]).sum(1) / tot
    Xc = Xs - pmean[:, None, :]
    Xw = Xc * w.sqrt()[..., None]
    ev, U = torch.linalg.eigh(Xw @ Xw.mT)   # ascending, (F, N), (F, N, N)
    ev = ev.flip(-1)[:, :n_components].clamp_min(0.0)
    U = U.flip(-1)[:, :, :n_components]
    comp = (Xw.mT @ U) / ev.sqrt().clamp_min(1e-12)[:, None, :]
    return Xc @ comp


@full_float32()
def lda_cv(X: torch.Tensor, y_onehot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each fold's closed-form LDA on its weighted rows, with the rank-cutoff
    solve and the 1e-12 prior floor of ``fit_lda`` (a fold's scores see the
    covariance treatment the refit model gets); decision values of ALL
    rows, (F, N, K). X (N, r) shared or (F, N, r)."""
    Xf = _per_fold(X, w.shape[0])
    wcounts = w @ y_onehot   # (F, K)
    means = ((y_onehot[None] * w[..., None]).mT @ Xf) / wcounts.clamp_min(1.0)[..., None]   # (F, K, r)
    Xc = (Xf - y_onehot @ means) * w.sqrt()[..., None]
    denom = (w.sum(-1) - y_onehot.shape[1]).clamp_min(1.0)
    Sw = (Xc.mT @ Xc) / denom[:, None, None]
    coef = _sw_pinv_solve(Sw, means.mT)   # (F, r, K)
    priors = wcounts / w.sum(-1, keepdim=True).clamp_min(1.0)
    intercept = -0.5 * (means.mT * coef).sum(1) + torch.log(priors.clamp_min(1e-12))
    return Xf @ coef + intercept[:, None, :]


@full_float32()
def knn_cv(X: torch.Tensor, w: torch.Tensor, yr_onehot: torch.Tensor, k: int, metric: str) -> torch.Tensor:
    """Each fold's kNN class counts of ALL rows against its train rows (w = 0
    rows at distance +inf), (F, N, K). The k nearest by a stable sort, so
    that equal distances go to the lower row index first, as
    ``jax.lax.top_k`` orders them. X (N, D) shared or (F, N, D)."""
    if metric == "cosine":
        Xn = X / X.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        d = 1.0 - Xn @ Xn.mT
    else:
        sq = (X * X).sum(-1)
        d = sq[..., :, None] - 2.0 * (X @ X.mT) + sq[..., None, :]
    d = torch.where(w[:, None, :] > 0, d, torch.inf)   # (F, N, N)
    nidx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return yr_onehot[nidx].sum(-2)


# ===========================================================================
# host-side orchestration (numpy in and out; tensor math on ``device``)
# ===========================================================================


def fit_scaler_pca_np(X: np.ndarray, n_components: int, device=None) -> dict:
    dev = resolve_device(device)
    n_components = int(min(n_components, X.shape[0], X.shape[1]))
    mean, scale, pmean, comp = fit_scaler_pca(_tensor(X, dev), n_components)
    return {
        "scaler_mean": _np(mean),
        "scaler_scale": _np(scale),
        "pca_mean": _np(pmean),
        "pca_components": _np(comp),   # (D, k) columns
    }


def transform_scaler_pca_np(X: np.ndarray, state: dict, device=None) -> np.ndarray:
    dev = resolve_device(device)
    args = [_tensor(state[k], dev) for k in ("scaler_mean", "scaler_scale", "pca_mean", "pca_components")]
    return _np(transform_scaler_pca(_tensor(X, dev), *args))


def fit_lda_np(X: np.ndarray, y: np.ndarray, n_classes: int, device=None) -> dict:
    """Closed-form LDA; for D > N-1 the fit runs in the (lossless) span of
    the centred data and the coefficients are composed back to D-space,
    so the stored model is always plain (coef, intercept)."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    N, D = X.shape
    r = min(D, N - 1)
    y_t = _tensor(y, dev, torch.int64)
    if D > r:
        # project onto the data span: plain PCA with unit scale
        mean, scale, pmean, comp = (_np(t) for t in fit_scaler_pca(_tensor(X, dev), r))
        comp_np = comp / scale[:, None]   # undo the std scaling
        offset = mean + pmean * scale
        Z = (X - offset) @ comp_np
        coef_r, intercept = (_np(t) for t in fit_lda(_tensor(Z, dev), y_t, n_classes))
        coef = comp_np @ coef_r   # (D, K)
        intercept = intercept - offset @ coef
    else:
        coef, intercept = (_np(t) for t in fit_lda(_tensor(X, dev), y_t, n_classes))
    # presence mask: makes "never predicted" unconditional at decision time,
    # also for inputs far out of the training distribution
    present = np.bincount(y, minlength=n_classes) > 0
    return {
        "lda_coef": coef.astype(np.float32),
        "lda_intercept": np.asarray(intercept, np.float32),
        "lda_present": present,
    }


def lda_decision_np(X: np.ndarray, state: dict, device=None) -> np.ndarray:
    dev = resolve_device(device)
    dec = _np(linear_decision(_tensor(X, dev), _tensor(state["lda_coef"], dev), _tensor(state["lda_intercept"], dev)))
    present = state.get("lda_present")   # absent in pre-mask saved bundles
    if present is not None and not np.asarray(present).all():
        absent = ~np.asarray(present, bool)
        # row-relative floor far below every present-class score: argmax never
        # picks an absent class, and its softmax mass is ~e^-100 (finite)
        dec[:, absent] = dec[:, ~absent].min(axis=1, keepdims=True) - 100.0
    return dec


def softmax_np(d: np.ndarray) -> np.ndarray:
    e = np.exp(d - d.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


# -- SVM host orchestration ----------------------------------------------------


def _resolve_gamma(gamma, X: np.ndarray) -> float:
    if gamma == "scale":
        v = float(X.var())
        return 1.0 / (X.shape[1] * v) if v > 0 else 1.0
    if gamma == "auto":
        return 1.0 / X.shape[1]
    return float(gamma)


def _ovo_layout(y: np.ndarray, n_classes: int, pad_to: int = 8):
    """Padded per-pair index/target arrays for the batched solver. Returns
    (pairs[P, 2], idx[P, M], ypm[P, M]) with M rounded up to a multiple of
    ``pad_to``; padding has idx 0 and ypm 0."""
    by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    pairs = [(i, j) for i in range(n_classes) for j in range(i + 1, n_classes)]
    M = max(len(by_class[i]) + len(by_class[j]) for i, j in pairs)
    M = int(-(-M // pad_to) * pad_to)
    P = len(pairs)
    idx = np.zeros((P, M), np.int32)
    ypm = np.zeros((P, M), np.float32)
    for p, (i, j) in enumerate(pairs):
        ni, nj = len(by_class[i]), len(by_class[j])
        idx[p, :ni] = by_class[i]
        idx[p, ni:ni + nj] = by_class[j]
        ypm[p, :ni] = 1.0
        ypm[p, ni:ni + nj] = -1.0
    return np.asarray(pairs, np.int32), idx, ypm


def _platt_fit(f: np.ndarray, ypm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Platt sigmoid per pair (vectorized over pairs): minimize the NLL of
    t against 1/(1+exp(A f + B)) with Platt's regularized targets, damped
    Newton (Lin-Weng-style). f, ypm: (P, M); returns (A[P], B[P])."""
    valid = ypm != 0
    npos = (ypm > 0).sum(1).astype(np.float64)
    nneg = (ypm < 0).sum(1).astype(np.float64)
    hi_t = (npos + 1.0) / (npos + 2.0)
    lo_t = 1.0 / (nneg + 2.0)
    t = np.where(ypm > 0, hi_t[:, None], lo_t[:, None]) * valid
    A = np.zeros(len(f))
    B = np.log((nneg + 1.0) / (npos + 1.0))
    f = np.asarray(f, np.float64)

    def nll(A, B):
        # NLL of t vs p=1/(1+e^z): log(1+e^z) - (1-t) z, branch-stabilized
        z = A[:, None] * f + B[:, None]
        val = np.where(z >= 0, t * z + np.log1p(np.exp(-np.abs(z))),
                       (t - 1.0) * z + np.log1p(np.exp(-np.abs(z))))
        return np.sum(val * valid, axis=1)

    obj = nll(A, B)
    for _ in range(64):
        z = A[:, None] * f + B[:, None]
        p = 1.0 / (1.0 + np.exp(np.clip(z, -500, 500)))   # P(y=+1)
        g = (t - p) * valid   # dNLL/dz
        w = (p * (1.0 - p)) * valid + 1e-12
        gA = np.sum(g * f, 1)
        gB = np.sum(g, 1)
        hAA = np.sum(w * f * f, 1) + 1e-8
        hAB = np.sum(w * f, 1)
        hBB = np.sum(w, 1) + 1e-8
        det = hAA * hBB - hAB * hAB
        dA = -(hBB * gA - hAB * gB) / det
        dB = -(hAA * gB - hAB * gA) / det
        step = np.ones(len(f))
        for _bt in range(16):   # backtracking line search, vectorized
            newA, newB = A + step * dA, B + step * dB
            new_obj = nll(newA, newB)
            better = new_obj < obj + 1e-12
            if better.all():
                break
            step = np.where(better, step, step * 0.5)
        A, B = A + step * dA, B + step * dB
        new_obj = nll(A, B)
        if np.max(np.abs(new_obj - obj)) < 1e-10:
            obj = new_obj
            break
        obj = new_obj
    return A, B


def svm_problem(X: np.ndarray, y: np.ndarray, n_classes: int, C: float = 1.0, gamma="scale",
                class_weight: str | None = "balanced"):
    """The batched OvO problem ``svm_fit`` solves, on the host: (gamma,
    pairs[P, 2], idx[P, M], ypm[P, M], u[P, M]) with balanced box bounds."""
    N = len(X)
    gamma_v = _resolve_gamma(gamma, X)
    pairs, idx, ypm = _ovo_layout(y, n_classes)
    if class_weight == "balanced":
        counts = np.bincount(y, minlength=n_classes).astype(np.float64)
        w = N / (n_classes * np.maximum(counts, 1))
    else:
        w = np.ones(n_classes)
    u = np.where(
        ypm > 0, C * w[pairs[:, 0]][:, None], np.where(ypm < 0, C * w[pairs[:, 1]][:, None], 0.0)
    ).astype(np.float32)
    return float(np.float32(gamma_v)), pairs, idx, ypm, u


def fit_svm_np(
    X: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    C: float = 1.0,
    kernel: str = "rbf",
    gamma="scale",
    class_weight: str | None = "balanced",
    iters: int = 500,
    device=None,
) -> dict:
    """Fit the batched OvO kernel SVM. Returns a flat state dict of numpy
    arrays (support vectors, dual coefficient matrix, intercepts, Platt
    sigmoids), the one ``classical_jax.fit_svm_np`` returns."""
    if kernel not in ("rbf", "linear"):
        raise ValueError(f"svm kernel must be rbf or linear, got {kernel!r}")
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    N = len(X)
    gamma_v, pairs, idx, ypm, u = svm_problem(X, y, n_classes, C, gamma, class_weight)

    alpha, b, f = svm_fit(_tensor(X, dev), _tensor(idx, dev, torch.int64), _tensor(ypm, dev), _tensor(u, dev),
                          gamma_v, kernel, iters)
    alpha, b, f = _np(alpha), _np(b), _np(f)

    # Platt sigmoids on the training decision values (divergence from
    # libsvm's internal 5-fold CV, mitigated by Platt's regularized targets)
    pA, pB = _platt_fit(f + b[:, None], ypm)

    # dense dual-coefficient matrix over the union of support vectors
    A_full = np.zeros((len(pairs), N), np.float32)
    np.add.at(A_full, (np.arange(len(pairs))[:, None], idx), alpha * ypm)
    sv_mask = np.abs(A_full).max(0) > 1e-10
    if not sv_mask.any():
        sv_mask[:1] = True
    return {
        "svm_sv": X[sv_mask],
        "svm_dual": A_full[:, sv_mask],
        "svm_b": b.astype(np.float32),
        "svm_platt_a": pA.astype(np.float32),
        "svm_platt_b": pB.astype(np.float32),
        "svm_pairs": pairs,
        "svm_gamma": np.float32(gamma_v),
        "svm_kernel": np.array(kernel),
        "svm_n_classes": np.int32(n_classes),
    }


def svm_decision_np(X: np.ndarray, state: dict, device=None) -> np.ndarray:
    dev = resolve_device(device)
    return _np(svm_decision(_tensor(X, dev), _tensor(state["svm_sv"], dev), _tensor(state["svm_dual"], dev),
                            _tensor(state["svm_b"], dev), float(np.float32(state["svm_gamma"])),
                            str(state["svm_kernel"])))


def ovo_vote(dec: np.ndarray, pairs: np.ndarray, n_classes: int) -> np.ndarray:
    """sklearn `_ovr_decision_function`: votes + bounded confidence sums."""
    B = len(dec)
    votes = np.zeros((B, n_classes))
    conf = np.zeros((B, n_classes))
    for p, (i, j) in enumerate(pairs):
        d = dec[:, p]
        votes[:, i] += d > 0
        votes[:, j] += d <= 0
        conf[:, i] += d
        conf[:, j] -= d
    return votes + conf / (3.0 * (np.abs(conf) + 1.0))


def pairwise_coupling(r_pos: np.ndarray, pairs: np.ndarray, n_classes: int,
                      iters: int = 100) -> np.ndarray:
    """libsvm multiclass_probability (Wu, Lin & Weng 2004, method 2),
    vectorized over the batch. r_pos (B, P) = P(class i | i or j)."""
    Kc = n_classes
    B, P = r_pos.shape
    if Kc == 2:
        return np.stack([r_pos[:, 0], 1.0 - r_pos[:, 0]], axis=1)
    r = np.full((B, Kc, Kc), 0.0)
    eps = 1e-7
    rp = np.clip(r_pos, eps, 1.0 - eps)
    for p, (i, j) in enumerate(pairs):
        r[:, i, j] = rp[:, p]
        r[:, j, i] = 1.0 - rp[:, p]
    Q = np.zeros((B, Kc, Kc))
    for t in range(Kc):
        Q[:, t, t] = np.sum(np.delete(r[:, :, t], t, axis=1) ** 2, axis=1)
        for j in range(Kc):
            if j != t:
                Q[:, t, j] = -r[:, j, t] * r[:, t, j]
    p = np.full((B, Kc), 1.0 / Kc)
    for _ in range(iters):
        Qp = np.einsum("btj,bj->bt", Q, p)
        pQp = np.einsum("bt,bt->b", p, Qp)
        max_err = 0.0
        for t in range(Kc):
            diff = (-Qp[:, t] + pQp) / Q[:, t, t]
            p[:, t] += diff
            pQp = (pQp + diff * (diff * Q[:, t, t] + 2.0 * Qp[:, t])) / (1.0 + diff) ** 2
            Qp = (Qp + diff[:, None] * Q[:, t, :]) / (1.0 + diff)[:, None]
            p /= (1.0 + diff)[:, None]
            max_err = max(max_err, float(np.max(np.abs(diff))))
        if max_err < 1e-7:
            break
    return p / p.sum(axis=1, keepdims=True)


def predict_svm_np(X: np.ndarray, state: dict, device=None) -> np.ndarray:
    dec = svm_decision_np(X, state, device)
    scores = ovo_vote(dec, state["svm_pairs"], int(state["svm_n_classes"]))
    return scores.argmax(1).astype(np.int32)


def predict_proba_svm_np(X: np.ndarray, state: dict, device=None) -> np.ndarray:
    dec = svm_decision_np(X, state, device)
    z = state["svm_platt_a"][None, :] * dec + state["svm_platt_b"][None, :]
    r_pos = 1.0 / (1.0 + np.exp(np.clip(z, -500, 500)))
    return pairwise_coupling(r_pos, state["svm_pairs"], int(state["svm_n_classes"]))


def linear_ovo_coef(state: dict) -> tuple[np.ndarray, np.ndarray]:
    """Collapse a linear-kernel OvO model to explicit (coef[P, D], b[P]):
    the layout export_svm and the MicroPython runtime read."""
    if str(state["svm_kernel"]) != "linear":
        raise ValueError("linear_ovo_coef needs kernel='linear'")
    return state["svm_dual"] @ state["svm_sv"], state["svm_b"]
