"""Port parity: the batched image descriptors of audio_edge_ml_pipeline_torch
(``ops/imgdsp.py``) against JAX ``ops/imgdsp.py`` and the port's numpy oracle
(``features/image.py``) on the CPU, with the gates of JAX's
tests/test_image_jax.py: LBP and the gray histogram bit for bit, HOG within
1e-5, GLCM and the whole vector within 2e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu.features import image as jimage
from audio_edge_ml_pipeline_tpu.ops import imgdsp as jimgdsp
from audio_edge_ml_pipeline_torch.features import image as timage
from audio_edge_ml_pipeline_torch.ops import imgdsp as timgdsp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _images(h: int, w: int, seed: int = 7) -> np.ndarray:
    """Dense noise, a smooth gradient, blocky constant regions (LBP ties), a
    clipped normal, and two flat frames (every LBP delta zero)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blocks = np.kron(rng.random((h // 8 + 1, w // 8 + 1)) > 0.5, np.ones((8, 8)))[:h, :w]
    return np.stack([
        rng.random((h, w), dtype=np.float32),
        ((yy * yy / (h - 1.0) + xx) / (2.0 * max(h, w))).astype(np.float32),
        (blocks * 0.8 + 0.1).astype(np.float32),
        np.clip(rng.normal(0.5, 0.2, (h, w)), 0, 1).astype(np.float32),
        np.full((h, w), 0.5, np.float32),
        np.zeros((h, w), np.float32),
    ])


GEOMETRIES = {  # name -> (H, W, hog cell, hog block)
    "128x128": (128, 128, (8, 8), (2, 2)),
    "96x80_rect": (96, 80, (16, 8), (1, 2)),
}

HOG = ("hog", lambda g, cell, block: timgdsp.hog_features_batch(g, cell=cell, block=block),
       lambda g, cell, block: jimgdsp.hog_features_batch(g, cell=cell, block=block),
       lambda g, cell, block: timage.hog_features(g, cell=cell, block=block), 1e-5)
LBP = ("lbp", lambda g, *_: timgdsp.lbp_histogram_batch(g), lambda g, *_: jimgdsp.lbp_histogram_batch(g),
       lambda g, *_: timage.lbp_histogram(g), 0.0)
HIST = ("gray_hist", lambda g, *_: timgdsp.gray_hist_batch(g), lambda g, *_: jimgdsp.gray_hist_batch(g),
        lambda g, *_: (np.histogram(g, bins=64, range=(0.0, 1.0))[0].astype(np.float32)
                       / max(np.histogram(g, bins=64, range=(0.0, 1.0))[0].sum(), 1)).astype(np.float32), 0.0)
GLCM = ("glcm", lambda g, *_: timgdsp.glcm_stats_batch(g), lambda g, *_: jimgdsp.glcm_stats_batch(g),
        lambda g, *_: timage.glcm_stats(g), 2e-4)
FULL = ("vector", lambda g, cell, block: timgdsp.classical_image_vector_batch(g, cell=cell, block=block),
        lambda g, cell, block: jimgdsp.classical_image_vector_batch(g, cell=cell, block=block),
        lambda g, cell, block: timage.classical_image_vector(g, cell=cell, block=block), 2e-4)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("case", [HOG, LBP, HIST, GLCM, FULL], ids=lambda c: c[0])
def test_batch_function_matches_jax_and_numpy_oracle(case, geometry):
    """Each batch function against the numpy oracle image by image and
    against JAX's batch function, at its gate (0: bit for bit)."""
    name, ours_fn, jax_fn, oracle_fn, tol = case
    h, w, cell, block = GEOMETRIES[geometry]
    imgs = _images(h, w)
    ours = ours_fn(torch.from_numpy(imgs), cell, block)
    assert ours.dtype == torch.float32
    ours = ours.numpy()
    theirs = np.asarray(jax_fn(jnp.asarray(imgs), cell, block))
    assert ours.shape == theirs.shape
    for i, g in enumerate(imgs):
        ref = oracle_fn(g, cell, block)
        assert ours[i].shape == ref.shape
        if tol == 0.0:
            np.testing.assert_array_equal(ours[i], ref)
            np.testing.assert_array_equal(ours[i], theirs[i])
        else:
            assert float(np.max(np.abs(ours[i] - ref))) <= tol
            assert float(np.max(np.abs(ours[i] - theirs[i]))) <= tol


def test_vector_width_and_block_order():
    """8196 dims at 128x128: HOG 8100, LBP 26, histogram 64, GLCM 6, in the
    oracle's order, with the LBP and histogram columns bit for bit."""
    imgs = _images(128, 128, seed=3)
    out = timgdsp.classical_image_vector_batch(torch.from_numpy(imgs)).numpy()
    assert out.shape == (len(imgs), 8196)
    for i, g in enumerate(imgs):
        ref = timage.classical_image_vector(g)
        np.testing.assert_array_equal(out[i, 8100:8190], ref[8100:8190])
        np.testing.assert_array_equal(ref, jimage.classical_image_vector(g))


def test_image_smaller_than_a_block_gives_an_empty_hog():
    g = torch.from_numpy(_images(12, 12)[:2])
    assert timgdsp.hog_features_batch(g).shape == (2, 0)
    assert timage.hog_features(g[0].numpy()).shape == (0,)
