"""The device half of the text vectorizers (``features/vectorize.py``):
TF-IDF weighting of a CSR matrix of term counts, as scikit-learn's
``TfidfTransformer`` (smooth IDF, sublinear tf, L2 norm) computes it, in
float64 on the device, giving dense rows.

The JAX package leaves this to scikit-learn on the host; the port runs it as
torch ops (``bincount``, gathers, ``index_add_``, one scatter into the dense
rows), no hand kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# rows weighed at once: a chunk's float64 entries and its dense rows stay
# small beside the output
CHUNK_ROWS = 1024


def smooth_idf(indices: np.ndarray, n_docs: int, n_cols: int, device: torch.device) -> torch.Tensor:
    """``ln((1 + n) / (1 + df)) + 1`` a column, float64 on ``device``, from
    the column indices of a CSR matrix (one entry a document and term)."""
    cols = torch.from_numpy(np.ascontiguousarray(indices, np.int64)).to(device)
    df = torch.bincount(cols, minlength=n_cols).to(torch.float64) + 1.0
    return torch.log((n_docs + 1) / df) + 1.0


def tfidf_rows(indptr: np.ndarray, indices: np.ndarray, counts: np.ndarray, idf: Optional[torch.Tensor],
               n_cols: int, sublinear: bool, norm: Optional[str], device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense (n_docs, n_cols) rows of ``dtype`` on ``device`` from a CSR
    matrix of counts: ``1 + ln(tf)`` on the stored entries if ``sublinear``,
    times ``idf`` if given, each row over its L2 norm if ``norm == "l2"``
    (a row of zeros stays zeros), all in float64, CHUNK_ROWS rows at a
    time. ``idf=None``, no sublinear tf and no norm give the counts
    themselves."""
    if norm not in (None, "l2"):
        raise ValueError(f"norm must be None or 'l2', got {norm!r}")
    device = torch.device(device)
    n_docs = len(indptr) - 1
    ptr = torch.from_numpy(np.ascontiguousarray(indptr, np.int64)).to(device)
    cols = torch.from_numpy(np.ascontiguousarray(indices, np.int64)).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(counts, np.float64)).to(device)
    out = torch.zeros((n_docs, n_cols), dtype=dtype, device=device)
    lengths = ptr[1:] - ptr[:-1]
    for r0 in range(0, n_docs, CHUNK_ROWS):
        r1 = min(r0 + CHUNK_ROWS, n_docs)
        lo, hi = int(indptr[r0]), int(indptr[r1])
        if lo == hi:
            continue
        rows = torch.repeat_interleave(torch.arange(r1 - r0, device=device), lengths[r0:r1], output_size=hi - lo)
        c = cols[lo:hi]
        v = vals[lo:hi]
        if sublinear:
            v = torch.log(v) + 1.0
        if idf is not None:
            v = v * idf[c]
        if norm == "l2":
            sq = torch.zeros(r1 - r0, dtype=torch.float64, device=device).index_add_(0, rows, v * v)
            scale = torch.sqrt(sq)
            v = v / torch.where(scale > 0, scale, 1.0)[rows]
        out[r0:r1].index_put_((rows, c), v.to(dtype))
    return out
