"""Bag-of-terms vectorizers: scikit-learn's ``CountVectorizer`` and
``TfidfVectorizer`` (1.9, ``sklearn/feature_extraction/text.py``) for the
knobs the text extractors pass, without scikit-learn.

Tokenizing and counting are Python regex work and stay on the host: each
document becomes a row of a CSR matrix of counts (``Counts``). The
weighting runs on the device (``ops/textops.py``): document frequencies,
smooth IDF, sublinear tf, the L2 row norm, in float64, then the dense rows.

The semantics kept from scikit-learn:

- documents are lowercased; the ``word`` analyzer takes ``(?u)\\b\\w\\w+\\b``
  tokens and joins word n-grams with one space; ``char_wb`` collapses runs of
  whitespace, pads each word with one space and counts a word shorter than
  n once (its padded self);
- ``min_df`` / ``max_df`` are document counts when int, proportions of the
  documents when float;
- the vocabulary is sorted by term before ``max_features`` keeps
  ``(-tfs[mask]).argsort()[:limit]``, numpy's default (unstable) sort on the
  term frequencies in scikit-learn's dtype (int64 counts, float64 for TF-IDF),
  so ties at the cut fall as scikit-learn's fall;
- its errors, with their text: an empty vocabulary, ``max_df`` below
  ``min_df``, and no terms left after pruning;
- ``binary`` counts 1 for every term present.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from numbers import Integral
from typing import Iterable, Optional

import numpy as np
import torch

from ..ops import textops
from ..utils.device import resolve_device

_WHITE_SPACES = re.compile(r"\s\s+")
_TOKEN_PATTERN = re.compile(r"(?u)\b\w\w+\b")


def word_ngrams(tokens: list[str], ngram_range: tuple[int, int]) -> list[str]:
    """Unigrams first (when min_n is 1), then each longer n in order, as
    ``_VectorizerMixin._word_ngrams``."""
    min_n, max_n = ngram_range
    if max_n == 1:
        return tokens
    out = list(tokens) if min_n == 1 else []
    for n in range(max(min_n, 2), min(max_n + 1, len(tokens) + 1)):
        out.extend(" ".join(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
    return out


def char_wb_ngrams(text: str, ngram_range: tuple[int, int]) -> list[str]:
    """Character n-grams inside word boundaries, each word padded with one
    space, as ``_VectorizerMixin._char_wb_ngrams``."""
    min_n, max_n = ngram_range
    out: list[str] = []
    for w in _WHITE_SPACES.sub(" ", text).split():
        w = " " + w + " "
        for n in range(min_n, max_n + 1):
            out.extend(w[i : i + n] for i in range(max(len(w) - n, 0) + 1))
            if len(w) <= n:  # a short word counts once, as its padded self
                break
    return out


@dataclass
class Counts:
    """A CSR matrix of term counts: row i's terms are
    ``indices[indptr[i]:indptr[i + 1]]`` with counts ``data`` there."""

    indptr: np.ndarray  # (n_docs + 1,) int64
    indices: np.ndarray  # (nnz,) int64
    data: np.ndarray  # (nnz,) float64
    n_cols: int

    @property
    def n_rows(self) -> int:
        return len(self.indptr) - 1

    def document_frequency(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.n_cols)

    def keep_columns(self, keep: np.ndarray) -> "Counts":
        """The columns where ``keep`` is true, renumbered in order."""
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr))
        entry = keep[self.indices]
        indptr = np.concatenate([[0], np.cumsum(np.bincount(rows[entry], minlength=self.n_rows))])
        new_index = np.cumsum(keep) - 1
        return Counts(indptr.astype(np.int64), new_index[self.indices[entry]], self.data[entry], int(keep.sum()))


class CountVectorizer:
    """``sklearn.feature_extraction.text.CountVectorizer`` for the knobs the
    text extractors pass; ``fit_transform`` and ``transform`` give dense
    rows (float32 unless asked) on ``device`` (None: the card)."""

    # the dtype of scikit-learn's count matrix: the term frequencies that
    # max_features sorts are summed in it
    _tf_dtype = np.int64

    def __init__(self, analyzer: str = "word", ngram_range: tuple = (1, 1), min_df=1, max_df=1.0,
                 max_features: Optional[int] = None, binary: bool = False,
                 device: torch.device | str | None = None) -> None:
        if analyzer not in ("word", "char_wb"):
            raise ValueError(f"{analyzer} is not a valid tokenization scheme/analyzer")
        self.analyzer = analyzer
        self.ngram_range = tuple(ngram_range)
        self.min_df = min_df
        self.max_df = max_df
        self.max_features = max_features
        self.binary = binary
        self.device = resolve_device(device)
        self.vocabulary_: Optional[dict[str, int]] = None

    def analyze(self, doc: str) -> list[str]:
        doc = doc.lower()
        if self.analyzer == "char_wb":
            return char_wb_ngrams(doc, self.ngram_range)
        return word_ngrams(_TOKEN_PATTERN.findall(doc), self.ngram_range)

    def _count(self, docs: Iterable[str], vocabulary: Optional[dict[str, int]]) -> tuple[dict[str, int], Counts]:
        """Count each document's terms; a new term gets the next column
        unless ``vocabulary`` is fixed, where unknown terms are dropped."""
        fixed = vocabulary is not None
        if not fixed:
            vocabulary = defaultdict()
            vocabulary.default_factory = vocabulary.__len__
        indices: list[int] = []
        data: list[int] = []
        indptr = [0]
        for doc in docs:
            counter: dict[int, int] = {}
            for term in self.analyze(doc):
                try:
                    j = vocabulary[term]
                except KeyError:  # out of a fixed vocabulary
                    continue
                counter[j] = counter.get(j, 0) + 1
            indices.extend(counter)
            data.extend(counter.values())
            indptr.append(len(indices))
        if not fixed:
            vocabulary = dict(vocabulary)
            if not vocabulary:
                raise ValueError("empty vocabulary; perhaps the documents only contain stop words")
        counts = Counts(np.asarray(indptr, np.int64), np.asarray(indices, np.int64),
                        np.asarray(data, np.float64), len(vocabulary))
        if self.binary:
            counts.data[:] = 1.0
        return vocabulary, counts

    def fit_counts(self, docs: list[str]) -> Counts:
        """Learn the vocabulary (sorted by term, then pruned by min_df /
        max_df and cut to max_features) and return the documents' counts
        over it."""
        vocabulary, counts = self._count(docs, None)
        n_doc = counts.n_rows
        max_count = self.max_df if isinstance(self.max_df, Integral) else self.max_df * n_doc
        min_count = self.min_df if isinstance(self.min_df, Integral) else self.min_df * n_doc
        if max_count < min_count:
            raise ValueError("max_df corresponds to < documents than min_df")
        # renumber the columns in term order
        terms = sorted(vocabulary)
        order = np.empty(len(terms), np.int64)
        for new, term in enumerate(terms):
            order[vocabulary[term]] = new
        counts = Counts(counts.indptr, order[counts.indices], counts.data, counts.n_cols)
        dfs = counts.document_frequency()
        mask = (dfs <= max_count) & (dfs >= min_count)
        if self.max_features is not None and mask.sum() > self.max_features:
            tfs = np.bincount(counts.indices, weights=counts.data, minlength=counts.n_cols).astype(self._tf_dtype)
            keep = (-tfs[mask]).argsort()[: self.max_features]
            new_mask = np.zeros(len(dfs), dtype=bool)
            new_mask[np.where(mask)[0][keep]] = True
            mask = new_mask
        if not mask.any():
            raise ValueError("After pruning, no terms remain. Try a lower min_df or a higher max_df.")
        kept = np.flatnonzero(mask)
        self.vocabulary_ = {terms[j]: i for i, j in enumerate(kept)}
        return counts.keep_columns(mask)

    def counts(self, docs: list[str]) -> Counts:
        """The documents' counts over the fitted vocabulary."""
        if self.vocabulary_ is None:
            raise RuntimeError(f"{type(self).__name__}: not fitted")
        return self._count(docs, self.vocabulary_)[1]

    def weigh(self, counts: Counts, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Dense rows of ``counts`` on the device: the counts themselves."""
        return textops.tfidf_rows(counts.indptr, counts.indices, counts.data, None, counts.n_cols,
                                  sublinear=False, norm=None, device=self.device, dtype=dtype)

    def fit_transform(self, docs: list[str], dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.weigh(self.fit_counts(docs), dtype)

    def transform(self, docs: list[str], dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.weigh(self.counts(docs), dtype)


class TfidfVectorizer(CountVectorizer):
    """``sklearn.feature_extraction.text.TfidfVectorizer`` with smooth IDF
    and the L2 norm: ``fit_counts`` also learns ``idf_``, a float64 tensor
    on the device."""

    _tf_dtype = np.float64

    def __init__(self, analyzer: str = "word", ngram_range: tuple = (1, 1), min_df=1, max_df=1.0,
                 max_features: Optional[int] = None, sublinear_tf: bool = False,
                 device: torch.device | str | None = None) -> None:
        super().__init__(analyzer=analyzer, ngram_range=ngram_range, min_df=min_df, max_df=max_df,
                         max_features=max_features, device=device)
        self.sublinear_tf = sublinear_tf
        self.idf_: Optional[torch.Tensor] = None

    def fit_counts(self, docs: list[str]) -> Counts:
        counts = super().fit_counts(docs)
        self.idf_ = textops.smooth_idf(counts.indices, counts.n_rows, counts.n_cols, self.device)
        return counts

    def weigh(self, counts: Counts, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """TF-IDF rows of ``counts`` on the device: sublinear tf if set,
        times ``idf_``, each row over its L2 norm."""
        return textops.tfidf_rows(counts.indptr, counts.indices, counts.data, self.idf_, counts.n_cols,
                                  sublinear=self.sublinear_tf, norm="l2", device=self.device, dtype=dtype)
