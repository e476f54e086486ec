"""Registered text extractors: ``text_tfidf``, ``text_bow``,
``text_char_ngram``, ``text_sentence_embed`` and ``text_bert_tokens``.

Same names, parameters, defaults and outputs as the JAX package's
``features/text.py``, plus a ``device`` argument, without scikit-learn:

- the corpus-fit vectorizers (tfidf / bow / char n-grams) count terms on the
  host and weigh them on the device (``features/vectorize.py``,
  ``ops/textops.py``); ``extract`` is valid after ``extract_dataset`` fitted
  them;
- ``text_sentence_embed`` fits LSA on the corpus (TF-IDF over 20,000 word
  uni- and bigrams, then the randomized truncated SVD of ``ops/lsa.py`` on
  the device), falls back to a deterministic md5 feature-hashing embedding
  for a corpus too small for the SVD or an unfitted ``extract``, and uses a
  local Hugging Face model directory when one loads (nothing is
  downloaded);
- ``text_bert_tokens`` gives BERT-framed token ids ([CLS] 101, [SEP] 102,
  [PAD] 0) from a corpus-fit frequency-ranked vocabulary with hash buckets
  for unknown words, or a local tokenizer when one loads. It runs on the
  host.
"""

from __future__ import annotations

import hashlib
import re
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..ops.lsa import truncated_svd
from ..utils.device import resolve_device
from .base import BaseFeatureExtractor, _collect
from .registry import register
from .vectorize import CountVectorizer, TfidfVectorizer


def _doc_text(sample_path, kwargs) -> str:
    if kwargs.get("text") is not None:
        return str(kwargs["text"])
    if sample_path is not None:
        enc = kwargs.get("encoding") or "utf-8"
        return open(sample_path, "r", encoding=enc, errors="replace").read()
    raise ValueError("No text content: need 'text' metadata or a sample path.")


def _read_corpus(loader, max_samples):
    """(texts, labels, metas, label_to_idx): the loader's documents, a
    document that cannot be read skipped, labels interned in first
    occurrence order."""
    texts, labels, metas = [], [], []
    label_to_idx: dict[str, int] = {}
    for i, (path, label, meta) in enumerate(loader):
        if max_samples is not None and i >= max_samples:
            break
        try:
            texts.append(_doc_text(path, meta))
        except Exception:
            continue
        metas.append(meta)
        if label is not None:
            if label not in label_to_idx:
                label_to_idx[label] = len(label_to_idx)
            labels.append(label_to_idx[label])
    if not texts:
        raise RuntimeError("No features were successfully extracted.")
    return texts, labels, metas, label_to_idx


class _CorpusFitExtractor(BaseFeatureExtractor):
    """Stateful fit-then-transform base: extract() is valid only after
    extract_dataset() has fitted the vectorizer."""

    modality = "text"
    feature_type = "classical"

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = resolve_device(device)
        self._vectorizer: Optional[CountVectorizer] = None

    def _build_vectorizer(self) -> CountVectorizer:
        raise NotImplementedError

    def extract(self, sample_path, **kwargs) -> np.ndarray:
        if self._vectorizer is None:
            raise RuntimeError(
                f"{self.name}: vectorizer not fitted. Run extract_dataset() first."
            )
        text = _doc_text(sample_path, kwargs)
        return self._vectorizer.transform([text])[0].cpu().numpy()

    def extract_dataset(self, loader, max_samples=None):
        texts, labels, metas, label_to_idx = _read_corpus(loader, max_samples)
        self._vectorizer = self._build_vectorizer()
        feats = list(self._vectorizer.fit_transform(texts).cpu().numpy())
        return _collect(feats, labels, metas, label_to_idx, self.feature_type, self.modality)


@register
class TextTFIDFExtractor(_CorpusFitExtractor):
    name = "text_tfidf"

    def __init__(self, max_features: int = 10_000, ngram_range: tuple = (1, 2),
                 sublinear_tf: bool = True, min_df=2, max_df: float = 0.95,
                 device: torch.device | str | None = None) -> None:
        super().__init__(device)
        self.max_features = max_features
        self.ngram_range = tuple(ngram_range)
        self.sublinear_tf = sublinear_tf
        self.min_df = min_df
        self.max_df = max_df

    def _build_vectorizer(self):
        return TfidfVectorizer(max_features=self.max_features, ngram_range=self.ngram_range,
                               sublinear_tf=self.sublinear_tf, min_df=self.min_df, max_df=self.max_df,
                               device=self.device)


@register
class TextBOWExtractor(_CorpusFitExtractor):
    name = "text_bow"

    def __init__(self, max_features: int = 10_000, ngram_range: tuple = (1, 1),
                 binary: bool = False, min_df=2, max_df: float = 0.95,
                 device: torch.device | str | None = None) -> None:
        super().__init__(device)
        self.max_features = max_features
        self.ngram_range = tuple(ngram_range)
        self.binary = binary
        self.min_df = min_df
        self.max_df = max_df

    def _build_vectorizer(self):
        return CountVectorizer(max_features=self.max_features, ngram_range=self.ngram_range,
                               binary=self.binary, min_df=self.min_df, max_df=self.max_df, device=self.device)


@register
class TextCharNgramExtractor(_CorpusFitExtractor):
    name = "text_char_ngram"

    def __init__(self, max_features: int = 50_000, ngram_range: tuple = (3, 5), min_df=3,
                 device: torch.device | str | None = None) -> None:
        super().__init__(device)
        self.max_features = max_features
        self.ngram_range = tuple(ngram_range)
        self.min_df = min_df

    def _build_vectorizer(self):
        return TfidfVectorizer(analyzer="char_wb", max_features=self.max_features,
                               ngram_range=self.ngram_range, min_df=self.min_df, device=self.device)


_TOKEN_RE = re.compile(r"[a-z0-9']+")


def _hash_embed(text: str, dim: int) -> np.ndarray:
    """Deterministic feature-hashing embedding: each token hashes to a
    signed coordinate; L2-normalized bag-of-hashed-tokens."""
    v = np.zeros(dim, np.float32)
    for tok in _TOKEN_RE.findall(text.lower()):
        h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:8], "little")
        idx = h % dim
        sign = 1.0 if (h >> 63) & 1 else -1.0
        v[idx] += sign
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


@register
class TextSentenceEmbedding(BaseFeatureExtractor):
    """384-d sentence embedding (all-MiniLM-L6-v2 contract). Three offline
    backends:

    1. a local HF model dir when provided and loadable;
    2. corpus-fit **LSA** (TF-IDF -> randomized truncated SVD -> L2 norm) on
       ``extract_dataset``, on the device;
    3. the deterministic hashing projection for unfitted single-sample use
       and for a corpus too small for the SVD.
    """

    name = "text_sentence_embed"
    feature_type = "deep"
    modality = "text"

    def __init__(self, model_name: str = "all-MiniLM-L6-v2", dim: int = 384,
                 local_model_dir: Optional[str] = None, device: torch.device | str | None = None,
                 batch_size: int = 64, normalize_embeddings: bool = True) -> None:
        self.model_name = model_name
        self.dim = dim
        self.local_model_dir = local_model_dir
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.normalize_embeddings = normalize_embeddings
        self._model = None
        self._lsa = None  # (vectorizer, svd) after corpus fit
        if local_model_dir:
            try:
                from transformers import AutoModel, AutoTokenizer

                self._tok = AutoTokenizer.from_pretrained(local_model_dir)
                self._model = AutoModel.from_pretrained(local_model_dir).to(self.device)
            except Exception:
                self._model = None

    def _hf_embed(self, text: str) -> np.ndarray:
        with torch.no_grad():
            toks = self._tok(text, return_tensors="pt", truncation=True, max_length=256).to(self.device)
            out = self._model(**toks).last_hidden_state.mean(dim=1)[0]
        emb = out.cpu().numpy().astype(np.float32)
        n = np.linalg.norm(emb)
        return emb / n if n > 0 else emb

    def _pad_unit(self, rows: torch.Tensor) -> torch.Tensor:
        """Zero-pad float32 rows to the contract dim; L2-normalize unless
        disabled."""
        out = torch.zeros((len(rows), self.dim), dtype=torch.float32, device=rows.device)
        out[:, : rows.shape[1]] = rows
        if not self.normalize_embeddings:
            return out
        norms = torch.linalg.vector_norm(out, dim=1, keepdim=True)
        return out / torch.where(norms > 0, norms, 1.0)

    def extract(self, sample_path, **kwargs) -> np.ndarray:
        text = _doc_text(sample_path, kwargs)
        if self._model is not None:
            return self._hf_embed(text)
        if self._lsa is not None:
            vec, svd = self._lsa
            rows = svd.transform(vec.transform([text], dtype=torch.float64)).to(torch.float32)
            return self._pad_unit(rows)[0].cpu().numpy()
        return _hash_embed(text, self.dim)

    def extract_dataset(self, loader, max_samples=None):
        if self._model is not None:
            return super().extract_dataset(loader, max_samples=max_samples)
        texts, labels, metas, label_to_idx = _read_corpus(loader, max_samples)
        vec = TfidfVectorizer(max_features=20000, ngram_range=(1, 2), device=self.device)
        X = vec.fit_transform(texts, dtype=torch.float64)
        k = min(self.dim, X.shape[0] - 1, X.shape[1] - 1)
        if k >= 2:
            svd, rows = truncated_svd(X, k)
            self._lsa = (vec, svd)
            feats = list(self._pad_unit(rows.to(torch.float32)).cpu().numpy())
        else:  # corpus too small for an SVD — hashing fallback
            feats = [_hash_embed(t, self.dim) for t in texts]
        return _collect(feats, labels, metas, label_to_idx, self.feature_type, self.modality)


@register
class TextBERTTokens(BaseFeatureExtractor):
    """Fixed-length token-id sequence (max_length,). Backends, best
    available first:

    1. a local HF tokenizer dir (true BERT ids);
    2. a corpus-fit frequency-ranked vocabulary built by
       ``extract_dataset`` — ids are dense and stable (rank order), OOV
       words fall into hash buckets above the fitted range;
    3. pure hash-bucket ids for unfitted single-sample use.

    All paths keep BERT framing conventions: [CLS]=101 / [SEP]=102 / [PAD]=0.
    Tokenizing is host work: ``device`` is resolved as every extractor's is
    and takes no computation.
    """

    name = "text_bert_tokens"
    feature_type = "deep"
    modality = "text"

    _ID_BASE = 1000  # first non-special id (mirrors BERT's reserved block)

    def __init__(self, model_name: str = "bert-base-uncased", max_length: int = 128,
                 vocab_size: int = 30522, local_model_dir: Optional[str] = None,
                 return_attention_mask: bool = False, device: torch.device | str | None = None) -> None:
        self.model_name = model_name
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.return_attention_mask = return_attention_mask
        self.device = resolve_device(device)
        self._tok = None
        self._vocab: Optional[dict[str, int]] = None  # corpus-fit word -> id
        if local_model_dir:
            try:
                from transformers import AutoTokenizer

                self._tok = AutoTokenizer.from_pretrained(local_model_dir)
            except Exception:
                self._tok = None

    def _hash_id(self, tok: str) -> int:
        h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little")
        if self._vocab is not None:
            # OOV bucket range above the fitted vocabulary
            lo = self._ID_BASE + len(self._vocab)
            return lo + h % max(self.vocab_size - lo, 1)
        return self._ID_BASE + h % (self.vocab_size - self._ID_BASE)

    def _encode(self, text: str) -> np.ndarray:
        if self._tok is not None:
            enc = self._tok(text, truncation=True, max_length=self.max_length, padding="max_length")
            ids = np.asarray(enc["input_ids"], dtype=np.int32)
            if self.return_attention_mask:
                # (2, max_length): [ids, mask]
                return np.stack([ids, np.asarray(enc["attention_mask"], dtype=np.int32)])
            return ids
        ids = [101]
        for tok in _TOKEN_RE.findall(text.lower())[: self.max_length - 2]:
            if self._vocab is not None and tok in self._vocab:
                ids.append(self._vocab[tok])
            else:
                ids.append(self._hash_id(tok))
        ids.append(102)
        ids = ids[: self.max_length] + [0] * max(0, self.max_length - len(ids))
        arr = np.asarray(ids, dtype=np.int32)
        if self.return_attention_mask:
            return np.stack([arr, (arr != 0).astype(np.int32)])
        return arr

    def extract(self, sample_path, **kwargs) -> np.ndarray:
        return self._encode(_doc_text(sample_path, kwargs))

    def extract_dataset(self, loader, max_samples=None):
        if self._tok is not None:
            return super().extract_dataset(loader, max_samples=max_samples)
        texts, labels, metas, label_to_idx = _read_corpus(loader, max_samples)
        counts: Counter = Counter()
        for text in texts:
            counts.update(_TOKEN_RE.findall(text.lower()))
        budget = max(self.vocab_size - self._ID_BASE - 1000, 1)  # keep an OOV bucket range
        ranked = [w for w, _ in counts.most_common(budget)]
        self._vocab = {w: self._ID_BASE + r for r, w in enumerate(ranked)}
        feats = [self._encode(t) for t in texts]
        return _collect(feats, labels, metas, label_to_idx, self.feature_type, self.modality)
