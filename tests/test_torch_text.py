"""Port parity: the text extractors (``text_tfidf``, ``text_bow``,
``text_char_ngram``, ``text_sentence_embed``, ``text_bert_tokens``) and the
vectorizers, IDF weighting and LSA under them (``features/vectorize.py``,
``ops/textops.py``, ``ops/lsa.py``) of audio_edge_ml_pipeline_torch against
the JAX package, which runs scikit-learn, on the same seeded corpora (CPU).

Gates: bow and token ids equal; tfidf and char n-gram rows within 1e-7; LSA
rows within 1e-5; the same vocabularies. Both packages run the randomized
SVD from the same random directions, so roundoff could turn two components
only where their singular values are (nearly) equal; none of the corpora
here needs the rows' Gram matrix in place of the rows (``_GRAM_CORPORA`` is
empty), but the comparison is kept for one that would.
"""

import numpy as np
import pytest
import torch
from sklearn.decomposition import TruncatedSVD as SkTruncatedSVD
from sklearn.feature_extraction.text import CountVectorizer as SkCountVectorizer
from sklearn.feature_extraction.text import TfidfVectorizer as SkTfidfVectorizer

import make_synth_dataset
from audio_edge_ml_pipeline_tpu import features as jfeatures
from audio_edge_ml_pipeline_tpu.data import loaders as jloaders
from audio_edge_ml_pipeline_torch import features as tfeatures
from audio_edge_ml_pipeline_torch.data import loaders as tloaders
from audio_edge_ml_pipeline_torch.features import text as ttext
from audio_edge_ml_pipeline_torch.features import vectorize
from audio_edge_ml_pipeline_torch.ops import lsa, textops

TFIDF_TOL, LSA_TOL = 1e-7, 1e-5
_GRAM_CORPORA: frozenset[str] = frozenset()  # corpora whose LSA rows are compared through their Gram matrix


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def zipf_corpus(seed: int, n_docs: int = 120, n_classes: int = 4, vocab: int = 600) -> tuple[list[str], list[str]]:
    """Documents of 5-60 Zipf(1.1)-drawn pseudo-words, a few topic words a
    class, sentences with capitals and punctuation."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}x" for i in range(vocab)])
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    docs, labels = [], []
    for i in range(n_docs):
        c = i % n_classes
        toks = list(rng.choice(words, int(rng.integers(5, 61)), p=p))
        toks += [f"topic{c}word{int(k)}" for k in rng.integers(0, 5, 4)]
        rng.shuffle(toks)
        docs.append(". ".join(" ".join(toks[j : j + 9]).capitalize() for j in range(0, len(toks), 9)) + "!")
        labels.append(f"class{c}")
    return docs, labels


def loader_of(docs, labels=None):
    """An in-memory text loader: (None, label, {"text": doc})."""
    return [(None, None if labels is None else labels[i], {"text": d}) for i, d in enumerate(docs)]


@pytest.fixture(scope="module")
def synth_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("text") / "text.csv"
    make_synth_dataset.make_text_csv(path)
    return path


CORPORA = {
    "zipf": lambda: zipf_corpus(1),
    "zipf_small_vocab": lambda: zipf_corpus(2, n_docs=60, vocab=80),
}


def _compare_fs(name, jfs, tfs, corpus=""):
    assert tfs.features.shape == jfs.features.shape
    assert tfs.features.dtype == jfs.features.dtype
    if jfs.labels is None:
        assert tfs.labels is None and tfs.label_names is None
    else:
        assert list(tfs.labels) == list(jfs.labels) and tfs.label_names == jfs.label_names
    assert tfs.metadata == jfs.metadata
    assert (tfs.feature_type, tfs.modality) == (jfs.feature_type, jfs.modality)
    if name in ("text_bow", "text_bert_tokens"):
        np.testing.assert_array_equal(tfs.features, jfs.features)
    elif name == "text_sentence_embed":
        a, b = tfs.features.astype(np.float64), jfs.features.astype(np.float64)
        if corpus in _GRAM_CORPORA:
            np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=LSA_TOL)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=LSA_TOL)
    else:
        np.testing.assert_allclose(tfs.features, jfs.features, rtol=0, atol=TFIDF_TOL)


def _vocab(ex):
    """The fitted vocabulary of either package's corpus-fit extractor."""
    return dict(ex._vectorizer.vocabulary_)


@pytest.mark.parametrize("corpus", ["synth", *CORPORA])
@pytest.mark.parametrize("name,kwargs", [
    ("text_tfidf", {}), ("text_tfidf", {"max_features": 64}), ("text_bow", {}), ("text_bow", {"binary": True}),
    ("text_char_ngram", {}), ("text_char_ngram", {"max_features": 300}), ("text_sentence_embed", {}),
    ("text_bert_tokens", {}),
])
def test_extractor_matches_jax(name, kwargs, corpus, synth_csv):
    if corpus == "synth":
        jl = jloaders.TextCSVLoader(synth_csv, text_col="text", label_col="label")
        tl = tloaders.TextCSVLoader(synth_csv, text_col="text", label_col="label")
    else:
        docs, labels = CORPORA[corpus]()
        jl = tl = loader_of(docs, labels)
    jex = jfeatures.get(name)(**kwargs)
    tex = tfeatures.get(name)(**kwargs, device="cpu")
    jfs, tfs = jex.extract_dataset(jl), tex.extract_dataset(tl)
    _compare_fs(name, jfs, tfs, corpus)
    if name in ("text_tfidf", "text_bow", "text_char_ngram"):
        assert _vocab(tex) == {k: int(v) for k, v in _vocab(jex).items()}
    if name == "text_bert_tokens":
        assert tex._vocab == jex._vocab
    # extract() after the fit: a document with words the corpus never saw
    doc = "Zzqx unseen-words w1x w2x, topic0word1 and more w3x w1x!"
    t1, j1 = tex.extract(None, text=doc), jex.extract(None, text=doc)
    assert t1.shape == j1.shape and t1.dtype == j1.dtype
    atol = LSA_TOL if name == "text_sentence_embed" else (0 if name in ("text_bow", "text_bert_tokens") else TFIDF_TOL)
    np.testing.assert_allclose(t1, j1, rtol=0, atol=atol)


def test_registry_resolves_every_text_extractor():
    for name, cls in (("text_tfidf", ttext.TextTFIDFExtractor), ("text_bow", ttext.TextBOWExtractor),
                      ("text_char_ngram", ttext.TextCharNgramExtractor),
                      ("text_sentence_embed", ttext.TextSentenceEmbedding),
                      ("text_bert_tokens", ttext.TextBERTTokens)):
        assert tfeatures.get(name) is cls
        # the JAX package's defaults
        ours, theirs = cls(device="cpu"), jfeatures.get(name)()
        for attr in ("max_features", "ngram_range", "sublinear_tf", "min_df", "max_df", "binary", "dim",
                     "model_name", "max_length", "vocab_size", "normalize_embeddings", "batch_size",
                     "return_attention_mask", "feature_type", "modality"):
            assert getattr(ours, attr, None) == getattr(theirs, attr, None), (name, attr)


@pytest.mark.parametrize("name", ["text_tfidf", "text_bow", "text_char_ngram"])
def test_extract_before_fit_is_refused(name):
    with pytest.raises(RuntimeError, match="not fitted"):
        tfeatures.get(name)(device="cpu").extract(None, text="a document")


def test_max_features_tie_at_the_cut_falls_as_numpys_unstable_sort():
    """60 terms of one term frequency (each in 2 of 3 documents), 40 of
    them kept: which 40 is numpy's unstable argsort's choice, in the count
    dtype of each vectorizer."""
    words = [f"t{i:02d}" for i in range(60)]
    docs = [" ".join(words[:40]), " ".join(words[20:]), " ".join(words[:20] + words[40:])]
    for kw in ({"max_features": 40}, {"max_features": 40, "ngram_range": (1, 2)}, {"max_features": 7}):
        for sk_cls, port_cls in ((SkCountVectorizer, vectorize.CountVectorizer),
                                 (SkTfidfVectorizer, vectorize.TfidfVectorizer)):
            sk = sk_cls(**kw).fit(docs)
            port = port_cls(**kw, device="cpu")
            port.fit_counts(docs)
            assert port.vocabulary_ == {k: int(v) for k, v in sk.vocabulary_.items()}, (sk_cls.__name__, kw)
    # the same through the extractors
    jex, tex = jfeatures.get("text_bow")(max_features=30, min_df=1), tfeatures.get("text_bow")(max_features=30, min_df=1,
                                                                                                  device="cpu")
    _compare_fs("text_bow", jex.extract_dataset(loader_of(docs)), tex.extract_dataset(loader_of(docs)))
    assert _vocab(tex) == {k: int(v) for k, v in _vocab(jex).items()}


@pytest.mark.parametrize("min_df,max_df", [(1, 1.0), (2, 0.95), (3, 10), (0.05, 0.5), (2, 0.6), (0.1, 30)])
def test_min_df_and_max_df_as_counts_and_proportions(min_df, max_df):
    docs, labels = zipf_corpus(3, n_docs=50, vocab=120)
    for name in ("text_tfidf", "text_bow"):
        jex = jfeatures.get(name)(min_df=min_df, max_df=max_df, max_features=None)
        tex = tfeatures.get(name)(min_df=min_df, max_df=max_df, max_features=None, device="cpu")
        _compare_fs(name, jex.extract_dataset(loader_of(docs, labels)), tex.extract_dataset(loader_of(docs, labels)))
        assert _vocab(tex) == {k: int(v) for k, v in _vocab(jex).items()}


@pytest.mark.parametrize("docs,min_df,max_df,message", [
    ("zipf", 5, 3, "max_df corresponds to < documents than min_df"),
    ("zipf", 0.9, 0.5, "max_df corresponds to < documents than min_df"),
    ("zipf", 40, 1.0, "max_df corresponds to < documents than min_df"),  # 40 documents asked of 30
    ("disjoint", 2, 1.0, "After pruning, no terms remain"),
    ("disjoint", 0.0, 0.2, "After pruning, no terms remain"),
    ("stopwords", 1, 1.0, "empty vocabulary"),
])
def test_scikit_learns_value_errors(docs, min_df, max_df, message):
    docs = {"zipf": zipf_corpus(4, n_docs=30, vocab=50)[0], "disjoint": ["aa bb", "cc dd", "ee ff"],
            "stopwords": ["a", "! ?", "b"]}[docs]
    for name in ("text_tfidf", "text_bow"):
        with pytest.raises(ValueError, match=message):
            jfeatures.get(name)(min_df=min_df, max_df=max_df).extract_dataset(loader_of(docs))
        with pytest.raises(ValueError, match=message):
            tfeatures.get(name)(min_df=min_df, max_df=max_df, device="cpu").extract_dataset(loader_of(docs))


def test_char_wb_on_whitespace_punctuation_non_ascii_and_one_letter_words():
    docs = ["a  b\t\tc\n\nd", "Ünïcödé  wörds,  ça va?  naïve café!", "x  yy zzz wwww vvvvv", "",
            "  leading and trailing   ", "I a o u e", "Ñ ñ ß — … “quotes” 日本語 テキスト",
            "x  yy zzz wwww vvvvv again", "a  b\t\tc\n\nd again"]
    for n in ((3, 5), (1, 1), (1, 3), (2, 2), (5, 7)):
        sk = SkTfidfVectorizer(analyzer="char_wb", ngram_range=n).build_analyzer()
        port = vectorize.TfidfVectorizer(analyzer="char_wb", ngram_range=n, device="cpu")
        for d in docs:
            assert port.analyze(d) == sk(d), (n, d)
    jex = jfeatures.get("text_char_ngram")(min_df=1)
    tex = tfeatures.get("text_char_ngram")(min_df=1, device="cpu")
    _compare_fs("text_char_ngram", jex.extract_dataset(loader_of(docs)), tex.extract_dataset(loader_of(docs)))
    assert _vocab(tex) == {k: int(v) for k, v in _vocab(jex).items()}


def test_word_analyzer_matches_scikit_learn():
    docs = ["Hello, World! hello   world", "it's a don't-stop 42 x y zz", "Ünïcödé wörds ça", "", "one"]
    for n in ((1, 1), (1, 2), (2, 3), (1, 4)):
        sk = SkCountVectorizer(ngram_range=n).build_analyzer()
        port = vectorize.CountVectorizer(ngram_range=n, device="cpu")
        for d in docs:
            assert port.analyze(d) == sk(d), (n, d)


@pytest.mark.parametrize("name", ["text_tfidf", "text_bow", "text_char_ngram", "text_sentence_embed",
                                  "text_bert_tokens"])
def test_an_empty_document(name):
    docs, labels = zipf_corpus(5, n_docs=40, vocab=100)
    docs[3] = ""
    docs[17] = "   "
    jfs = jfeatures.get(name)().extract_dataset(loader_of(docs, labels))
    tfs = tfeatures.get(name)(device="cpu").extract_dataset(loader_of(docs, labels))
    _compare_fs(name, jfs, tfs)
    if name in ("text_tfidf", "text_bow", "text_char_ngram"):
        assert not tfs.features[3].any() and not tfs.features[17].any()


def test_corpus_too_small_for_the_svd_takes_the_hash_fallback():
    for docs in (["only one document here"], ["two documents", "two documents"], ["aa bb", "cc"]):
        jex, tex = jfeatures.get("text_sentence_embed")(), tfeatures.get("text_sentence_embed")(device="cpu")
        jfs, tfs = jex.extract_dataset(loader_of(docs)), tex.extract_dataset(loader_of(docs))
        assert jex._lsa is None and tex._lsa is None
        np.testing.assert_array_equal(tfs.features, jfs.features)
        np.testing.assert_array_equal(tex.extract(None, text="a river"), jex.extract(None, text="a river"))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dim", [384, 16])
def test_lsa_normalize_embeddings_and_dim(normalize, dim):
    docs, labels = zipf_corpus(6, n_docs=50, vocab=200)
    jex = jfeatures.get("text_sentence_embed")(dim=dim, normalize_embeddings=normalize)
    tex = tfeatures.get("text_sentence_embed")(dim=dim, normalize_embeddings=normalize, device="cpu")
    _compare_fs("text_sentence_embed", jex.extract_dataset(loader_of(docs, labels)),
                tex.extract_dataset(loader_of(docs, labels)))
    np.testing.assert_allclose(tex.extract(None, text="w1x w5x new words"), jex.extract(None, text="w1x w5x new words"),
                               rtol=0, atol=LSA_TOL)


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("max_length", [128, 8])
def test_bert_tokens_attention_mask_and_unfitted_hash_ids(mask, max_length):
    docs, labels = zipf_corpus(7, n_docs=30, vocab=90)
    jex = jfeatures.get("text_bert_tokens")(max_length=max_length, return_attention_mask=mask)
    tex = tfeatures.get("text_bert_tokens")(max_length=max_length, return_attention_mask=mask, device="cpu")
    doc = "never seen words and w1x"
    np.testing.assert_array_equal(tex.extract(None, text=doc), jex.extract(None, text=doc))  # before a fit
    _compare_fs("text_bert_tokens", jex.extract_dataset(loader_of(docs, labels)),
                tex.extract_dataset(loader_of(docs, labels)))
    out = tex.extract(None, text=doc)
    np.testing.assert_array_equal(out, jex.extract(None, text=doc))
    assert out.shape == ((2, max_length) if mask else (max_length,)) and out.dtype == np.int32


def test_lsa_follows_scikit_learns_randomized_svd():
    """ops/lsa.py against TruncatedSVD(random_state=42) on a TF-IDF matrix
    with fewer and with more documents than terms (both sides of the
    transpose rule): components, singular values and rows."""
    for docs in (zipf_corpus(8, n_docs=80, vocab=400)[0], zipf_corpus(9, n_docs=200, vocab=40)[0]):
        sk_vec = SkTfidfVectorizer(max_features=20000, ngram_range=(1, 1))
        X = sk_vec.fit_transform(docs)
        k = min(30, X.shape[0] - 1, X.shape[1] - 1)
        svd = SkTruncatedSVD(n_components=k, random_state=42)
        rows = svd.fit_transform(X)
        fitted, port_rows = lsa.truncated_svd(torch.from_numpy(X.toarray()), k)
        np.testing.assert_allclose(fitted.singular_values.numpy(), svd.singular_values_, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(fitted.components.numpy(), svd.components_, rtol=0, atol=1e-8)
        np.testing.assert_allclose(port_rows.numpy(), rows, rtol=0, atol=1e-8)


def test_tfidf_rows_match_scikit_learns_weighting(monkeypatch):
    """ops/textops.py on a CSR matrix: sublinear tf, smooth IDF and the L2
    norm as TfidfTransformer gives them, an empty row kept at zero, in
    chunks of any size."""
    docs, _ = zipf_corpus(10, n_docs=70, vocab=150)
    docs[5] = ""
    for sublinear in (False, True):
        sk = SkTfidfVectorizer(sublinear_tf=sublinear)
        want = sk.fit_transform(docs).toarray()
        port = vectorize.TfidfVectorizer(sublinear_tf=sublinear, device="cpu")
        counts = port.fit_counts(docs)
        np.testing.assert_allclose(port.idf_.numpy(), sk.idf_, rtol=1e-15)
        for chunk in (1, 7, 1024):
            monkeypatch.setattr(textops, "CHUNK_ROWS", chunk)
            got = textops.tfidf_rows(counts.indptr, counts.indices, counts.data, port.idf_, counts.n_cols, sublinear,
                                     "l2", torch.device("cpu"), torch.float64)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
        assert not got[5].any()


def test_extractors_without_a_card_raise_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("text_tfidf", "text_bow", "text_char_ngram", "text_sentence_embed", "text_bert_tokens"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfeatures.get(name)()
        assert tfeatures.get(name)(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("cls", ["CountVectorizer", "TfidfVectorizer"])
def test_vectorizers_default_to_the_card(monkeypatch, cls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(vectorize, cls)()
    vec = getattr(vectorize, cls)(device="cpu")
    assert vec.device.type == "cpu" and vec.fit_transform(["a bc bc", "bc de"]).device.type == "cpu"
