"""Stage 4 helpers: the canonical class-name label encoding.

Counterpart of part of the JAX package's ``train/tune.py``: the two label
helpers the train CLI needs. The hyperparameter-search CLI itself (the
classical grid branch, the deep TPE branch with its pruner, the search-space
DSL and the tuning shortlist) is still to be ported.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def encode_labels_by_name(y, source_names, target_names):
    """Vectorized by-NAME label re-encoding: map integer labels encoded
    against ``source_names`` onto the ``target_names`` ordering, dropping
    samples whose class has no slot in the target. Returns ``(keep_mask,
    remapped_labels)``.

    Two loaders may order the same classes differently (audio_folder is
    alphabetical, FSC22Loader follows the metadata CSV), so reusing integer
    codes across FeatureSets scrambles labels.
    """
    slot = {name: j for j, name in enumerate(target_names)}
    lut = np.array([slot.get(name, -1) for name in source_names], dtype=np.int64)
    remapped = lut[np.asarray(y, dtype=np.int64)]
    keep = remapped >= 0
    return keep, remapped[keep].astype(np.int32)


def apply_class_filter_canonical(X, y, label_names, class_filter, run_label: str):
    """Restrict a FeatureSet to ``class_filter`` under the canonical
    **name-sorted** integer encoding (sorting by class name makes the
    encoding loader-order independent)."""
    if not class_filter:
        return X, y, label_names
    wanted = set(class_filter)
    kept_names = sorted(wanted.intersection(label_names))
    if not kept_names:
        raise ValueError(
            f"[{run_label}] none of class_filter={sorted(wanted)} occur in {label_names}"
        )
    absent = wanted.difference(label_names)
    if absent:
        logger.warning("[%s] class_filter names absent from dataset: %s", run_label, sorted(absent))
    keep, y_new = encode_labels_by_name(y, label_names, kept_names)
    logger.info(
        "[%s] class filter kept %d/%d classes, %d/%d samples",
        run_label, len(kept_names), len(label_names), int(keep.sum()), len(y),
    )
    return X[keep], y_new, kept_names
