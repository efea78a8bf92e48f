"""Samplers: class-stratified resampling + per-process sharding.

Parity targets:
- ``SubtypingStratifiedSampler`` (reference ``data_sampler.py:7-68``):
  class-balanced resampling over CLE label groups (uniform over classes,
  then uniform within class), 'balanced' class weights clipped to [0.2, 0.8]
  after sum-normalisation, missing classes get max weight, wall-clock
  reseeding per epoch;
- ``DistributedSamplerWrapper`` (reference ``sampler.py:39-97``) +
  ``DistributedSampler`` semantics: in a single-controller loop this
  collapses to plain index arithmetic — ``shard_indices`` pads the sampled
  index list to a multiple of world size and deals it round-robin, exactly
  what ``torch.utils.data.DistributedSampler`` does.

Numpy-only copy of ``bodyct_dram_emph_subtype_tpu/data/samplers.py``:
the same ``np.random.RandomState`` draws give the same indices.

sklearn's ``compute_class_weight('balanced')`` is just
``n_samples / (n_classes * bincount)``; we implement it directly.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def balanced_class_weights(labels: Sequence[int]) -> np.ndarray:
    """sklearn 'balanced' weights over the classes present in ``labels``."""
    labels = np.asarray(labels)
    classes, counts = np.unique(labels, return_counts=True)
    return len(labels) / (len(classes) * counts.astype(np.float64))


class SubtypingStratifiedSampler:
    """CLE-stratified resampler with clipped balanced class weights."""

    def __init__(self, data_source, balance_label_count: int,
                 seed: Optional[int] = None):
        self.data_source = data_source
        self.balance_label_count = balance_label_count
        self.seed = seed

        uid_scores = [(uid,
                       int(float(data_source.subtyping_labels[uid]["cle"])),
                       int(float(data_source.subtyping_labels[uid]["pse"])))
                      for uid in data_source.series_uids]
        uids, cle_scores, pse_scores = zip(*uid_scores)
        cle_scores = np.asarray(cle_scores)
        pse_scores = np.asarray(pse_scores)

        (self.cle_class_weights, self.cle_statistics,
         unique_cle) = self._weights_and_stats(cle_scores, 6)
        (self.pse_class_weights, self.pse_statistics,
         _) = self._weights_and_stats(pse_scores, 3)
        logger.info("cle label weights: %s", self.cle_class_weights)
        logger.info("pse label weights: %s", self.pse_class_weights)

        self.cle_label_groups: Dict[int, np.ndarray] = {
            int(l): np.where(cle_scores == l)[0] for l in unique_cle}
        self.pse_label_groups = {
            int(l): np.where(pse_scores == l)[0]
            for l in np.unique(pse_scores)}
        # num_samples counts only the classes present
        # (data_sampler.py:52)
        self.num_samples = len(unique_cle) * balance_label_count

    @staticmethod
    def _weights_and_stats(scores: np.ndarray, n_classes: int):
        unique, counts = np.unique(scores, return_counts=True)
        weights = balanced_class_weights(scores)
        weights = list(np.clip(weights / weights.sum(), 0.2, 0.8))
        stats = {int(u): c / counts.sum() for u, c in zip(unique, counts)}
        for ctss in range(n_classes):
            if ctss not in unique:
                # missing classes get the current max weight inserted at
                # their position (data_sampler.py:25-28)
                weights.insert(ctss, max(weights))
                stats[ctss] = 1e-5
        return np.asarray(weights), stats, unique

    def get_indices(self, rng: Optional[np.random.RandomState] = None
                    ) -> List[int]:
        rng = rng or np.random
        keys = list(self.cle_label_groups.keys())
        indices = []
        for _ in range(self.num_samples):
            label = rng.choice(keys)
            indices.append(int(rng.choice(self.cle_label_groups[label])))
        return indices

    def __iter__(self):
        # the reference reseeds from the wall clock every epoch
        # (data_sampler.py:62-64); a fixed seed makes runs reproducible
        seed = self.seed if self.seed is not None else int(time.time())
        rng = np.random.RandomState(seed)
        return iter(self.get_indices(rng))

    def __len__(self):
        return self.num_samples


def shard_indices(indices: Sequence[int], num_shards: int, shard_id: int,
                  shuffle: bool = True, epoch: int = 0,
                  drop_last: bool = False) -> np.ndarray:
    """DistributedSampler-equivalent sharding of an index list.

    shuffle=True permutes the *positions* with a per-epoch seed (what
    ``DistributedSamplerWrapper(shuffle=True)`` does via its inner
    ``DistributedSampler``), pads by wrap-around to a multiple of
    ``num_shards``, then deals ``positions[shard_id::num_shards]``.
    """
    indices = np.asarray(list(indices))
    n = len(indices)
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(epoch).permutation(n)
    if drop_last:
        per_shard = n // num_shards
        order = order[:per_shard * num_shards]
    else:
        pad = (-n) % num_shards
        if pad:
            order = np.concatenate([order, order[:pad]])
    return indices[order[shard_id::num_shards]]
