"""Dataset splits and samplers (reference utils.py:76-132, 354-456,
__main__.py:153-176).

Host-side index math in numpy, the same code as the JAX package's
data/sampling.py: with the same numpy random state, split membership,
sampling weights and batch indices are identical.
"""
from __future__ import annotations

from math import ceil, floor
from typing import Iterator, Sequence

import numpy as np

from ..config import WOOD_TYPES


def get_splits(targets: Sequence[np.ndarray], wood_types: Sequence[str],
               rng: np.random.RandomState,
               train_percent: float = 0.8, valid_percent: float = 0.1):
    """Stratified 80/10/10 split + exp-weighted train sampling weights
    (reference get_splits, utils.py:76-132):
    - per-sample weight = number of non-background target pixels, normalized
    - per wood type: shuffle, ceil(80%) train / floor(10%) valid / rest test
    - wood-type weight = inverse frequency, normalized
    - train weight = exp(type_weight * sample_weight), restricted to the
      train split, normalized.

    targets: per-sample int label maps, or their non-zero pixel counts.
    Returns (train_split, valid_split, test_split, train_weights).
    """
    total_items = len(targets)
    type_to_idx = {t: i for i, t in enumerate(WOOD_TYPES)}

    idxs_by_type: list[list[int]] = [[] for _ in WOOD_TYPES]
    sample_weight = np.zeros(total_items, dtype=np.float64)
    for i, (target, wood_type) in enumerate(zip(targets, wood_types)):
        idxs_by_type[type_to_idx[wood_type]].append(i)
        t = np.asarray(target)
        sample_weight[i] = float(t) if t.ndim == 0 \
            else float(np.count_nonzero(t))
    sample_weight /= sample_weight.sum()

    train_split, valid_split, test_split = [], [], []
    wood_type_weights = []
    for idx in range(len(idxs_by_type)):
        arr = np.asarray(idxs_by_type[idx])
        rng.shuffle(arr)
        n_data = len(arr)
        if n_data == 0:
            # the reference divides by zero here (utils.py:109); a zero
            # weight leaves the normalization over the present types as
            # it is when all three are present
            wood_type_weights.append(0.0)
            continue
        wood_type_weights.append(total_items / (3 * n_data))
        n_train = int(ceil(train_percent * n_data))
        n_valid = int(floor(valid_percent * n_data))
        train_split.extend(arr[:n_train])
        valid_split.extend(arr[n_train:n_train + n_valid])
        test_split.extend(arr[n_train + n_valid:])

    wood_type_weights = np.asarray(wood_type_weights)
    wood_type_weights /= wood_type_weights.sum()
    train_weights = np.zeros(total_items, dtype=np.float64)
    for i, wood_type in enumerate(wood_types):
        train_weights[i] = (wood_type_weights[type_to_idx[wood_type]]
                            * sample_weight[i])

    train_split = np.asarray(train_split)
    valid_split = np.asarray(valid_split)
    test_split = np.asarray(test_split)
    train_weights = np.exp(train_weights)[train_split]
    train_weights /= train_weights.sum()
    return train_split, valid_split, test_split, train_weights


def weighted_batch_iterator(weights: np.ndarray, batch_size: int,
                            rng: np.random.RandomState,
                            num_samples_factor: int = 12,
                            drop_last: bool = True
                            ) -> Iterator[np.ndarray]:
    """WeightedRandomSampler(num_samples=len*12, replacement=True) wrapped in
    BatchSampler(drop_last=True), reference __main__.py:168-171. Yields
    indices into the weights array (callers map them through their
    split)."""
    num_samples = len(weights) * num_samples_factor
    p = np.asarray(weights, dtype=np.float64)
    p = p / p.sum()
    draws = rng.choice(len(weights), size=num_samples, replace=True, p=p)
    end = (num_samples // batch_size) * batch_size if drop_last \
        else num_samples
    for start in range(0, end, batch_size):
        yield draws[start:start + batch_size]


class PrioritizedSampler:
    """Prioritized replay sampler (reference utils.py:354-456): batch weights
    updated from a running metric, w <- w*(n-1)/n + metric/n per visit."""

    def __init__(self, num_items: int, batch_size: int,
                 num_samples: int, rng: np.random.RandomState,
                 metric_mode: str = "max"):
        if metric_mode not in ("min", "max"):
            raise AttributeError(
                "metric_mode has to be either 'min' or 'max'")
        self.weights = np.ones(num_items, dtype=np.float64)
        self.num_visited = np.zeros(num_items, dtype=np.float64)
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.metric_mode = metric_mode
        self._rng = rng

    def __iter__(self) -> Iterator[np.ndarray]:
        n_batches = self.num_samples // self.batch_size
        for _ in range(n_batches):
            p = self.weights / self.weights.sum()
            yield self._rng.choice(len(self.weights), self.batch_size,
                                   replace=True, p=p)

    def __len__(self) -> int:
        return self.num_samples // self.batch_size

    def update(self, batch_idxs: np.ndarray, metric_value: float) -> None:
        """Per-batch weight update (utils.py:403-412)."""
        if self.metric_mode == "min":
            metric_value = 1 - metric_value
        self.num_visited[batch_idxs] += 1
        n = self.num_visited[batch_idxs]
        w = self.weights[batch_idxs]
        self.weights[batch_idxs] = w * (n - 1) / n + metric_value / n

    def stats(self) -> dict:
        """Train-end summary (utils.py:414-456)."""
        return {
            "most_visited": (int(self.num_visited.argmax()),
                             float(self.num_visited.max())),
            "least_visited": (int(self.num_visited.argmin()),
                              float(self.num_visited.min())),
            "avg_visits": float(self.num_visited.mean()),
            "biggest_weight": (int(self.weights.argmax()),
                               float(self.weights.max())),
            "smallest_weight": (int(self.weights.argmin()),
                                float(self.weights.min())),
            "avg_weight": float(self.weights.mean()),
        }
