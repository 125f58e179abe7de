"""ParamMap: the single configuration mechanism, as in `libyafaray_tpu/params.py`.

A dict with typed getters whose keys follow the reference's ParamMap names,
so scene descriptions written for the JAX package read the same here.
"""
from __future__ import annotations

import numpy as np


class ParamMap(dict):
    """A dict with typed getters."""

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        return bool(self.get(key, default))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self.get(key, default))

    def get_string(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))

    def get_vector(self, key: str, default=(0.0, 0.0, 0.0)) -> np.ndarray:
        return np.asarray(self.get(key, default), dtype=np.float32).reshape(3)

    def get_color(self, key: str, default=(0.0, 0.0, 0.0, 1.0)) -> np.ndarray:
        v = np.asarray(self.get(key, default), dtype=np.float32).ravel()
        if v.size == 1:
            v = np.array([v[0], v[0], v[0], 1.0], np.float32)
        elif v.size == 3:
            v = np.concatenate([v, [1.0]]).astype(np.float32)
        return v[:4]

    def get_matrix(self, key: str, default=None) -> np.ndarray:
        if key not in self and default is None:
            return np.eye(4, dtype=np.float32)
        return np.asarray(self.get(key, default),
                          dtype=np.float32).reshape(4, 4)
