"""Particle shapes of a scene (``softmac_tpu/engine/shapes.py``).

Only the ``"predefined"`` shape is ported: a particle set (positions, or a
packed ``(N, 24)`` state) loaded from a ``.npy`` file. The sampled shapes
(box, sphere, cylinder) come with the slice that ports the scenes using them.
"""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np


def _parse(key, value):
    """Numeric shape params may be string literals (reference configs)."""
    if isinstance(value, str) and key not in ("shape", "path"):
        return ast.literal_eval(value)
    return value


class Shapes:
    def __init__(self, cfg, search_dirs=(".",)):
        self.objects = []
        self.dim = 3
        self.search_dirs = [str(d) for d in search_dirs]
        for spec in cfg:
            if spec["shape"] != "predefined":
                raise NotImplementedError(
                    f"shape {spec['shape']!r} is not ported yet; the PyTorch "
                    "port supports 'predefined' shapes only")
            self.add_predefined(**{k: _parse(k, v) for k, v in spec.items()
                                   if k != "shape"})

    def _resolve(self, path):
        p = Path(path)
        if p.exists():
            return p
        for d in self.search_dirs:
            cand = Path(d) / p
            if cand.exists():
                return cand
        raise FileNotFoundError(
            f"shape data file {path} not found in {self.search_dirs}")

    def add_predefined(self, path, offset=None, color=None):
        """``color`` is for the renderer, which is not ported yet."""
        if offset is None:
            offset = np.zeros(self.dim)
        p = np.load(self._resolve(path))
        p[:, : self.dim] += offset
        self.objects.append(p)

    def get(self) -> np.ndarray:
        """All particles, (N, 3) positions or (N, 24) packed states."""
        if not self.objects:
            raise ValueError("please add at least one shape into the scene")
        return np.concatenate(self.objects)
