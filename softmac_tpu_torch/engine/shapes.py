"""Particle shapes of a scene (``softmac_tpu/engine/shapes.py``).

All four shapes are ported: ``"predefined"``, a particle set (positions,
or a packed ``(N, 24)`` state) loaded from a ``.npy`` file; ``"box"``,
uniform samples in an axis-aligned box; ``"sphere"``, uniform samples in a
ball; and ``"cylinder"``, uniform samples in a y-axis cylinder (the cloth
variant's, ``soft_cloth/engine/shapes/shape_maker.py:65-73``). A sampled
shape is optionally rotated about its mean by ``init_rot`` (a wxyz
quaternion). Sampling is seeded with NumPy seed 0 as in the reference
(``shape_maker.py:20``), and the global NumPy random state is restored
afterwards, so the particles match the JAX package's ``Shapes`` bit for
bit. Each shape keeps its colour for the renderer: the ``color`` of its
spec (an 0xRRGGBB integer, or one per particle), else the next of
``COLORS``.
"""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch.engine import quat as Q

COLORS = [
    (127 << 16) + 127,
    (127 << 8),
    127,
    127 << 16,
]


def _parse(key, value):
    """Numeric shape params may be string literals (reference configs)."""
    if isinstance(value, str) and key not in ("shape", "path"):
        return ast.literal_eval(value)
    return value


class Shapes:
    def __init__(self, cfg, search_dirs=(".",)):
        self.objects = []
        self.colors = []
        self.dim = 3
        self.search_dirs = [str(d) for d in search_dirs]
        samplers = {"box": self.add_box, "sphere": self.add_sphere,
                    "cylinder": self.add_cylinder,
                    "predefined": self.add_predefined}
        state = np.random.get_state()
        np.random.seed(0)  # fixed seed, reference parity
        try:
            for spec in cfg:
                if spec["shape"] not in samplers:
                    raise NotImplementedError(
                        f"Shape {spec['shape']} is not supported!")
                samplers[spec["shape"]](**{k: _parse(k, v)
                                           for k, v in spec.items()
                                           if k != "shape"})
        finally:
            np.random.set_state(state)

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

    def add_object(self, particles, color=None, init_rot=None):
        if init_rot is not None:
            m = Q.quat2mat(torch.as_tensor(init_rot, dtype=torch.float64))
            m = m.numpy()
            origin = particles[:, :self.dim].mean(axis=0)
            particles[:, :self.dim] = ((particles[:, :self.dim] - origin)
                                       @ m.T + origin)
        self.objects.append(particles)
        if color is None or isinstance(color, int):
            tmp = COLORS[len(self.objects) - 1] if color is None else color
            color = np.full(len(particles), tmp, np.int32)
        self.colors.append(color)

    @staticmethod
    def get_n_particles(volume):
        return max(int(volume / 0.2 ** 3) * 10000, 1)

    def add_box(self, init_pos, width, n_particles=10000, color=None,
                init_rot=None):
        """Uniform in the axis-aligned box."""
        width = (np.array([width] * self.dim)
                 if isinstance(width, (int, float)) else np.array(width))
        if n_particles is None:
            n_particles = self.get_n_particles(np.prod(width))
        p = ((np.random.random((n_particles, self.dim)) * 2 - 1)
             * (0.5 * width) + np.array(init_pos))
        self.add_object(p, color, init_rot=init_rot)

    def add_sphere(self, init_pos, radius, n_particles=10000, color=None,
                   init_rot=None):
        """Uniform in the ball."""
        if n_particles is None:
            n_particles = self.get_n_particles(radius ** 3 * 4 * np.pi / 3)
        p = np.random.normal(size=(n_particles, self.dim))
        p /= np.linalg.norm(p, axis=-1, keepdims=True)
        u = np.random.random(size=(n_particles, 1)) ** (1.0 / self.dim)
        p = p * u * radius + np.array(init_pos)[:self.dim]
        self.add_object(p, color, init_rot=init_rot)

    def add_cylinder(self, init_pos, radius, height, n_particles=10000,
                     color=None, init_rot=None):
        """Uniform in the y-axis cylinder."""
        if n_particles is None:
            n_particles = self.get_n_particles(np.pi * radius ** 2 * height)
        theta = np.random.random(n_particles) * 2 * np.pi
        r = np.sqrt(np.random.random(n_particles)) * radius
        y = (np.random.random(n_particles) - 0.5) * height
        p = np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=-1) \
            + np.array(init_pos)
        self.add_object(p, color, init_rot=init_rot)

    def add_predefined(self, path, offset=None, color=None):
        """Particles (or packed states) from an ``.npy`` file."""
        if offset is None:
            offset = np.zeros(self.dim)
        p = np.load(self._resolve(path))
        p[:, : self.dim] += offset
        self.add_object(p, color)

    def get(self):
        """All particles, (N, 3) positions or (N, 24) packed states, and
        their colours (N,)."""
        if not self.objects:
            raise ValueError("please add at least one shape into the scene")
        return np.concatenate(self.objects), np.concatenate(self.colors)
