"""Sublinear-communication quantization (paper §7); counterpart of
``repro.core.sublinear``, numpy on the host and small-d by design.

Two pieces:

1. ``SublinearLattice`` — an *exact* small-d implementation of Algorithms 7/8
   on the cubic lattice: random offset theta ~ U(Vor(0)) = U[-s/2,s/2)^d,
   nearest-point rounding, random coloring with ``n_colors = (1+2q)^{3d}``
   realized as a shared-randomness hash over lattice coordinates, and the
   rejection loop ("successful coloring") with a fixed iteration budget.
   Decoding searches the lattice points whose Voronoi regions intersect
   B_{q eps}(x_v + theta) — exhaustive over the +-1 coordinate neighborhood,
   hence small-d only.  Used by tests to certify unbiasedness + the error
   bound; the paper itself states a naive implementation is infeasible in
   high d (§9.2 Exp 4).

2. ``simulated_variance`` — the paper's Experiment-4 protocol: for a bit
   budget b = d*log2(1+4y/s), the coordinate-wise dither gives variance
   d*s^2/12; used by benchmarks/bench_sublinear.py to reproduce Figures 7-8.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

_M64 = (1 << 64) - 1


def _hash_color(k: np.ndarray, seed: int, n_colors: int) -> int:
    """Deterministic shared-randomness coloring of an integer lattice point."""
    h = (seed * 0x9E3779B97F4A7C15 + 0xDA3E39CB94B95BDB) & _M64
    for v in k.astype(np.int64).tolist():
        h = ((h ^ ((v * 0xBF58476D1CE4E5B9) & _M64)) * 0x94D049BB133111EB) & _M64
    return int(h % n_colors)


@dataclasses.dataclass(frozen=True)
class SublinearLattice:
    """Exact cubic-lattice instance of paper Algorithms 7/8 (small d)."""
    s: float                  # lattice side (2*eps with eps = packing radius)
    q: float                  # decode radius parameter (ball radius q*eps)
    d: int
    max_iters: int = 64

    @property
    def eps(self) -> float:
        return self.s / 2.0

    @property
    def n_colors(self) -> int:
        # (1 + 2q)^{3d} capped for practicality
        return int(min(float(1 + 2 * self.q) ** (3 * self.d), 2 ** 62))

    def bits(self) -> float:
        return 3 * self.d * float(np.log2(1 + 2 * self.q))

    # -- encode -------------------------------------------------------------
    def encode(self, x: np.ndarray, rng: np.random.Generator):
        """Returns (color, i, theta_seed) and diagnostics."""
        for i in range(self.max_iters):
            theta = rng.uniform(-self.s / 2, self.s / 2, self.d)
            z = np.round((x + theta) / self.s).astype(np.int64)
            seed = int(rng.integers(0, 2 ** 31))
            col = _hash_color(z, seed, self.n_colors)
            # success check: no other lattice point z' with x+theta in
            # Vor+(z') shares the color.  Vor+(z') within l2 distance
            # (sqrt(d)/2 + 2q) * s of z' — enumerate the integer box.
            if self._color_unique(x + theta, z, col, seed):
                return {"color": col, "iter": i, "seed": seed,
                        "theta": theta, "z": z}
        raise RuntimeError("sublinear encode: iteration budget exhausted")

    def _neighbors(self, center: np.ndarray, radius_cells: int):
        rngs = [range(int(c) - radius_cells, int(c) + radius_cells + 1)
                for c in center]
        return itertools.product(*rngs)

    def _color_unique(self, point: np.ndarray, z: np.ndarray, col: int,
                      seed: int) -> bool:
        # expanded Voronoi region of z' contains `point` iff
        # dist_inf(point, Vor(z')) small; for the cubic lattice
        # Vor(z') = z'*s + [-s/2, s/2)^d, expansion by 2*q*eps = q*s in l2.
        rad = int(np.ceil(0.5 + self.q))
        kc = np.round(point / self.s).astype(np.int64)
        for cand in self._neighbors(kc, rad):
            kz = np.array(cand, np.int64)
            if np.array_equal(kz, z):
                continue
            # l2 distance from point to the Voronoi cell of kz
            delta = np.abs(point - kz * self.s) - self.s / 2
            dist = np.linalg.norm(np.clip(delta, 0, None))
            if dist <= 2 * self.q * self.eps and \
                    _hash_color(kz, seed, self.n_colors) == col:
                return False
        return True

    # -- decode -------------------------------------------------------------
    def decode(self, payload, x_v: np.ndarray) -> np.ndarray:
        theta, seed, col = payload["theta"], payload["seed"], payload["color"]
        target = x_v + theta
        rad = int(np.ceil(0.5 + self.q))
        kc = np.round(target / self.s).astype(np.int64)
        best = None
        for cand in self._neighbors(kc, rad):
            kz = np.array(cand, np.int64)
            delta = np.abs(target - kz * self.s) - self.s / 2
            dist = np.linalg.norm(np.clip(delta, 0, None))
            if dist <= self.q * self.eps and \
                    _hash_color(kz, seed, self.n_colors) == col:
                if best is not None and not np.array_equal(best, kz):
                    raise RuntimeError("ambiguous decode (coloring failed)")
                best = kz
        if best is None:
            raise RuntimeError("decode failed: no matching color in range")
        return best * self.s - theta


def simulated_variance(d: int, y: float, bits_per_coord: float) -> float:
    """Paper Exp. 4: variance of the sublinear scheme at a given bit budget.

    bits = d*log2(1 + 4y/s)  =>  s = 4y / (2^{bits/d} - 1); dither variance
    d * s^2 / 12 (uniform over [-s/2, s/2] per coordinate).
    """
    s = 4.0 * y / (2.0 ** bits_per_coord - 1.0)
    return d * s * s / 12.0


def vqsgd_cross_polytope_variance(d: int, norm: float, reps: int) -> float:
    """vQSGD [Gandikota+] cross-polytope baseline variance (Exp 4 comparison).

    Cross-polytope quantization maps x to one of 2d scaled basis vectors
    +-sqrt(d)*||x||*e_i; with R independent repetitions averaged, the
    variance is (d*||x||^2 - ||x||^2)/R <= d*||x||^2/R, at R*ceil(log2 2d)
    bits.  We report the standard upper bound.
    """
    return d * norm * norm / max(reps, 1)
