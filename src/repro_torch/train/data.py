"""Deterministic synthetic data; counterpart of ``repro.train.data``.

Stateless-seeded: ``batch_at(step)`` is a pure function of (seed, step,
shape), so a restarted job resumes bit-identically and any DP rank can
draw its own rows alone.  The tokens are a Zipf-ish stream with Markov
structure, drawn as the reference draws them (``random.categorical``,
``randint``, ``bernoulli``, a cumulative sum).  Every draw is
partitionable, so :func:`local_batch_at` draws only the rank's rows: the
same numbers as the rows of the global draw, never the whole of it.

The categorical draw goes through two logs, which torch may round an ulp
apart from XLA; where two categories tie to within that ulp the argmax can
flip, so a token may differ from the reference's (rarely; the tests count
how often).  ``frames_at`` uses ``random.normal``, which equals the
reference's only to ``allclose``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"      # markov | uniform


def _zipf_logits(vocab: int) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / r
    return np.log(p / p.sum()).astype(np.float32)


def batch_at(cfg: DataConfig, step: int, *, rows=None, device=None) -> dict:
    """The batch of one step: {"tokens", "targets", "mask"} (B, S); with
    ``rows=(r0, r1)`` only rows r0 .. r1 - 1 of the global batch."""
    device = resolve_device(device)
    key = _random.fold_in(_random.PRNGKey(cfg.seed), step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    shape = (B, S + 1)
    if cfg.kind == "uniform":
        toks = _random.randint(key, shape, 0, V, device=device, rows=rows)
    else:
        # order-1 Markov chain: next = (a*cur + noise) % V with Zipf resets
        k1, k2, k3 = _random.split(key, 3)
        base = _random.categorical(k1, torch.from_numpy(_zipf_logits(V)),
                                   shape, device=device, rows=rows)
        drift = torch.cumsum(_random.randint(k2, shape, 0, 7, device=device,
                                             rows=rows), dim=1,
                             dtype=torch.int32)
        reset = _random.bernoulli(k3, 0.1, shape, device=device, rows=rows)
        toks = torch.where(reset, base, (base[:, :1] * 31 + drift) % V)
        toks = toks.to(torch.int32)
    b = toks.shape[0]
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": torch.ones((b, S), dtype=torch.float32, device=device)}


def local_batch_at(cfg: DataConfig, step: int, dp_rank: int, dp_size: int,
                   *, device=None) -> dict:
    """The dp_rank-th slice of the global batch, drawn alone."""
    b_loc = cfg.global_batch // dp_size
    return batch_at(cfg, step, rows=(dp_rank * b_loc, (dp_rank + 1) * b_loc),
                    device=device)


def frames_at(cfg: DataConfig, step: int, n_frames: int, d_model: int, *,
              rows: Optional[tuple] = None, device=None) -> torch.Tensor:
    """Stub modality frontend (vlm patches): deterministic pseudo-embeddings
    (B, n_frames, d_model), or rows r0 .. r1 - 1 of them."""
    key = _random.fold_in(_random.PRNGKey(cfg.seed + 7_777), step)
    return _random.normal(key, (cfg.global_batch, n_frames, d_model),
                          device=device, rows=rows)
