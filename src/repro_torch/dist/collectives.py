"""Quantized mean collectives over ``torch.distributed`` (paper §4, §9.1);
counterpart of ``repro.dist.collectives``.

* :func:`allgather_allreduce_mean` — the star (Algorithm 3 analogue):
  every rank all-gathers the packed colors and decodes every sender
  against its own vector in one batched decode; the integer sum of the
  decoded coordinates gives a mean that is bit-identical on every rank.
* :func:`butterfly_allreduce_mean` — recursive doubling (Algorithm 4
  analogue): in round ``r`` rank ``i`` exchanges its quantized running
  average with rank ``i XOR 2^r`` and both average in integer coordinate
  space, so partners, and after ``log2(world)`` rounds every rank, hold
  the same bits.
* :func:`rh_reduce_scatter_mean` — recursive-halving reduce-scatter of the
  mean: round ``r`` sends the half of the working segment the partner
  keeps; rank ``i`` ends with bucket-aligned segment ``i``.

All three work per bucket (``cfg.bucket`` coordinates, each bucket with
its own bound ``y_b`` and side ``s_b = 2 y_b / (q-1)``), optionally
HD-rotated per bucket (§6), and take a bare per-bucket ``y`` or a
:class:`~repro_torch.core.qstate.QState` whose anchor is subtracted before
encoding.  With ``cfg.packed`` the wire carries the packed words and the
per-bucket sides sidecar through the fused kernels; ``packed=False`` moves
one int32 color per coordinate through the plain lattice ops.  The two
paths give the same bits.

Where the reference names a ``jax.shard_map`` axis, the port takes a
``torch.distributed`` process group (``group=None``: the default group).
Every float step repeats the reference's operations in its order (the
anchored exits ``t * s + anchor``, which the reference's compiled program
fuses into one multiply-add, are rounded once as it rounds them), and
telemetry comes from integer coordinate deltas, so unrotated outputs and
all per-bucket telemetry equal the reference's bit for bit.  Rotated means
differ by rounding: the reference's inverse FWHT is its Pallas kernel
(packed) or fuses the last scale into its first stage (unpacked), while
the port runs the plain stage order on both paths.  On the card the
kernels get per-bucket sides with ``bucket``; the (n,) per-coordinate
repeat the reference builds never exists.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist

from repro_torch import random as _random
from repro_torch.core import bucketing as B
from repro_torch.core import lattice as L
from repro_torch.core import qstate as QS
from repro_torch.core import rotation as R
from repro_torch.core import wire_accounting as WA
from repro_torch.core.qstate import QState
from repro_torch.kernels import ops as K

# Fixed seed for the shared-randomness Hadamard diagonal: every party
# derives the same D without communication (one agreed constant stands in
# for the d shared bits of §6).
_ROTATION_SEED = 20210507
# elements (across all senders) per column chunk of the star's epilogue:
# its temporaries stay near a GB at any width
_EPILOGUE_ELEMS = 1 << 26


class QSyncAux(NamedTuple):
    """Telemetry emitted by every collective.

    fails:    () f32 — number of detected decode failures.
    max_dist: () f32 — max observed |decoded - anchor|_inf (bucket space).
    y_next:   () f32 — suggested distance bound for the next step.
    fails_b:  (nb,) f32 — decode failures attributed per bucket.
    dist_b:   (nb,) f32 — per-bucket max |decoded - anchor|_inf.
    y_seg:    rh only: the kept segment's per-bucket y (nb/world,).
    """
    fails: torch.Tensor
    max_dist: torch.Tensor
    y_next: torch.Tensor
    fails_b: Optional[torch.Tensor] = None
    dist_b: Optional[torch.Tensor] = None
    y_seg: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class QSyncConfig:
    """Static config of the quantized sync path.

    q:      number of mod-q color classes; wire cost bits_for_q(q) bits/coord
            and lattice side s = 2*y/(q-1) for distance bound y.
    bucket: coordinates per bucket (power of two); each bucket has its own
            y / s and (optionally) its own Hadamard rotation block.
    rotate: pre-rotate buckets with the shared-randomness HD transform
            (paper §6) so adversarially-concentrated coordinates spread out.
    packed: carry packed uint32 words plus the per-bucket sides sidecar on
            the wire, through the fused kernels; False moves one int32
            color per coordinate through the plain lattice ops (the same
            bits, 8x the bytes at q=16).
    """
    q: int = 16
    bucket: int = 4096
    rotate: bool = False
    packed: bool = True

    def __post_init__(self):
        if self.q < 2:
            raise ValueError("q must be >= 2")
        b = self.bucket
        if b < 1 or (b & (b - 1)) != 0:
            raise ValueError(f"bucket must be a power of two, got {b}")

    @property
    def bits(self) -> int:
        return L.bits_for_q(self.q)

    @property
    def spec(self) -> L.LatticeSpec:
        return L.LatticeSpec(self.q)


def flat_size_padded(n: int, cfg: Union[QSyncConfig, int]) -> int:
    """Smallest multiple of the bucket size >= n (flat wire length)."""
    b = cfg.bucket if isinstance(cfg, QSyncConfig) else int(cfg)
    return B.padded_size(n, b)


def _bucket_diag(bucket: int, device=None) -> torch.Tensor:
    """Shared-randomness ±1 diagonal for the per-bucket HD rotation."""
    return R.rotation_keypair(_random.PRNGKey(_ROTATION_SEED), bucket,
                              device=device)


def _bucketize(x: torch.Tensor, cfg: QSyncConfig) -> torch.Tensor:
    """Flat (n,) -> (n_buckets, bucket) f32, zero-padded; HD-rotated per
    bucket when cfg.rotate.  The packed path rotates through the FWHT
    kernel (on the card), the unpacked path through the plain FWHT."""
    diag = _bucket_diag(cfg.bucket, x.device) if cfg.rotate else None
    return B.bucketize(x, cfg.bucket, diag=diag, use_kernel=cfg.packed)


def _unbucketize(b: torch.Tensor, n: int, cfg: QSyncConfig) -> torch.Tensor:
    """Inverse of _bucketize: (n_buckets, bucket) -> flat (n,)."""
    diag = _bucket_diag(cfg.bucket, b.device) if cfg.rotate else None
    return B.unbucketize(b, n, diag=diag, use_kernel=cfg.packed)


def _sides(y_buckets: torch.Tensor, cfg: QSyncConfig) -> torch.Tensor:
    """(nb,) distance bounds -> (nb, 1) lattice sides s = 2y/(q-1).  Every
    division by a side below is a true IEEE division (never a reciprocal
    multiply), as the reference pins it."""
    return cfg.spec.side(y_buckets.to(torch.float32))[:, None]


def _bucket_fails(k: torch.Tensor, k_ref: torch.Tensor, s_col: torch.Tensor,
                  y_col: torch.Tensor):
    """Per-bucket decode-failure counts and max distances, in coordinate
    space.

    k, k_ref: int32 lattice coordinates (..., nb, bucket) on the same (u, s)
    lattice; s_col, y_col: (nb, 1).  Returns (fails_b (nb,), dist_b (nb,)),
    reduced over any leading axes.  Distances are ``|k - k_ref| * s``: an
    exact int subtract and one rounded multiply, so every program computes
    the same bits from the same coords.
    """
    dist_ = (k - k_ref).abs().to(torch.float32) * s_col
    failed = (dist_ > 1.5 * y_col).any(dim=-1).to(torch.float32)
    dist_b = dist_.amax(dim=-1)
    if failed.dim() > 1:
        lead = tuple(range(failed.dim() - 1))
        return failed.sum(dim=lead), dist_b.amax(dim=lead)
    return failed, dist_b


def _encode(xb: torch.Tensor, s: torch.Tensor, u: torch.Tensor
            ) -> torch.Tensor:
    """Deterministic dithered encode: integer coords of every bucket."""
    return L.encode_coords(xb, s, u)


# ---------------------------------------------------------------------------
# Packed wire path (fused kernels; repro_torch.kernels.ops)
# ---------------------------------------------------------------------------

def _encode_packed(xb: torch.Tensor, sides: torch.Tensor, u: torch.Tensor,
                   cfg: QSyncConfig, return_coords: bool = False,
                   anchor: Optional[torch.Tensor] = None):
    """Fused encode of bucketized xb -> packed words (int32 bit view).

    xb, u: (nb, bucket); sides: (nb,) per-bucket, passed as they are;
    anchor: optional (nb, bucket) anchor subtracted in the kernel.  Returns
    the words (packed_len(n, bits),), plus the int32 coords (nb, bucket)
    when return_coords."""
    a_flat = anchor.reshape(-1) if anchor is not None else None
    out = K.lattice_encode(xb.reshape(-1), u.reshape(-1), sides, q=cfg.q,
                           return_coords=return_coords, anchor=a_flat,
                           bucket=xb.shape[-1])
    if return_coords:
        return out[0], out[1].reshape(xb.shape)
    return out


def _decode_packed(words: torch.Tensor, anchor: torch.Tensor,
                   sides: torch.Tensor, u: torch.Tensor, cfg: QSyncConfig,
                   mode: str = "point",
                   ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused decode of one payload's words against the local anchor.

    anchor, u: (nb, bucket); sides: (nb,), the *received* sidecar; ref:
    optional (nb, bucket) anchor the sender subtracted.  Returns the decoded
    points (mode="point") or int32 coords (mode="coords"), shaped like
    anchor."""
    r_flat = ref.reshape(-1) if ref is not None else None
    out = K.lattice_decode(words, anchor.reshape(-1), u.reshape(-1), sides,
                           q=cfg.q, mode=mode, ref=r_flat,
                           bucket=anchor.shape[-1])
    return out.reshape(anchor.shape)


def _add_anchor(t: torch.Tensor, s: torch.Tensor, ab: torch.Tensor
                ) -> torch.Tensor:
    """The anchored exit ``t * s + ab`` over (nb, bucket), rounded once: the
    reference's compiler fuses the last round's scale with the anchor's
    add.  Rows go in chunks so the f64 temporaries stay near a GB."""
    out = torch.empty_like(ab)
    step = max(1, _EPILOGUE_ELEMS // 4 // ab.shape[-1])
    for b0 in range(0, ab.shape[0], step):
        sl = slice(b0, b0 + step)
        out[sl] = L.fma_f32(t[sl], s[sl], ab[sl])
    return out


def _check_buckets(xb: torch.Tensor, y_buckets: torch.Tensor):
    if y_buckets.shape[0] != xb.shape[0]:
        raise ValueError(
            f"y_buckets has {y_buckets.shape[0]} entries for {xb.shape[0]} "
            f"buckets (vector padded to a whole number of buckets)")


# ---------------------------------------------------------------------------
# The rank axis: a torch.distributed process group
# ---------------------------------------------------------------------------

def _axis_size(group=None) -> int:
    return dist.get_world_size(group)


def _axis_index(group=None) -> int:
    return dist.get_rank(group)


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses through host memory: gloo moves host buffers
    only, so a CUDA tensor in a gloo group (several ranks sharing one card,
    where NCCL refuses) is copied to pinned host memory and back.  With an
    NCCL group (one rank per card) tensors go as they are.  Either way the
    kernels run on the card: this is the group's transport, not a
    fallback."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _as_bytes(t: torch.Tensor):
    """16-bit floats cross a group as their bytes (exact, and a type every
    backend moves): (view, dtype to view the result back as, or None)."""
    if t.dtype in (torch.bfloat16, torch.float16) and t.dim() > 0:
        return t.contiguous().view(torch.uint8), t.dtype
    return t, None


def _all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: (world, *t.shape), on
    ``t``'s device."""
    t, back = _as_bytes(t)
    world = _axis_size(group)
    staged = _host_staged(t, group)
    src = _to_host(t) if staged else t.contiguous()
    out = torch.empty((world,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device, pin_memory=staged)
    if dist.get_backend(group) == dist.Backend.GLOO:
        dist.all_gather(list(out.unbind(0)), src, group=group)
    else:
        dist.all_gather_into_tensor(out.view(-1), src.view(-1), group=group)
    out = out.to(t.device) if staged else out
    return out if back is None else out.view(back)


def _ppermute(t: torch.Tensor, perm, group=None) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) rank
    pairs; returns the tensor this rank receives (zeros when none), on
    ``t``'s device.  Sends and receives go as one
    ``batch_isend_irecv``."""
    t, back = _as_bytes(t)
    rank = _axis_index(group)
    staged = _host_staged(t, group)
    send = _to_host(t) if staged else t.contiguous()
    recv = torch.zeros(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=staged)

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    ops = []
    for src, dst in perm:
        if src == rank:
            ops.append(dist.P2POp(dist.isend, send, peer(dst), group))
        if dst == rank:
            ops.append(dist.P2POp(dist.irecv, recv, peer(src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    recv = recv.to(t.device) if staged else recv
    return recv if back is None else recv.view(back)


# ---------------------------------------------------------------------------
# Star analogue (paper Algorithm 3): all-gather colors, decode locally
# ---------------------------------------------------------------------------

def allgather_allreduce_mean(x_local: torch.Tensor,
                             state: Union[QState, torch.Tensor], key,
                             cfg: QSyncConfig, group=None
                             ) -> "tuple[torch.Tensor, QSyncAux]":
    """Mean over the group's ranks of per-rank vectors, star-style.

    Every rank sends its colors once (all-gather) and decodes every sender
    against its *own* vector in one batched decode; successful decodes
    recover the senders' exact lattice points, so outputs are
    bit-identical across ranks.  ``state`` is a :class:`QState` or a bare
    (nb,) per-bucket y (zero anchor); ``key`` the shared dither's key.

    The epilogue (telemetry, integer sum, mean) runs over column chunks of
    buckets so its temporaries stay near a GB at any width.

    Returns (mean (n,), QSyncAux).
    """
    qs = QS.as_qstate(state)
    y_buckets = qs.y
    n = x_local.shape[0]
    xb = _bucketize(x_local, cfg)
    _check_buckets(xb, y_buckets)
    ab = _bucketize(qs.anchor, cfg) if qs.anchor is not None else None
    s = _sides(y_buckets, cfg)
    u = L.shared_offset(key, tuple(xb.shape), device=xb.device)

    world, rank = _axis_size(group), _axis_index(group)
    if cfg.packed:
        sides = s[:, 0].contiguous()
        words = _encode_packed(xb, sides, u, cfg, anchor=ab)
        all_words = _all_gather(words, group)               # (world, nw)
        all_sides = _all_gather(sides, group)               # (world, nb)
        # one batched launch over all senders, each with its own sidecar
        k = K.lattice_decode_batched(
            all_words, xb.reshape(-1), u.reshape(-1), all_sides, q=cfg.q,
            mode="coords", ref=None if ab is None else ab.reshape(-1),
            bucket=cfg.bucket)
        k = k.reshape((world,) + tuple(xb.shape))           # (world, nb, b)
    else:
        # anchor-relative frame (xr == xb when unanchored)
        xr = xb if ab is None else xb - ab
        colors = L.color_of(_encode(xr, s, u), cfg.q)
        all_colors = _all_gather(colors, group)             # (world, nb, b)
        k = L.decode_coords(all_colors, xr[None], s, u, q=cfg.q)
    del xb

    nb = k.shape[1]
    y_col = y_buckets.to(torch.float32)[:, None]
    wt = torch.tensor(float(world), device=k.device)        # true division
    mean_b = torch.empty(tuple(k.shape[1:]), dtype=torch.float32,
                         device=k.device)
    fails_b = torch.empty(nb, dtype=torch.float32, device=k.device)
    dist_b = torch.empty(nb, dtype=torch.float32, device=k.device)
    dev = torch.zeros((), dtype=torch.float32, device=k.device)
    step = max(1, _EPILOGUE_ELEMS // (world * cfg.bucket))
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        kc, sc = k[:, b0:b1], s[b0:b1]
        # own decode is exact, so k[rank] is this rank's own lattice point:
        # the coordinate-space reference of the distance telemetry
        fails_b[b0:b1], dist_b[b0:b1] = _bucket_fails(
            kc, kc[rank:rank + 1], sc, y_col[b0:b1])
        # average in integer space: the int sum is exact and order-free
        kmean = kc.sum(dim=0, dtype=torch.int32).to(torch.float32) / wt
        t = kmean + u[b0:b1]
        mean_b[b0:b1] = (t * sc if ab is None
                         else L.fma_f32(t, sc, ab[b0:b1]))
        dev = torch.maximum(dev, ((kc.to(torch.float32) - kmean[None]).abs()
                                  * sc).amax())
    del k
    aux = QSyncAux(fails=fails_b.sum(), max_dist=dist_b.amax(),
                   y_next=2.5 * dev, fails_b=fails_b, dist_b=dist_b)
    return _unbucketize(mean_b, n, cfg), aux


# ---------------------------------------------------------------------------
# Tree analogue (paper Algorithm 4): recursive doubling
# ---------------------------------------------------------------------------

def _log2_world(world: int, what: str) -> int:
    if world & (world - 1):
        raise ValueError(f"{what} needs a power-of-two world, got {world}")
    return world.bit_length() - 1


def butterfly_allreduce_mean(x_local: torch.Tensor,
                             state: Union[QState, torch.Tensor], key,
                             cfg: QSyncConfig, group=None
                             ) -> "tuple[torch.Tensor, QSyncAux]":
    """Mean over the group's ranks, butterfly (recursive-doubling)
    topology.

    log2(world) rounds; round r pairs rank i with i XOR 2^r.  Both partners
    average the *quantized* coordinates (own + partner's) in integer
    space, so pairs, and after all rounds every rank, hold bit-identical
    values; the error grows by at most s/2 per coordinate per round.  With
    cfg.packed each hop carries packed words and the sides sidecar, and the
    fused encode also returns the local coords.  With an anchor the rounds
    iterate in anchor-relative space (subtracted once at entry, added back
    at exit).

    Returns (mean (n,), QSyncAux).
    """
    qs = QS.as_qstate(state)
    y_buckets = qs.y
    n = x_local.shape[0]
    world, rank = _axis_size(group), _axis_index(group)
    rounds = _log2_world(world, "butterfly")
    cur = _bucketize(x_local, cfg)
    _check_buckets(cur, y_buckets)
    ab = _bucketize(qs.anchor, cfg) if qs.anchor is not None else None
    if ab is not None:
        cur = cur - ab
    s = _sides(y_buckets, cfg)
    y_col = y_buckets.to(torch.float32)[:, None]

    nb = cur.shape[0]
    fails_b = torch.zeros(nb, dtype=torch.float32, device=cur.device)
    dist_b = torch.zeros(nb, dtype=torch.float32, device=cur.device)
    for r in range(rounds):
        u = L.shared_offset(_random.fold_in(key, r), tuple(cur.shape),
                            device=cur.device)
        perm = [(i, i ^ (1 << r)) for i in range(world)]
        if cfg.packed:
            sides = s[:, 0].contiguous()
            words, k_own = _encode_packed(cur, sides, u, cfg,
                                          return_coords=True)
            w_partner = _ppermute(words, perm, group)
            sides_partner = _ppermute(sides, perm, group)
            k_partner = _decode_packed(w_partner, cur, sides_partner, u, cfg,
                                       mode="coords")
        else:
            k_own = _encode(cur, s, u)
            c_partner = _ppermute(L.color_of(k_own, cfg.q), perm, group)
            k_partner = L.decode_coords(c_partner, cur, s, u, q=cfg.q)
        f_b, d_b = _bucket_fails(k_partner, k_own, s, y_col)
        fails_b = fails_b + f_b
        dist_b = torch.maximum(dist_b, d_b)
        # average in integer space: partners compute the same bits
        t = 0.5 * (k_own + k_partner).to(torch.float32) + u
        cur = t * s
        del u, k_own, k_partner

    if ab is not None:
        cur = cur + ab if rounds == 0 else _add_anchor(t, s, ab)
    max_dist = dist_b.amax()
    aux = QSyncAux(fails=fails_b.sum(), max_dist=max_dist,
                   y_next=2.5 * max_dist, fails_b=fails_b, dist_b=dist_b)
    return _unbucketize(cur, n, cfg), aux


# ---------------------------------------------------------------------------
# Recursive-halving reduce-scatter (the FSDP gradient path)
# ---------------------------------------------------------------------------

def rh_reduce_scatter_mean(x_local: torch.Tensor,
                           state: Union[QState, torch.Tensor], key,
                           cfg: QSyncConfig, group=None
                           ) -> "tuple[torch.Tensor, QSyncAux]":
    """Reduce-scatter of the mean via quantized recursive halving.

    Round r pairs rank i with i XOR (world >> (r+1)); each sends (quantized)
    the half of its working segment the partner keeps, decodes the received
    half against its own, and averages own + received lattice coordinates
    in integer space.  After log2(world) rounds rank i holds bucket-aligned
    segment i of the mean: shape (padded_n / world,).  An anchor is
    subtracted once at entry and the kept segment's slice added back at
    exit.  ``aux.y_seg`` / ``fails_b`` / ``dist_b`` describe the kept
    segment per bucket.

    Requires the padded bucket count to divide evenly by the world size
    (see :func:`repro_torch.dist.fsdp.pad_to_shardable`).
    """
    qs = QS.as_qstate(state)
    y_buckets = qs.y
    world, rank = _axis_size(group), _axis_index(group)
    rounds = _log2_world(world, "recursive halving")
    cur = _bucketize(x_local, cfg)
    _check_buckets(cur, y_buckets)
    nb = cur.shape[0]
    if nb % world:
        raise ValueError(f"{nb} buckets not divisible by world={world}; "
                         f"pad with fsdp.pad_to_shardable first")
    ab = _bucketize(qs.anchor, cfg) if qs.anchor is not None else None
    if ab is not None:
        cur = cur - ab
    y_cur = y_buckets.to(torch.float32)

    dev = cur.device
    fails_b = torch.zeros(nb, dtype=torch.float32, device=dev)
    dist_b = torch.zeros(nb, dtype=torch.float32, device=dev)
    # the scalar telemetry covers every decode this rank made; the
    # per-bucket maps follow the kept lineage only
    fails = torch.zeros((), dtype=torch.float32, device=dev)
    max_dist = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(rounds):
        d = world >> (r + 1)
        half = cur.shape[0] // 2
        u_full = L.shared_offset(_random.fold_in(key, r), tuple(cur.shape),
                                 device=dev)
        # bit 0: keep the low half and send the high half (and vice versa);
        # the msb-first sweep leaves rank i with segment i of the vector
        bit = (rank // d) % 2 == 1
        keep_sl, send_sl = ((slice(half, None), slice(None, half)) if bit
                            else (slice(None, half), slice(half, None)))
        keep, send = cur[keep_sl], cur[send_sl]
        y_keep, y_send = y_cur[keep_sl], y_cur[send_sl]
        u_keep, u_send = u_full[keep_sl], u_full[send_sl]
        s_keep = cfg.spec.side(y_keep)[:, None]
        s_send = cfg.spec.side(y_send)[:, None]
        if ab is not None:
            ab = ab[keep_sl]
        fails_b, dist_b = fails_b[keep_sl], dist_b[keep_sl]

        perm = [(i, i ^ d) for i in range(world)]
        if cfg.packed:
            sides_send = s_send[:, 0].contiguous()
            words = _encode_packed(send, sides_send, u_send, cfg)
            w_recv = _ppermute(words, perm, group)
            sides_recv = _ppermute(sides_send, perm, group)
            # the partner encoded *its* copy of the coordinates we keep
            k_recv = _decode_packed(w_recv, keep, sides_recv, u_keep, cfg,
                                    mode="coords")
        else:
            c_send = L.color_of(_encode(send, s_send, u_send), cfg.q)
            c_recv = _ppermute(c_send, perm, group)
            k_recv = L.decode_coords(c_recv, keep, s_keep, u_keep, q=cfg.q)
        # our own half on the same (u, s) lattice: the reference of the
        # telemetry and of the exact integer average below
        k_own = L.encode_coords(keep, s_keep, u_keep)
        f_b, d_b = _bucket_fails(k_recv, k_own, s_keep, y_keep[:, None])
        fails_b = fails_b + f_b
        dist_b = torch.maximum(dist_b, d_b)
        fails = fails + f_b.sum()
        max_dist = torch.maximum(max_dist, d_b.amax())
        t = 0.5 * (k_own + k_recv).to(torch.float32) + u_keep
        cur = t * s_keep
        y_cur = y_keep
        del u_full, u_keep, u_send, k_own, k_recv

    if ab is not None:
        cur = cur + ab if rounds == 0 else _add_anchor(t, s_keep, ab)
    if cfg.rotate:
        cur = R.unrotate(cur, _bucket_diag(cfg.bucket, dev), cfg.bucket,
                         use_kernel=cfg.packed)
    aux = QSyncAux(fails=fails, max_dist=max_dist, y_next=2.5 * max_dist,
                   fails_b=fails_b, dist_b=dist_b, y_seg=y_cur)
    return cur.reshape(-1), aux


# ---------------------------------------------------------------------------
# Wire accounting (ring model, bytes *sent per rank*)
# ---------------------------------------------------------------------------

def _payload_bytes(n: int, cfg: QSyncConfig) -> int:
    """Bytes of one full-vector message: packed words + 4 B per bucket of
    sides (packed), or one uint32 color per coordinate (unpacked)."""
    padded = flat_size_padded(n, cfg)
    return WA.collective_payload_bytes(padded, cfg.bits,
                                       padded // cfg.bucket, cfg.packed)


def wire_bytes_butterfly(n: int, world: int, cfg: QSyncConfig) -> int:
    """Recursive doubling: log2(world) rounds, one full payload each."""
    padded = flat_size_padded(n, cfg)
    return WA.butterfly_bytes(padded, cfg.bits, padded // cfg.bucket, world,
                              cfg.packed)


def wire_bytes_allgather(n: int, world: int, cfg: QSyncConfig) -> int:
    """Ring all-gather of every rank's payload: (world-1) forwarded chunks."""
    padded = flat_size_padded(n, cfg)
    return WA.allgather_bytes(padded, cfg.bits, padded // cfg.bucket, world,
                              cfg.packed)


def wire_bytes_rh(n: int, world: int, cfg: QSyncConfig) -> int:
    """Recursive halving: round r sends the (padded/2^{r+1})-coordinate
    half of the working segment, summing to about one full payload."""
    padded = flat_size_padded(n, cfg)
    return WA.rh_bytes(padded, cfg.bits, padded // cfg.bucket, world,
                       cfg.packed)


def wire_bytes_anchor_gather(n: int, world: int) -> int:
    """Forward f32 all-gather rebuilding a *sharded* anchor (FSDP's
    prefetch slot); the anchored backward sync itself moves no anchor
    bytes."""
    return WA.anchor_gather_bytes(n, world)
