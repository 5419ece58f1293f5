"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

The registry is the single accounting store of the aggregation stack:
the per-round ``RoundStats`` / ``TierStats`` surfaces and the
kernel ``DISPATCH_COUNTS`` dict are all thin views over instruments that
live here, instead of parallel hand-rolled increments.  Zero dependencies
beyond the stdlib (numpy never enters this module), so the hot-path cost
of an increment is one dict hit plus an integer add.

Three instrument kinds, all label-keyed — ``registry.counter(
"chunk_retransmits", round=7, tier=3)`` names one time series per distinct
label set:

* :class:`Counter` — monotonically increasing integer (``inc``).
* :class:`Gauge` — last-written value (``set``) with a max-tracking mode
  (``set_max``) for high-water marks like ``peak_staging_bytes``.
* :class:`Histogram` — fixed-bucket counts (mergeable across registries,
  Prometheus-exportable) plus an exact sample reservoir (up to
  :data:`SAMPLE_CAP` observations) so ``quantile`` reproduces
  ``np.percentile`` bit-for-bit on CI-sized traces and only falls back to
  bucket interpolation beyond the cap.

When observability is globally disabled, the convenience constructors in
:mod:`repro_torch.obs` hand out :data:`NOOP` — a do-nothing singleton with the
full instrument surface — so instrumented call sites pay one truthiness
check and nothing else.

:class:`Scope` bundles the instruments of one server/tier instance under a
shared label set; ``Scope.fill`` materializes them back onto a stats
dataclass (the registry-read path the per-round telemetry now takes).
"""
from __future__ import annotations

import math
from typing import Optional

# exact-quantile reservoir size; past this the histogram stops retaining
# raw samples and quantile() interpolates within buckets instead
SAMPLE_CAP = 4096

# generic log-spaced ladder covering seconds-scale latencies through
# byte/count-scale magnitudes (1-2.5-5 per decade)
DEFAULT_BOUNDS = tuple(m * 10.0 ** e for e in range(-6, 7)
                       for m in (1.0, 2.5, 5.0))


def quantile(values, p: float) -> float:
    """The p-th percentile (0..100) with ``np.percentile``'s default
    linear interpolation, including its two-sided lerp form — the ONE
    quantile implementation the sim and the benchmarks share.
    """
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("quantile of an empty sequence")
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile {p} outside [0, 100]")
    pos = (p / 100.0) * (len(vals) - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    a, b = vals[lo], vals[hi]
    t = pos - lo
    # numpy's _lerp switches forms at t=0.5 for monotonicity; mirror it so
    # the old-vs-new p50/p99 agreement is exact, not approximate
    if t >= 0.5:
        return b - (b - a) * (1.0 - t)
    return a + (b - a) * t


class Counter:
    """A monotonically increasing scalar."""
    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """A last-written (or max-tracked) scalar."""
    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        if v > self.value:
            self.value = v

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Fixed-bucket histogram + exact reservoir for small-N quantiles.

    ``bounds`` are upper bucket edges (ascending); observations above the
    last edge land in the implicit +Inf bucket.  ``merge`` adds another
    histogram's buckets (and reservoir, while both fit under the cap) —
    the mergeable/fleet-reducible shape Prometheus-style histograms have.
    """
    __slots__ = ("name", "labels", "bounds", "counts", "count", "total",
                 "vmin", "vmax", "samples", "exact")
    kind = "histogram"

    def __init__(self, name: str = "", labels: Optional[dict] = None,
                 bounds: "tuple[float, ...]" = DEFAULT_BOUNDS):
        self.name = name
        self.labels = {} if labels is None else labels
        self.bounds = tuple(bounds)
        if any(nxt <= prev for nxt, prev in zip(self.bounds[1:], self.bounds)):
            raise ValueError("histogram bounds must be strictly ascending")
        self.counts = [0] * (len(self.bounds) + 1)   # [..., +Inf]
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.samples: "list[float]" = []
        self.exact = True

    @classmethod
    def from_values(cls, values, bounds: "tuple[float, ...]" = DEFAULT_BOUNDS
                    ) -> "Histogram":
        """An unregistered histogram over a finished sample set."""
        h = cls(bounds=bounds)
        for v in values:
            h.observe(v)
        return h

    def _bucket(self, v: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:                       # first edge >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v) -> None:
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if self.exact:
            if len(self.samples) < SAMPLE_CAP:
                self.samples.append(v)
            else:
                self.samples.clear()         # reservoir overflowed: buckets
                self.exact = False           # are the record from here on

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, p: float) -> float:
        """Exact (np.percentile-identical) while the reservoir holds every
        observation; bucket-interpolated beyond :data:`SAMPLE_CAP`."""
        if self.count == 0:
            raise ValueError("quantile of an empty histogram")
        if self.exact:
            return quantile(self.samples, p)
        # cumulative-bucket interpolation, clamped to the observed range
        target = (p / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.vmin if i == 0 else max(self.vmin, self.bounds[i - 1])
            hi = self.vmax if i >= len(self.bounds) \
                else min(self.vmax, self.bounds[i])
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return self.vmax

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        if (self.exact and other.exact
                and len(self.samples) + len(other.samples) <= SAMPLE_CAP):
            self.samples.extend(other.samples)
        else:
            self.samples.clear()
            self.exact = False

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.samples = []
        self.exact = True


class _Noop:
    """The disabled-path instrument: full surface, no state, no cost
    beyond the call."""
    __slots__ = ()
    kind = "noop"
    name = ""
    labels: dict = {}
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def set_max(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def reset(self) -> None:
        pass


NOOP = _Noop()


class Registry:
    """Label-keyed instrument store; one per process by default
    (:func:`repro_torch.obs.registry`), standalone instances for tests."""

    def __init__(self):
        self._instruments: dict = {}     # (name, sorted labelitems) -> inst

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def _get(self, cls, name: str, labels: dict, **kw):
        key = self._key(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls(name, labels, **kw)
            self._instruments[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"{name}{labels} already registered as {inst.kind}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: "tuple[float, ...]" =
                  DEFAULT_BOUNDS, **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def instruments(self) -> list:
        """Every registered instrument, sorted by (name, labels) — the
        exporters' stable iteration order."""
        return [self._instruments[k] for k in sorted(self._instruments)]

    def value(self, name: str, **labels):
        inst = self._instruments.get(self._key(name, labels))
        return None if inst is None else inst.value

    def reset(self) -> None:
        """Zero every instrument's state, keeping instrument identity (so
        cached references — e.g. the kernel dispatch counters — survive)."""
        for inst in self._instruments.values():
            inst.reset()

    def clear(self) -> None:
        self._instruments.clear()

    def scope(self, prefix: str, **labels) -> "Scope":
        return Scope(self, prefix, labels)

    def __len__(self) -> int:
        return len(self._instruments)


class Scope:
    """One instance's instrument bundle under a shared label set.

    The per-round stats dedupe: an
    :class:`~repro_torch.agg.server.AggServer` or tree tier increments ONLY its
    scope — ``scope.inc("accepted")`` is the registry counter
    ``{prefix}_accepted{labels}`` — and ``fill`` materializes the counters
    back onto the legacy ``RoundStats``/``TierStats`` dataclass, so the
    dataclass surface every test and caller reads is a registry read, not
    a parallel account.
    """
    __slots__ = ("_reg", "_prefix", "_labels", "_insts")

    def __init__(self, reg: Registry, prefix: str, labels: dict):
        self._reg = reg
        self._prefix = prefix
        self._labels = labels
        self._insts: dict = {}           # field -> instrument

    def inc(self, field: str, n: int = 1) -> None:
        inst = self._insts.get(field)
        if inst is None:
            inst = self._reg.counter(f"{self._prefix}_{field}",
                                     **self._labels)
            self._insts[field] = inst
        inst.value += n

    def set_max(self, field: str, v) -> None:
        inst = self._insts.get(field)
        if inst is None:
            inst = self._reg.gauge(f"{self._prefix}_{field}", **self._labels)
            self._insts[field] = inst
        inst.set_max(v)

    def value(self, field: str):
        inst = self._insts.get(field)
        return 0 if inst is None else inst.value

    def fill(self, obj) -> None:
        """Write every touched instrument's value onto ``obj``'s field of
        the same name (untouched fields keep the dataclass defaults)."""
        for field, inst in self._insts.items():
            setattr(obj, field, inst.value)
