"""Exporters: Chrome trace-event JSON (Perfetto-viewable) and Prometheus
text exposition.

``chrome_trace`` turns a :class:`~repro_torch.obs.trace.Tracer`'s spans into the
Chrome trace-event format (the JSON array flavour) that
https://ui.perfetto.dev opens directly: complete ("X") events for timed
spans, instant ("i") events for point events, one pid lane per round and
one tid lane per client/stage so a round's pipeline reads left-to-right.

``prometheus_text`` renders a :class:`~repro_torch.obs.registry.Registry` in the
text exposition format (# HELP/# TYPE + samples; histograms as cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count``).
``parse_prometheus_text`` is the minimal inverse used by the round-trip
test — samples back to ``{(name, labels): value}``.
"""
from __future__ import annotations

import json

from .registry import Registry
from .trace import Span, Tracer


def _lane(span: Span) -> "tuple[int, str]":
    """(pid, tid name) for one span: pid = round id (0 when unknown), tid
    groups the per-client subtrees apart from the round-level stages."""
    rid = span.attrs.get("round", 0)
    cid = span.attrs.get("client")
    tid = f"client {cid}" if cid is not None else span.name \
        if span.name in ("round", "encode") else "stages"
    return int(rid), tid


def chrome_trace(tracer: Tracer) -> str:
    """The tracer's spans as a Chrome trace-event JSON string (µs
    timestamps, as the format requires)."""
    tids: dict = {}

    def tid_of(pid: int, name: str) -> int:
        return tids.setdefault((pid, name), len(tids) + 1)

    events = []
    for sp in tracer.spans:
        pid, lane = _lane(sp)
        tid = tid_of(pid, lane)
        args = {k: v for k, v in sp.attrs.items()}
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        if sp.instant:
            events.append({"name": sp.name, "ph": "i", "s": "t",
                           "ts": sp.start * 1e6, "pid": pid, "tid": tid,
                           "args": args})
        else:
            end = sp.end if sp.end is not None else sp.start
            events.append({"name": sp.name, "ph": "X",
                           "ts": sp.start * 1e6,
                           "dur": max(0.0, (end - sp.start) * 1e6),
                           "pid": pid, "tid": tid, "args": args})
    # name the lanes so Perfetto shows "round 7 / client 3" not bare ints
    for (pid, name), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    return json.dumps(events)


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(reg: Registry) -> str:
    """The registry in Prometheus text exposition format."""
    lines: "list[str]" = []
    typed: set = set()
    for inst in reg.instruments():
        if inst.name not in typed:
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            typed.add(inst.name)
        if inst.kind == "histogram":
            cum = 0
            for edge, c in zip(inst.bounds, inst.counts):
                cum += c
                lab = dict(inst.labels, le=repr(float(edge)))
                lines.append(f"{inst.name}_bucket{_label_str(lab)} {cum}")
            lab = dict(inst.labels, le="+Inf")
            lines.append(f"{inst.name}_bucket{_label_str(lab)} {inst.count}")
            lines.append(f"{inst.name}_sum{_label_str(inst.labels)} "
                         f"{_fmt(inst.total)}")
            lines.append(f"{inst.name}_count{_label_str(inst.labels)} "
                         f"{inst.count}")
        else:
            lines.append(f"{inst.name}{_label_str(inst.labels)} "
                         f"{_fmt(inst.value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition-format parser: ``{(name, ((k, v), ...)): float}``
    for every sample line.  Enough to verify the exporter round-trips; not
    a general Prometheus client."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        metric, val = line.rsplit(" ", 1)
        if "{" in metric:
            name, rest = metric.split("{", 1)
            body = rest.rsplit("}", 1)[0]
            labels = []
            for part in _split_labels(body):
                k, v = part.split("=", 1)
                labels.append((k, json.loads(v)))   # v is a quoted string
            key = (name, tuple(sorted(labels)))
        else:
            key = (metric, ())
        out[key] = float(val)
    return out


def _split_labels(body: str) -> "list[str]":
    """Split `k1="v1",k2="v2"` on commas outside quotes."""
    parts, cur, inq = [], [], False
    for ch in body:
        if ch == '"':
            inq = not inq
            cur.append(ch)
        elif ch == "," and not inq:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts
