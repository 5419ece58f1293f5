"""Cost accounting of a traced step; counterpart of
``repro.launch.hlo_analysis``.

The reference reads its costs from a lowered step's HLO text.  Torch has no
HLO: here :class:`Recorder`, a ``TorchDispatchMode``, records the *op log*
of one eager step run on ``meta`` tensors (``launch/dryrun.py``), one
entry per dispatched op, with

* the op's name, its inputs' and outputs' shapes and dtypes (as the HLO
  text writes them, ``bf16[16,4096]``) and their bytes;
* its class: a matmul-class op (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``convolution``, and ``matmul``, ``linear``, ``einsum`` where they reach
  the recorder whole, as they do under ``torch.inference_mode``) or one of
  the port's kernels (``compute``), a
  collective, a view, an allocation, a fill (a factory op), a layout or
  convert copy, a host read of device data (``sync``: ``.item()``, a copy
  to the host), a profiler span, or any other op;
* its dot FLOPs, its collective kind, group size and wire bytes, its
  kernel name;
* the tensor storages it reads and writes, so that data flow can be
  followed.

A kernel of the port answers a ``meta`` tensor from its shape-only
implementation (``kernels/ops.py``), which reports the call here as one
op with its inputs and outputs.  What needs data the recorder answers
itself: a collective runs through the (fake) group on empty host
stand-ins and returns its own ``meta`` outputs, a copy to the host gives
zeros, ``.item()`` gives 0.  The log is a list of plain dicts, so that
it can be saved and read back (``launch/reanalyze.py``).

:func:`analyze` gives the reference's :class:`Costs`:

* ``dot_flops``: ``2 * out * contracted`` of every matmul-class op (the
  attention kernel as its two products), every recomputed forward counted,
  as the reference's remat'd HLO counts it;
* ``traffic``: an HBM-traffic proxy, the inputs plus outputs of every op
  that moves data, as the reference counts the inputs and outputs of its
  fusions, dots and collectives.  Eager torch runs every elementwise op
  and reduction as a kernel of its own, so each is counted as a fusion of
  one op; a fill counts its output alone (the reference's ``broadcast`` /
  ``iota``); views, allocations, metadata queries and the layout and
  convert copies (``clone``, ``_to_copy``, ``copy_``) are left out, as the
  reference leaves out its standalone reshape / transpose / convert /
  copy;
* ``coll``: wire bytes per device by kind, under the reference's ring
  model (all-gather: output bytes; all-reduce: 2 x input; the rest:
  input), with a ``<kind>_count`` each.  The kinds are the collectives the
  port issues: ``all-gather`` (``all_gather_into_tensor``, which the
  port's TP psum is too: an all-gather, then a sum in rank order,
  ``models/sharding._psum``) and ``ppermute`` (one ``batch_isend_irecv``
  round: a send and its receive; the port's quantized reduce-scatter, its
  TP reduce-scatter and its all-to-all are rounds of them), and
  ``all-reduce``, ``reduce-scatter``, ``all-to-all`` and ``broadcast``
  where a program issues them.  They are not relabelled to the
  reference's kinds.

:func:`audit_overlap` carries the reference's overlap audit to eager code:
the *bodies* are the forward layer iterations, the spans
``models/transformer.LAYER_SPAN`` marks.  A collective issued in a body is
*exposed* when its result, or the tensor its wait yields, reaches a
matmul-class op or kernel and no matmul-class op or kernel was issued
between the collective and its wait; otherwise it is *overlapped*.  The
wait is the collective itself where the call blocks (``async_op=False``),
the ``wait_tensor`` of a functional collective, and else the first op that
touches the result, a view included (an async handle's ``wait()``
dispatches no op, and nothing touches a result before its wait).  An
async issue and its wait count once.
"""
from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
from typing import Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.kernels import _build
from repro_torch.models.transformer import LAYER_SPAN

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution",
           "matmul", "linear", "einsum", "mv", "dot", "vdot"}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "_empty_affine_quantized"}
_LAYOUT = {"clone", "_to_copy", "copy_", "_unsafe_view", "contiguous",
           "lift_fresh", "lift_fresh_copy", "detach", "alias"}

# c10d op -> (kind, output arg index or None, input arg index or None,
# process group arg index); an index names a tensor or a list of them
_C10D = {
    "_allgather_base_": ("all-gather", 0, 1, 2),
    "allgather_": ("all-gather", 0, 1, 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 1, 2),
    "allreduce_": ("all-reduce", 0, 0, 1),
    "broadcast_": ("broadcast", 0, 0, 1),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 1, 2),
    "reduce_scatter_": ("reduce-scatter", 0, 1, 2),
    "alltoall_base_": ("all-to-all", 0, 1, 2),
    "alltoall_": ("all-to-all", 0, 1, 2),
    "send": ("ppermute", None, 0, 1),
    "recv_": ("ppermute", 0, None, 1),
}
# functional collectives: the result is the op's return; (kind, group
# size arg index or None: resolve the group name, the last arg)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", 1),
    "all_reduce": ("all-reduce", None),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", None),
    "broadcast": ("broadcast", None),
}


def tensors(x, out=None) -> list:
    """The tensors in an op's (nested) arguments or results."""
    if out is None:
        out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            tensors(v, out)
    return out


_DT = {}


def _desc(t: torch.Tensor) -> str:
    """A tensor as the HLO text writes it: ``bf16[16,4096]``."""
    dt = _DT.get(t.dtype)
    if dt is None:
        dt = _DT[t.dtype] = str(t.dtype).replace("torch.", "")
    return f"{dt}[{','.join(map(str, t.shape))}]"


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _arg(func, args, kwargs, name: str, default):
    """The value an op call passed for its schema argument ``name``."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            if name in kwargs:
                return kwargs[name]
            return args[i] if i < len(args) else default
    return default


def _group_size(pg) -> int:
    from torch.distributed.distributed_c10d import (ProcessGroup,
                                                    _resolve_process_group)
    if isinstance(pg, str):
        return _resolve_process_group(pg).size()
    return ProcessGroup.unbox(pg).size()


def einsum_flops(eq: str, shapes) -> float:
    """Dot FLOPs of ``torch.einsum(eq, *operands)`` contracted left to
    right, pairwise: each pair costs 2 x the product of every index size
    the pair touches (out x contracted), and keeps the indices a later
    operand or the output needs."""
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    size = {}
    for term, shp in zip(terms, shapes):
        for ch, d in zip(term, shp):
            size[ch] = d
    flops, cur = 0.0, terms[0]
    for j, term in enumerate(terms[1:], 1):
        later = set(out).union(*terms[j + 1:])
        idx = set(cur) | set(term)
        n = 1
        for ch in idx:
            n *= size[ch]
        flops += 2.0 * n
        cur = "".join(ch for ch in sorted(idx) if ch in later)
    return flops


def dot_flops(name: str, args, outs) -> float:
    """``2 * out * contracted`` of a matmul-class op."""
    if name == "einsum":
        return einsum_flops(args[0], [t.shape for t in args[1]])
    if name == "convolution":
        w = args[1]
        return 2.0 * sum(t.numel() for t in outs) * (w.numel() // w.shape[0])
    a = args[1] if name in ("addmm", "baddbmm", "addbmm") else args[0]
    return 2.0 * sum(t.numel() for t in outs) * a.shape[-1]


def wire_bytes(kind: str, in_bytes: float, out_bytes: float) -> float:
    """The reference's ring model of a collective's wire bytes a device."""
    if kind == "all-gather":
        return out_bytes
    if kind == "all-reduce":
        return 2 * in_bytes
    return in_bytes


class Recorder(TorchDispatchMode):
    """Records the op log of the code run under it (see the module
    docstring); ``log`` is the list of entries.  ``real_bytes_max`` is the
    largest tensor an op was given or made that was not ``meta``: the host
    scalars a step makes (a learning rate, a clip factor) and nothing of a
    model's size."""

    def __init__(self):
        super().__init__()
        self.log: list = []
        self.real_bytes_max = 0
        self._sids: dict = {}
        self._next = 0

    def __enter__(self):
        _build.FAKE_OBSERVERS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.FAKE_OBSERVERS.remove(self._kernel)
        return super().__exit__(*exc)

    def _sid(self, t: torch.Tensor) -> Optional[int]:
        """A storage's id in this log: a new one once the storage it was
        given to has died (its address may be reused)."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None
        key = st._cdata
        ent = self._sids.get(key)
        if ent is None or ent[1].expired():
            ent = self._sids[key] = (self._next, StorageWeakRef(st))
            self._next += 1
        return ent[0]

    def _ids(self, ts) -> list:
        out = []
        for t in ts:
            if not t.is_meta:
                self.real_bytes_max = max(self.real_bytes_max,
                                          t.numel() * t.element_size())
            s = self._sid(t)
            if s is not None and s not in out:
                out.append(s)
        return out

    def _add(self, op: str, cls: str, ins, outs, **extra) -> dict:
        e = {"op": op, "cls": cls, "in": [_desc(t) for t in ins],
             "out": [_desc(t) for t in outs], "inb": nbytes(ins),
             "outb": nbytes(outs), "reads": self._ids(ins),
             "writes": self._ids(outs)}
        e.update(extra)
        self.log.append(e)
        if len(self.log) % 100_000 == 0:
            self._sids = {k: v for k, v in self._sids.items()
                          if not v[1].expired()}
        return e

    def _kernel(self, name: str, ins, outs) -> None:
        flops = 0.0
        if name == "flash_attention":
            bh, sq, d = ins[0].shape
            flops = 4.0 * bh * sq * ins[1].shape[1] * d
        self._add(f"kernel.{name}", "compute", ins, outs, kernel=name,
                  flops=flops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns, name = func.namespace, func.overloadpacket.__name__
        op = str(func)
        targs = tensors(args)
        on_meta = any(t.is_meta for t in targs)
        if ns == "c10d" and on_meta:
            # the group's bookkeeping on empty host stand-ins; the meta
            # outputs are the result
            sub = tree_map(lambda t: torch.empty(0, dtype=t.dtype)
                           if isinstance(t, torch.Tensor) else t, args)
            out = func(*sub, **kwargs)
            if isinstance(out, tuple):
                out = (args[0],) + tuple(out[1:])
        elif on_meta and name == "_local_scalar_dense":
            out = False if args[0].dtype == torch.bool else 0
            self._add(op, "sync", targs, [])
            return out
        elif on_meta and name == "_to_copy" and \
                torch.device(kwargs.get("device") or "meta").type != "meta":
            out = torch.zeros(args[0].shape,
                              dtype=kwargs.get("dtype") or args[0].dtype,
                              device=kwargs["device"])
            self._add(op, "sync", targs, [out])
            return out
        else:
            out = func(*args, **kwargs)
        if ns == "profiler":
            if name.startswith("_record_function_enter"):
                self.log.append({"op": op, "cls": "span", "at": "enter",
                                 "name": args[0]})
            elif name == "_record_function_exit":
                self.log.append({"op": op, "cls": "span", "at": "exit"})
        elif ns == "c10d" and name in _C10D:
            self._c10d(op, func, name, args, kwargs)
        elif ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, gi = _FUNCTIONAL[name]
            ins, outs = tensors(args[0]), tensors(out)
            size = args[gi] if gi is not None else _group_size(args[-1])
            self._collective(op, kind, size, ins, outs, functional=True)
        elif ns == "_c10d_functional" and name == "wait_tensor":
            self._add(op, "wait", targs, tensors(out))
        elif ns == "_c10d_functional" and name == "_wrap_tensor_autograd":
            self._add(op, "view", targs, tensors(out))
        elif ns == "prim" or not targs and not tensors(out):
            pass                                  # metadata queries
        else:
            ins, outs = tensors(kwargs, list(targs)), tensors(out)
            if name in _MATMUL:
                self._add(op, "compute", ins, outs,
                          flops=dot_flops(name, args, outs))
            elif func.is_view:
                self._add(op, "view", ins, outs)
            elif name in _ALLOC:
                self._add(op, "alloc", ins, outs)
            elif name in _LAYOUT:
                self._add(op, "layout", ins, outs)
            elif not ins:
                self._add(op, "fill", ins, outs)
            else:
                self._add(op, "op", ins, outs)
        return out

    def _c10d(self, op: str, func, name: str, args, kwargs) -> None:
        kind, oi, ii, gi = _C10D[name]
        outs = tensors(args[oi]) if oi is not None else []
        ins = tensors(args[ii]) if ii is not None else []
        size = _group_size(args[gi])
        prev = self.log[-1] if self.log else None
        if name == "recv_" and prev is not None and \
                prev.get("coll") == "ppermute" and not prev["writes"]:
            # the receive of the send just issued: one ppermute round
            prev["out"] = [_desc(t) for t in outs]
            prev["outb"] = nbytes(outs)
            prev["writes"] = self._ids(outs)
            return
        # a blocking call waits before it returns: its wait is its issue
        sync = not _arg(func, args, kwargs, "async_op", True)
        self._collective(op, kind, size, ins, outs, sync=sync)

    def _collective(self, op, kind, size, ins, outs, **how) -> None:
        """One collective entry; ``how``: ``sync`` (the call blocks) or
        ``functional`` (waited by ``wait_tensor``)."""
        self._add(op, "coll", ins, outs, coll=kind, group=int(size),
                  wire=float(wire_bytes(kind, nbytes(ins), nbytes(outs))),
                  **how)


# ---------------------------------------------------------------------------
# the log on disk
# ---------------------------------------------------------------------------

def save_log(log: list, path: str) -> None:
    """Write an op log, gzip-compressed JSON (the standard library's)."""
    with gzip.open(path, "wt") as f:
        json.dump(log, f, separators=(",", ":"))


def load_log(path: str) -> list:
    with gzip.open(path, "rt") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Costs:
    dot_flops: float = 0.0
    traffic: float = 0.0
    coll: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "Costs", mult: float = 1.0):
        self.dot_flops += other.dot_flops * mult
        self.traffic += other.traffic * mult
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * mult


_NO_TRAFFIC = ("span", "view", "alloc", "layout", "wait", "sync")


def analyze(log: list) -> Costs:
    """FLOPs, traffic and collective bytes of an op log (module
    docstring)."""
    c = Costs()
    for e in log:
        cls = e["cls"]
        if cls in _NO_TRAFFIC:
            continue
        if cls == "fill":
            c.traffic += e["outb"]
            continue
        c.traffic += e["inb"] + e["outb"]
        if cls == "compute":
            c.dot_flops += e["flops"]
        elif cls == "coll":
            k = e["coll"]
            c.coll[k] = c.coll.get(k, 0.0) + e["wire"]
            c.coll[k + "_count"] = c.coll.get(k + "_count", 0) + 1
    return c


def kernel_calls(log: list) -> dict:
    """Calls of each of the port's kernels in an op log."""
    out: dict = {}
    for e in log:
        if e.get("kernel"):
            out[e["kernel"]] = out.get(e["kernel"], 0) + 1
    return out


# ---------------------------------------------------------------------------
# the overlap audit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OverlapAudit:
    """Per-body report of whether a body's collectives are *exposed*
    (their result feeds compute with no compute issued while they were in
    flight: latency on the critical path) or *overlapped*.

    ``bodies``: one dict per forward layer iteration — {"body",
    "trip_weight" (1: each iteration is its own body), "total_bytes",
    "exposed_bytes", "collectives": [{"op", "kind", "bytes", "exposed"}]}.
    Bytes use the wire model of :func:`analyze`."""
    bodies: list = dataclasses.field(default_factory=list)
    total_bytes: float = 0.0
    exposed_bytes: float = 0.0

    @property
    def exposed_fraction(self) -> float:
        """Fraction of the bodies' collective wire bytes on the critical
        path (1.0 = fully serialized, as the serial layer loop; the
        prefetching loop must come out strictly lower).  0.0 when no body
        holds a collective."""
        return (self.exposed_bytes / self.total_bytes
                if self.total_bytes else 0.0)


def _layer_spans(log: list) -> list:
    """(enter, exit) indices of the LAYER_SPAN spans, in order."""
    stack, out = [], []
    for i, e in enumerate(log):
        if e["cls"] != "span":
            continue
        if e["at"] == "enter":
            stack.append((i, e["name"]))
        elif stack:
            j, name = stack.pop()
            if name == LAYER_SPAN:
                out.append((j, i))
    return sorted(out)


def audit_overlap(log: list) -> OverlapAudit:
    """Classify every collective issued in a body as exposed or
    overlapped (see the module docstring and :class:`OverlapAudit`)."""
    readers: dict = {}
    for j, e in enumerate(log):
        for s in e.get("reads", ()):
            readers.setdefault(s, []).append(j)
    computes = [0]
    for e in log:
        computes.append(computes[-1] + (e["cls"] == "compute"))

    def wait_of(i: int) -> Optional[int]:
        """Where collective ``i`` is waited for: at its issue when it
        blocks; at the ``wait_tensor`` its result reaches through views
        when it is a functional collective; else at the first op that
        touches its result (a view too: nothing touches a result before
        its handle's wait)."""
        e = log[i]
        if e.get("sync"):
            return i
        best = None
        todo = [(s, i) for s in e["writes"]]
        seen = set()
        while todo:
            s, after = todo.pop()
            rs = readers.get(s, ())
            for j in rs[bisect.bisect_right(rs, after):]:
                if j in seen:
                    continue
                seen.add(j)
                cls = log[j]["cls"]
                if not e.get("functional") or cls == "wait":
                    best = j if best is None else min(best, j)
                    break                  # later readers come after it
                if cls == "view":
                    todo += [(w, j) for w in log[j]["writes"] if w != s]
        return best

    def reaches_compute(i: int) -> bool:
        """Whether the result of op ``i`` flows into a compute op."""
        todo = [(s, i) for s in log[i]["writes"]]
        seen = set()
        while todo:
            s, after = todo.pop()
            rs = readers.get(s, ())
            for j in rs[bisect.bisect_right(rs, after):]:
                if j in seen:
                    continue
                seen.add(j)
                if log[j]["cls"] == "compute":
                    return True
                todo += [(w, j) for w in log[j]["writes"]]
        return False

    audit = OverlapAudit()
    for n, (a, b) in enumerate(_layer_spans(log)):
        rec = {"body": f"layer {n}", "trip_weight": 1, "total_bytes": 0.0,
               "exposed_bytes": 0.0, "collectives": []}
        for i in range(a + 1, b):
            e = log[i]
            if e["cls"] != "coll":
                continue
            wait = wait_of(i)
            exposed = (wait is not None and computes[wait] == computes[i + 1]
                       and reaches_compute(i))
            rec["collectives"].append({"op": e["op"], "kind": e["coll"],
                                       "bytes": e["wire"],
                                       "exposed": exposed})
            rec["total_bytes"] += e["wire"]
            if exposed:
                rec["exposed_bytes"] += e["wire"]
        audit.bodies.append(rec)
        audit.total_bytes += rec["total_bytes"]
        audit.exposed_bytes += rec["exposed_bytes"]
    return audit
