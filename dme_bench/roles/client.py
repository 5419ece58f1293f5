"""The client role: clients of a round encode their vectors, back to back.

Each round has a new round id, so its dither and checksum weights are new
draws, and each client a new vector made on the run's device.  A client
is the program's ``AggClient(spec, client_id, x)``, driven as a client
process drives it: ``encode()`` (bucketize, rotation, dither and weights
draws, the encode kernel, the checksum, the copy to the host), then
``frames()`` (the wire bytes).  A round's answer is each client's frames;
the reference makes them again from the same vector and contract.
"""
from __future__ import annotations

import torch

from dme_bench import inputs
from dme_bench.reference import client as RC


def contract_of(config: dict, mix: dict) -> RC.Contract:
    """The round contract of a configuration, which the mix must fit."""
    c = config["contract"]
    if c["anchored"] or c["mtu"]:
        raise ValueError("the client role runs unanchored, unchunked rounds")
    if mix.get("rotate", c["rotate"]) != c["rotate"]:
        raise ValueError(f"the mix wants rotate={mix['rotate']}, the "
                         f"configuration's contract says {c['rotate']}")
    return RC.Contract(d=config["d"], q=c["q"], bucket=c["bucket"],
                       y0=c["y0"], rotate=c["rotate"], rot_seed=c["rot_seed"])


def kernel_sources(c: RC.Contract) -> "tuple[str, ...]":
    """The port's CUDA sources that a client round launches."""
    from repro_torch.kernels import _build
    enc = _build.lattice_library("lattice_encode", _build.pow2(c.q))
    return (enc, "fwht") if c.rotate else (enc,)


class Role:
    def __init__(self, config: dict, mix: dict, seed: int, device, spans):
        self.c = contract_of(config, mix)
        self.clients = int(mix["clients"])
        self.noise = float(mix["noise"])
        self.seed, self.device, self.spans = seed, device, spans
        self.spec_seed = inputs.spec_seed(seed)
        self.make_client = self.program_client
        self.base = None

    def prepare(self) -> None:
        """Build the round's kernels (in the checkout's ``build/kernels``,
        once) and make the mean vector."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build(kernel_sources(self.c))
        self.base = inputs.base_vector(self.c.d, self.seed, self.device)

    def spec(self, round_id: int):
        """The program's ``RoundSpec`` of round ``round_id``."""
        from repro_torch.agg.transport.frame import RoundSpec
        from repro_torch.dist.collectives import QSyncConfig
        c = self.c
        return RoundSpec(round_id=round_id, d=c.d,
                         cfg=QSyncConfig(q=c.q, bucket=c.bucket,
                                         rotate=c.rotate),
                         y0=c.y0, seed=self.spec_seed, rot_seed=c.rot_seed)

    def program_client(self, round_id: int, client_id: int, x):
        from repro_torch.agg.client import AggClient
        return AggClient(self.spec(round_id), client_id, x,
                         device=self.device)

    def control(self) -> None:
        """Put the reference, in bfloat16, in the program's place."""
        def make(round_id, client_id, x):
            return RC.ReferenceClient(self.c, self.spec_seed, round_id,
                                      client_id, x, dtype=torch.bfloat16)
        self.make_client = make

    def round(self, r: int) -> "list[list[bytes]]":
        """Round ``r`` (the warm-up is -1; its round id is r + 1)."""
        out = []
        for i in range(self.clients):
            span = self.spans.span
            with span("client.vector", r):
                x = inputs.client_vector(self.base, self.seed, r, i,
                                         self.noise)
            with span("client.setup", r):
                client = self.make_client(r + 1, i, x)
            with span("client.encode", r):
                client.encode()
            with span("client.frame", r):
                out.append(client.frames())
            del client, x
        return out

    def check(self, r: int, answer) -> "dict[str, tuple[float, float]]":
        """Bytes of the round's frames that differ from the reference's."""
        bad = 0
        for i, frames in enumerate(answer):
            x = inputs.client_vector(self.base, self.seed, r, i, self.noise)
            bad += RC.bad_bytes(frames, RC.frame(x, self.c, self.spec_seed,
                                                 r + 1, i))
        return {"bad_bytes": (bad, 0)}
