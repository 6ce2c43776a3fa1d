"""Process groups of a pp x sp x tp x ep grid: the port's counterpart of
the mesh.

The JAX package (its ``parallel/mesh.py``) runs one program over a
``jax.sharding.Mesh`` of five named axes (dp, pp, sp, tp, ep) from one
process, and GSPMD inserts the collectives. PyTorch's idiom is one
process per rank, so here the mesh is a group of processes, each holding
its share of the weights on its own device (utils/device.py
``rank_device``), and the model calls the collectives itself
(models/transformer.py, parallel/pipeline.py, parallel/paged_pipeline.py,
parallel/ring.py).

- ``MeshSpec`` / ``validate_spec``: the JAX package's spec and its shape
  checks. The port serves pp, sp, tp and ep and their compositions; dp
  above 1 raises ``NotImplementedError`` (ROADMAP Queue A item 9.16). tp
  above the kv head count replicates the kv heads, as the JAX package
  does; ep cuts the experts of an MoE model.
- ``TPGroup``: one rank's view of a group of ``world`` processes on one
  host, created or joined through a file store at ``store_path``. Two
  process groups over every rank: ``control`` (gloo, on the CPU) carries
  the lockstep executor's ops (runtime/lockstep.py); ``data`` carries the
  leader's broadcasts (sampled tokens, a pipeline's outputs), over the
  backend ``data_backend`` picks from the layout. ``configure(spec)``
  lays the ranks out on the grid, rank = ((p·sp + s)·tp + t)·ep + e, ep
  innermost as in the JAX ``create_mesh`` (the leader, rank 0, is (0, 0,
  0, 0)), and builds the subgroups this rank belongs to
  (``grid_coords``): the tp group of its (p, s, e) cell (``tp``: the
  attention's and the dense MLP's all-reduces, the embedding, the head's
  gather; the whole group itself when tp is the only axis), the expert
  group over the tp × ep ranks of its (p, s) cell (``experts``: one sum
  of the routed experts' partial outputs per MoE layer), the sp ring of
  its (p, t, e) (``sp``: ring hops and combines) and the pp ring of its
  (s, t, e) (``pp``: stage hops). A kept group (runtime/lockstep.py
  ``DLI_TP_KEEP_GROUPS``) is configured anew at each load.
- A hop is a broadcast from the sender over the two-rank group of a ring
  edge (``Ring``): gloo takes only broadcast and all_reduce on CUDA
  tensors, so ranks that share a card cannot ``send``/``recv``, and a
  broadcast needs no host copy of the payload on either backend. Each
  hop packs its tensors into one byte buffer (``pack``). A ring posts its
  edges in one order on every rank (edge 0 -> 1 first, the wrap edge
  last), so blocking hops never wait on each other in a cycle.

Every data collective is counted in ``counts``: ``all_reduce`` (the
embedding's, o's, down's and the shared experts' sums, and "rms_full"
q/k norms' mean squares), ``expert_all_reduce`` (the routed experts'
sums over the expert group), ``gather`` (the head's logits over the tp
group) and
``broadcast`` (the leader's sampled tokens, a pipeline's outputs); under
pp ``send`` and ``recv`` (stage hops, per rank and direction); under sp
``ring`` (one per rotation of a ring's K/V chunks), ``combine`` (one per
sp all-reduce: a decode step's attention partials per layer, a
prefill's logits) and ``expert_gather`` (a prefill chunk's rows
assembled over the sp group before each MoE layer, models/
transformer.py). A key appears at its first count.

A collective that fails raises; nothing retries or falls back to one
rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import pickle
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from distributed_llm_inferencing_tpu_torch.utils.device import (
    data_backend, rank_device)

AXES = ("dp", "pp", "sp", "tp", "ep")
# a follower waits on the control group for its next op as long as the
# leader is idle; a data collective waits only for its peers' compute
CONTROL_TIMEOUT = datetime.timedelta(days=7)
DATA_TIMEOUT = datetime.timedelta(seconds=600)
JOIN_TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    def axis_sizes(self):
        return {a: getattr(self, a) for a in AXES}

    @property
    def world(self) -> int:
        """The ranks of the grid: pp · sp · tp · ep (dp is refused)."""
        return self.pp * self.sp * self.tp * self.ep

    @staticmethod
    def from_dict(d) -> "MeshSpec":
        unknown = sorted(set(d) - set(AXES))
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; known: {AXES}")
        spec = MeshSpec(**{k: int(v) for k, v in d.items()})
        if min(spec.axis_sizes().values()) < 1:
            raise ValueError(f"mesh axes must be >= 1: {spec}")
        return spec


def validate_spec(spec: MeshSpec, cfg) -> None:
    """The JAX package's shape checks, plus what the port does not serve
    yet; raises before any weight is drawn.

    As the JAX package: pp divides the layers; sp with sinks and pp over
    a mixed dense/MoE stack are ``NotImplementedError``; sp with tp above
    the kv heads is a ``ValueError`` (the ring shards the kv heads over
    tp); tp divides the heads and the intermediate widths (a mixed
    stack's dense prefix's too), and divides the kv heads or exceeds
    them (the kv heads then replicate, parallel/sharding.py ``kv_map``);
    ep needs an MoE model whose experts it divides. The port's own: tp
    divides the vocabulary (the embedding and the head split it; ROADMAP
    Queue A item 9.17 pads an odd one), and an int4 row-parallel leaf's
    din splits into tp split-half chunks. Refused by name: dp above 1
    (ROADMAP Queue A item 9.16)."""
    if spec.dp > 1:
        raise NotImplementedError(
            f"mesh dp={spec.dp}: data parallelism is a later slice of the "
            "port (ROADMAP Queue A item 9.16); serve replicas as separate "
            "workers")
    if spec.ep > 1:
        if not cfg.is_moe:
            raise ValueError(f"ep={spec.ep} on a dense model")
        if cfg.num_experts % spec.ep:
            raise ValueError(f"ep={spec.ep} must divide num_experts="
                             f"{cfg.num_experts}")
    if spec.pp > 1 and cfg.dense_prefix_layers:
        raise NotImplementedError(
            f"pp={spec.pp} over a mixed dense/MoE stack "
            f"(dense_prefix_layers={cfg.dense_prefix_layers}) is not "
            "supported, as in the JAX package: its stage split assumes one "
            "uniform stack")
    if cfg.num_layers % spec.pp:
        raise ValueError(f"pp={spec.pp} must divide num_layers="
                         f"{cfg.num_layers}")
    if spec.sp > 1 and cfg.attn_sinks:
        raise NotImplementedError(
            f"sp={spec.sp} with attention sinks: the ring's chunked online "
            "softmax has no sink column (as the JAX package); serve this "
            "model under tp or pp")
    if spec.sp > 1 and spec.tp > cfg.num_kv_heads:
        raise ValueError(
            f"sp={spec.sp} with tp={spec.tp} needs tp <= num_kv_heads="
            f"{cfg.num_kv_heads}: the ring shards the kv heads over tp")
    tp = spec.tp
    if tp == 1:
        return
    if cfg.num_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads}")
    if tp <= cfg.num_kv_heads and cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads} (or "
            "exceed it, which replicates the kv heads)")
    if cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide intermediate_size="
                         f"{cfg.intermediate_size}")
    if cfg.dense_intermediate_size and cfg.dense_intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide dense_intermediate_size="
                         f"{cfg.dense_intermediate_size} (the mixed stack's "
                         "dense-prefix MLP width)")
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size} "
                         "(the embedding and the head split the vocabulary; "
                         "ROADMAP Queue A item 9.17)")
    if cfg.quant == "int4":
        # the row-parallel leaves (parallel/sharding.py ``row_leaves``)
        # are repacked into tp chunk-local split-half packs
        from distributed_llm_inferencing_tpu_torch.models.params import (
            param_shapes)
        from distributed_llm_inferencing_tpu_torch.parallel.sharding import (
            row_leaves)
        shapes = param_shapes(cfg.replace(quant=None))
        for i in range(cfg.num_layers):
            for name in row_leaves(cfg, i):
                din = shapes[f"layers.{i}.{name}.w"][-2]
                if din % (2 * tp):
                    raise ValueError(
                        f"int4 layers.{i}.{name}: din={din} does not split "
                        f"into {tp} split-half chunks")


def grid_coords(spec: MeshSpec, rank: int):
    """(p, s, t, e) of ``rank`` on the grid: rank = ((p·sp + s)·tp + t)·ep
    + e."""
    e = rank % spec.ep
    r = rank // spec.ep
    t = r % spec.tp
    s = (r // spec.tp) % spec.sp
    return r // (spec.tp * spec.sp), s, t, e


def grid_rank(spec: MeshSpec, p: int, s: int, t: int, e: int = 0) -> int:
    return ((p * spec.sp + s) * spec.tp + t) * spec.ep + e


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def pack(tensors) -> torch.Tensor:
    """One uint8 buffer of ``tensors``' bytes, each segment padded to 8
    bytes (``unpack`` views them back without a copy)."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        parts += [b, b.new_zeros(-b.numel() % 8)]
    return torch.cat(parts)


def packed_size(likes) -> int:
    """The bytes ``pack`` makes of tensors of ``likes`` ((shape, dtype)
    pairs)."""
    return sum(k + (-k % 8) for k in (_nbytes(*like) for like in likes))


def unpack(buf: torch.Tensor, likes) -> List[torch.Tensor]:
    """The tensors of ``likes`` ((shape, dtype) pairs) viewed out of a
    ``pack`` buffer."""
    out, o = [], 0
    for shape, dtype in likes:
        k = _nbytes(shape, dtype)
        out.append(buf[o:o + k].view(dtype).reshape(shape))
        o += k + (-k % 8)
    return out


class Ring:
    """This rank's side of a ring of ``n`` ranks (one axis of the grid):
    a two-rank group per edge e -> e+1 (mod n) it lies on, whose
    broadcast from the sender is the hop. ``exchange`` posts this rank's
    receive from its predecessor and its send to its successor in the
    ring's one order (position 0 sends first and receives last; every
    other position receives, then sends), so a chain of blocking hops
    resolves edge by edge."""

    def __init__(self, owner: "TPGroup", pairs: dict, n: int, me: int):
        self.owner, self.pairs, self.n, self.me = owner, pairs, n, me

    def _hop(self, edge: int, buf: torch.Tensor):
        pg, root = self.pairs[edge % self.n]
        opts = dist.BroadcastOptions()
        opts.rootRank = root
        pg.broadcast([buf], opts).wait()

    def exchange(self, send: Optional[torch.Tensor], recv_bytes: int,
                 counts: tuple = ("send", "recv")) -> Optional[torch.Tensor]:
        """Send ``send`` (a ``pack`` buffer, or None: no hop out) to the
        successor and receive ``recv_bytes`` (0: no hop in) from the
        predecessor; both ends of an edge must agree on whether it hops.
        Returns the received buffer. ``counts``: the keys the send and the
        receive count under (one key twice: a ring rotation counts once)."""
        got = None

        def recv():
            nonlocal got
            got = torch.empty(recv_bytes, dtype=torch.uint8,
                              device=self.owner.device)
            self._hop(self.me - 1, got)
            self.owner.count(counts[1])

        def out():
            self._hop(self.me, send)
            if counts[0] != counts[1]:
                self.owner.count(counts[0])

        if self.me == 0:
            if send is not None:
                out()
            if recv_bytes:
                recv()
        else:
            if recv_bytes:
                recv()
            if send is not None:
                out()
        return got


class SubGroup:
    """A data subgroup of a ``TPGroup`` (a tp cell, an expert group or an
    sp ring): ``rank`` and ``world`` within it; its collectives count in
    the owner's ``counts``."""

    def __init__(self, owner: "TPGroup", pg, rank: int, world: int):
        self.owner, self.pg, self.rank, self.world = owner, pg, rank, world
        self.device = owner.device

    def all_reduce(self, t: torch.Tensor, key: str = "all_reduce"
                   ) -> torch.Tensor:
        t = t.contiguous()
        self.pg.allreduce([t]).wait()
        self.owner.count(key)
        return t

    def gather(self, local: torch.Tensor, key: str = "gather"
               ) -> torch.Tensor:
        n = local.shape[-1]
        full = local.new_zeros(*local.shape[:-1], n * self.world)
        full[..., self.rank * n:(self.rank + 1) * n] = local
        self.pg.allreduce([full]).wait()
        self.owner.count(key)
        return full


class ExpertGroup(SubGroup):
    """The tp × ep ranks of one (p, s) cell, in grid order (rank t·ep +
    e): the group that sums the routed experts' partials. ``ep`` its ep
    size, ``tp_rank`` / ``ep_rank`` this rank's t and e. ``route_sum``
    folds in the bits of every router input this rank routed
    (``note_route``): each rank computes the gates from its own copy of
    the hidden state, so the sums agree on every rank of the group only
    if every rank routed the same bits."""

    def __init__(self, owner: "TPGroup", pg, rank: int, world: int,
                 ep: int):
        super().__init__(owner, pg, rank, world)
        self.ep, self.tp_rank, self.ep_rank = ep, rank // ep, rank % ep
        self.route_sum = torch.zeros((), dtype=torch.int64,
                                     device=self.device)

    def note_route(self, x: torch.Tensor):
        bits = x.detach().contiguous().view(
            torch.int16 if x.element_size() == 2 else torch.int32)
        self.route_sum += bits.sum(dtype=torch.int64)


def _gloo(store, rank: int, world: int, timeout):
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    opts._devices = [dist.ProcessGroupGloo.create_device(
        hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(store, rank, world, opts)


def _await_ranks(store, world: int, alive: Callable[[], None]):
    """Wait until every rank has written its key, calling ``alive`` (which
    raises when a rank's process died) every few seconds."""
    keys = [f"joined/{r}" for r in range(world)]
    deadline = time.monotonic() + JOIN_TIMEOUT.total_seconds()
    while True:
        try:
            store.wait(keys, datetime.timedelta(seconds=2))
            return
        except RuntimeError:   # not yet (DistStoreError is one)
            alive()
            if time.monotonic() > deadline:
                raise RuntimeError(f"tp ranks did not join within "
                                   f"{JOIN_TIMEOUT}") from None


class TPGroup:
    """Rank ``rank`` of a group of ``world`` processes on ``device``'s
    type; joining blocks until every rank has joined. Rank 0 passes
    ``alive``, which raises when a follower's process has died, so a
    follower that fails before joining fails the join. ``configure``
    lays it out on a grid for one model."""

    BASE_COUNTS = ("all_reduce", "gather", "broadcast")

    def __init__(self, rank: int, world: int, device: torch.device,
                 store_path: str, alive: Optional[Callable] = None):
        self.rank, self.world = rank, world
        self.device = rank_device(device, rank)
        self.backend = data_backend(device, world)
        store = dist.FileStore(store_path, world)
        store.set(f"joined/{rank}", "1")
        if alive is not None:
            _await_ranks(store, world, alive)
        self._store = store
        self.control = _gloo(dist.PrefixStore("control", store), rank, world,
                             CONTROL_TIMEOUT)
        self.data = self._data_pg(dist.PrefixStore("data", store), rank,
                                  world)
        # NCCL builds its communicators at the first collective (seconds):
        # pay that here, at load, not in the first request
        self.data.allreduce([torch.zeros(1, device=self.device)]).wait()
        self.counts = dict.fromkeys(self.BASE_COUNTS, 0)
        self._layouts = 0
        self._subgroups: list = []
        self.release_grid()

    def _data_pg(self, store, rank: int, world: int):
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = DATA_TIMEOUT
            return dist.ProcessGroupNCCL(store, rank, world, opts)
        return _gloo(store, rank, world, DATA_TIMEOUT)

    def configure(self, spec: MeshSpec):
        """Lay the group out as ``spec``'s grid (pp · sp · tp · ep ==
        world) and build this rank's subgroups. Every rank calls it at
        the same point (a load), and builds its groups in one global
        order (tp cells, expert groups, sp rings, then pp rings, each by
        its first rank), so no two ranks wait on each other's rendezvous
        in a cycle. The counts start at zero with the keys ``spec``
        uses."""
        if spec.world != self.world:
            raise ValueError(f"mesh {spec.axis_sizes()} needs {spec.world} "
                             f"ranks; the group has {self.world}")
        self.release_grid()
        self._layouts += 1
        self.spec = spec
        self.coords = p, s, t, e = grid_coords(spec, self.rank)
        keys = list(self.BASE_COUNTS)
        if spec.pp > 1:
            keys += ["send", "recv"]
        if spec.sp > 1:
            keys += ["ring", "combine"]
        self.counts = dict.fromkeys(keys, 0)
        self.tp = self if spec.tp == self.world else None
        if spec.tp > 1 and spec.tp < self.world:
            self.tp = self._subgroup(f"tp/{p}/{s}/{e}", [
                grid_rank(spec, p, s, j, e) for j in range(spec.tp)])
        cell = spec.tp * spec.ep
        if cell > 1:
            if cell == self.world:
                pg = self.data
            elif spec.ep == 1:   # the tp cell's own group
                pg = self.tp.pg
            else:
                first = grid_rank(spec, p, s, 0, 0)
                pg = self._new_pg(f"ep/{p}/{s}",
                                  list(range(first, first + cell)))
            self.experts = ExpertGroup(self, pg, t * spec.ep + e, cell,
                                       spec.ep)
        if spec.sp > 1:
            members = [grid_rank(spec, p, j, t, e) for j in range(spec.sp)]
            self.sp = self._subgroup(f"sp/{p}/{t}/{e}", members)
            self.sp_ring = self._ring(f"spring/{p}/{t}/{e}", members, s)
        if spec.pp > 1:
            self.pp = self._ring(f"pp/{s}/{t}/{e}", [
                grid_rank(spec, j, s, t, e) for j in range(spec.pp)], p)

    def _new_pg(self, name: str, members: List[int]):
        store = dist.PrefixStore(f"grid{self._layouts}/{name}", self._store)
        pg = self._data_pg(store, members.index(self.rank), len(members))
        self._subgroups.append(pg)
        return pg

    def _subgroup(self, name: str, members: List[int]) -> "SubGroup":
        return SubGroup(self, self._new_pg(name, members),
                        members.index(self.rank), len(members))

    def _ring(self, name: str, members: List[int], me: int) -> Ring:
        """The ring over ``members`` (in ring order; this rank at ``me``):
        a two-rank group per edge this rank lies on, by unordered pair."""
        n = len(members)
        pairs, made = {}, {}
        for e in sorted({(me - 1) % n, me}):
            a, b = sorted((e, (e + 1) % n))
            if (a, b) not in made:
                made[a, b] = self._new_pg(f"{name}/{a}-{b}",
                                          [members[a], members[b]])
            pairs[e] = (made[a, b], 0 if e == a else 1)
        return Ring(self, pairs, n, me)

    def release_grid(self):
        """Drop the subgroups of the last ``configure`` (an NCCL one shut
        down); the group serves as one tp group of ``world`` again."""
        if self.backend == "nccl":
            for pg in self._subgroups:
                pg.shutdown()
        self._subgroups = []
        self.spec = MeshSpec(tp=self.world)
        self.coords = (0, 0, self.rank, 0)
        self.tp, self.sp, self.sp_ring, self.pp = self, None, None, None
        self.experts = None
        self.counts = dict.fromkeys(self.BASE_COUNTS, 0)

    def count(self, key: str):
        self.counts[key] = self.counts.get(key, 0) + 1

    def close(self):
        """Shut the data groups down; every rank calls it when the group
        stops. An NCCL group otherwise keeps its communicators and
        monitor threads for the life of the process."""
        self.release_grid()
        if self.backend == "nccl":
            self.data.shutdown()

    # ---- data collectives (the model's) --------------------------------

    def all_reduce(self, t: torch.Tensor, key: str = "all_reduce"
                   ) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in t's dtype (the JAX
        package's ``psum``). Returns a contiguous tensor."""
        t = t.contiguous()
        self.data.allreduce([t]).wait()
        self.count(key)
        return t

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Concatenate each rank's ``local`` [..., n] along the last dim,
        in rank order, on every rank: one sum of zero-padded slices, which
        is exact and runs on both backends (gloo takes only broadcast and
        all_reduce on CUDA tensors)."""
        n = local.shape[-1]
        full = local.new_zeros(*local.shape[:-1], n * self.world)
        full[..., self.rank * n:(self.rank + 1) * n] = local
        self.data.allreduce([full]).wait()
        self.counts["gather"] += 1
        return full

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        self.data.broadcast([t], opts).wait()
        self.counts["broadcast"] += 1
        return t

    # ---- control messages (the lockstep executor's) ---------------------

    def broadcast_object(self, obj: Any = None) -> Any:
        """Rank 0's picklable ``obj`` on every rank."""
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        payload = (torch.frombuffer(bytearray(pickle.dumps(obj)),
                                    dtype=torch.uint8)
                   if self.rank == 0 else None)
        size = torch.tensor([0 if payload is None else payload.numel()],
                            dtype=torch.int64)
        self.control.broadcast([size], opts).wait()
        if payload is None:
            payload = torch.empty(int(size), dtype=torch.uint8)
        self.control.broadcast([payload], opts).wait()
        if self.rank == 0:
            return obj
        return pickle.loads(payload.numpy().tobytes())

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.world)]
        self.control.allgather(
            [sizes], [torch.tensor([payload.numel()])]).wait()
        n = max(int(s) for s in sizes)
        padded = torch.zeros(n, dtype=torch.uint8)
        padded[:payload.numel()] = payload
        outs = [torch.empty(n, dtype=torch.uint8) for _ in range(self.world)]
        self.control.allgather([outs], [padded]).wait()
        return [pickle.loads(o[:int(s)].numpy().tobytes())
                for o, s in zip(outs, sizes)]
