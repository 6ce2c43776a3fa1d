"""Tensor-parallel groups: the port's counterpart of the device mesh.

The JAX package (its ``parallel/mesh.py``) runs one program over a
``jax.sharding.Mesh`` of five named axes (dp, pp, sp, tp, ep) from one
process, and GSPMD inserts the collectives. PyTorch's idiom is one
process per rank, so here the mesh is a group of processes, each holding
its shard of the weights on its own device (utils/device.py
``rank_device``), and the model calls the collectives itself
(models/transformer.py).

- ``MeshSpec`` / ``validate_spec``: the JAX package's spec and its shape
  checks. The port serves tensor parallelism only: dp, pp, sp or ep
  above 1 raise ``NotImplementedError``; tp above the kv head count
  replicates the kv heads, as the JAX package does.
- ``TPGroup``: one rank's view of a tp group of processes on one host,
  created or joined through a file store at ``store_path``. Two
  process groups: ``control`` (gloo, on the CPU) carries the lockstep
  executor's ops (runtime/lockstep.py); ``data`` carries the model's
  tensors, over the backend ``data_backend`` picks from the layout.
  Every data collective is counted in ``counts``: ``all_reduce`` (the
  embedding's, o's and down's sums, and "rms_full" q/k norms' mean
  squares), ``gather`` (the head's logits) and ``broadcast`` (the
  engine leader's sampled tokens).

A collective that fails raises; nothing retries or falls back to one
rank.
"""

from __future__ import annotations

import dataclasses
import datetime
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
    """The JAX package's tp shape checks, plus what the port does not
    serve under tp yet; raises before any weight is drawn.

    As the JAX package: tp divides the heads and the intermediate width;
    it divides the kv heads or exceeds them (the kv heads then replicate,
    parallel/sharding.py ``kv_map``). The port's own: tp divides the
    vocabulary (the embedding and the head split it), and an int4
    row-parallel leaf's din splits into tp split-half chunks. Refused by
    name (``tp_gaps``): the experts, latent attention, ``qkv_clip`` and
    sinks (ROADMAP Queue A item 9.8); and any axis but tp above 1 (items
    9.4, 9.7, 9.8)."""
    later = [f"{a}={n}" for a, n in spec.axis_sizes().items()
             if a != "tp" and n > 1]
    if later:
        raise NotImplementedError(
            f"mesh {', '.join(later)}: only tensor parallelism is ported; "
            "pp, sp, dp and ep are later slices (ROADMAP Queue A items "
            "9.4, 9.7, 9.8)")
    tp = spec.tp
    if tp == 1:
        return
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        tp_gaps)
    gaps = tp_gaps(cfg)
    if gaps:
        raise NotImplementedError(
            f"tp={tp} with {', '.join(gaps)} is a later slice of the port "
            "(ROADMAP Queue A item 9.8: the experts, latent attention, "
            "qkv_clip and sinks under tp); load it without a mesh")
    if cfg.num_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads}")
    if tp <= cfg.num_kv_heads and cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads} (or "
            "exceed it, which replicates the kv heads)")
    if cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide intermediate_size="
                         f"{cfg.intermediate_size}")
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size} "
                         "(the embedding and the head split the vocabulary)")
    if cfg.quant == "int4":
        # the row-parallel o and down are repacked into tp chunk-local
        # split-half packs (parallel/sharding.py)
        for name, din in (("o", cfg.q_dim), ("down", cfg.intermediate_size)):
            if din % (2 * tp):
                raise ValueError(
                    f"int4 {name}: din={din} does not split into {tp} "
                    "split-half chunks")


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
    """Rank ``rank`` of a tp group of ``world`` processes on ``device``'s
    type; joining blocks until every rank has joined. Rank 0 passes
    ``alive``, which raises when a follower's process has died, so a
    follower that fails before joining fails the join."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 store_path: str, alive: Optional[Callable] = None):
        self.rank, self.world = rank, world
        self.device = rank_device(device, rank)
        self.backend = data_backend(device, world)
        store = dist.FileStore(store_path, world)
        store.set(f"joined/{rank}", "1")
        if alive is not None:
            _await_ranks(store, world, alive)
        self.control = _gloo(dist.PrefixStore("control", store), rank, world,
                             CONTROL_TIMEOUT)
        data_store = dist.PrefixStore("data", store)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = DATA_TIMEOUT
            self.data = dist.ProcessGroupNCCL(data_store, rank, world, opts)
        else:
            self.data = _gloo(data_store, rank, world, DATA_TIMEOUT)
        # NCCL builds its communicators at the first collective (seconds):
        # pay that here, at load, not in the first request
        self.data.allreduce([torch.zeros(1, device=self.device)]).wait()
        self.counts = {"all_reduce": 0, "gather": 0, "broadcast": 0}

    def close(self):
        """Shut the data group down; every rank calls it when the group
        stops. An NCCL group otherwise keeps its communicators and
        monitor threads for the life of the process."""
        if self.backend == "nccl":
            self.data.shutdown()

    # ---- data collectives (the model's) --------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in t's dtype (the JAX
        package's ``psum``). Returns a contiguous tensor."""
        t = t.contiguous()
        self.data.allreduce([t]).wait()
        self.counts["all_reduce"] += 1
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

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place."""
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
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
