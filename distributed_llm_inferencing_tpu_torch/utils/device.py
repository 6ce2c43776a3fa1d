"""Device resolution and inventory for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. A missing
GPU is an error, never a quiet switch to the CPU: the CPU path runs the
kernels' plain versions, which are a reference, not a serving path.

In a group of ranks (parallel/mesh.py: a pp × sp × tp grid) rank r runs
on ``cuda:(r % device_count)`` (``rank_device``), and the group's data
collectives and hops, its subgroups' too, go over NCCL when every rank
has a card of its own and over gloo when ranks share a card or run on
the CPU (``data_backend``): NCCL refuses two ranks on one device. That
is a rule of the layout, chosen before the group forms, not a fallback
after a failure.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name as a torch dtype (the kernels take these
    two)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} "
                         f"(one of {sorted(_DTYPES)})") from None


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> cuda. Raises when CUDA is asked for and absent."""
    d = torch.device(device if device is not None else "cuda")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d} (cuda or cpu)")
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path explicitly")
    return d


def inventory(device: torch.device) -> dict:
    """``{"platform", "kind", "count", "devices": [...]}`` for /health,
    read from torch.cuda (or naming the host CPU when that was asked)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "devices": [{"id": 0, "platform": "cpu", "kind": "cpu"}]}
    devices = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        devices.append({
            "id": i, "platform": "gpu", "kind": props.name,
            "memory_bytes": int(props.total_memory),
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
        })
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "devices": devices}


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of grid rank ``rank`` when the group runs on ``device``'s
    type: ``cuda:(rank % device_count)``, or the CPU."""
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def data_backend(device: torch.device, world: int) -> str:
    """"nccl" when each of ``world`` ranks on ``device``'s type has a
    card of its own, else "gloo" (a shared card, or the CPU)."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"
