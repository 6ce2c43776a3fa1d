"""Device traces that hold every kernel of the work they time.

``torch.profiler`` on an H100 drops a prefix of the device kernels it
saw, of a length that varies from trace to trace: in 156 traces of
decode-step replays (llama-3-8b, gpt2-xl, bloom-7b1; 12 per program
behind one 10 ms spin) the cut fell before the spin or 0.3 to 3 ms after
it, up to 19 kernels into the replay, and one trace held no kernel at
all. A device time summed from such a trace is short by the kernels it
lost. ``bracketed_trace`` runs the work behind spins on the current
stream and keeps only a trace that shows, by its spins, that nothing of
the work was cut; ``kernel_times`` reads the work's kernels from it, the
spins and the host-side ``aten::`` rows left out. chip_smoke.py and the
profile tools (profile_engine, profile_batched, profile_fused) time
through them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

# the spins: one of ~10 ms at 1.98 GHz, then LEAD_IN of ~10 us each before
# the work and one after it
SPIN = "spin_kernel"
SPIN_CYCLES = 20_000_000
MARK_CYCLES = 20_000
LEAD_IN = 256
TRACES = 4


def _device_us(evt) -> float:
    """Self device time of one ``key_averages()`` row, in us (the
    attribute's name differs across torch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def bracketed_trace(work: Callable, activities=None,
                    setup: Optional[Callable] = None):
    """``work()`` under torch.profiler, in a trace that holds every kernel
    it ran: returns the profile, what ``work`` returned, and the number
    of traces taken.

    ``work`` runs on the current stream behind a long spin and LEAD_IN
    short ones, and before one more short spin; a trace is kept when it
    holds at least one lead-in spin and the closing one, which (the drop
    being a prefix) puts all of ``work``'s kernels inside it. Otherwise
    it is taken again with twice the lead-in, TRACES times at most.
    ``work`` must do the same device work each time it is called;
    ``setup`` (optional) runs before each attempt, outside the trace,
    to put that work back in place."""
    from torch.profiler import ProfilerActivity, profile
    if activities is None:
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    lead_in, sizes = LEAD_IN, []
    for _ in range(TRACES):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(lead_in):
                torch.cuda._sleep(MARK_CYCLES)
            out = work()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        device = sorted((e.time_range.start, e.name) for e in prof.events()
                        if str(e.device_type).endswith("CUDA"))
        sizes.append(len(device))
        if (len(device) > 1 and SPIN in device[-1][1]
                and any(SPIN in name for _, name in device[:-1])):
            return prof, out, len(sizes)
        lead_in *= 2
    raise AssertionError(f"none of {TRACES} traces held all the kernels "
                         f"of the work (device kernels per trace: {sizes})")


def kernel_times(prof) -> Dict[str, dict]:
    """The work's kernels in a ``bracketed_trace`` profile: name ->
    {"device_ms", "calls"}, without the spins and the ``aten::`` rows."""
    out = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.key and not evt.key.startswith("aten::") \
                and SPIN not in evt.key:
            out[evt.key] = {"device_ms": us / 1e3, "calls": evt.count}
    return out
