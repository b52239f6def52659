"""Device time of a call from CUDA events, with a cold L2: the yardstick the trace readers are checked by."""

from __future__ import annotations

import torch


def flush_buffer(device: torch.device) -> torch.Tensor:
    """256 MB on the card, five times the H100's L2: zeroing it before a timed call leaves the L2 cold."""
    return torch.empty(64 << 20, dtype=torch.float32, device=device)


def time_ms(fn, reps: int = 20, flush: torch.Tensor = None) -> float:
    """Mean device time of ``fn`` with a cold L2 (``flush`` zeroed first), from CUDA events around each call.

    A sleep kernel first holds the stream while the host queues every call, so the host's launch
    overhead never opens a gap between the events.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(50_000_000)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps
