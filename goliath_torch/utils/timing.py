"""Device time of a call on the card, with CUDA events."""

from __future__ import annotations

import torch


def cuda_call_ms(fn):
    """(fn()'s result, the device time of that one call in ms). PyTorch
    returns before the card finishes, so the time is taken between two
    events on the current stream, after a synchronise."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over ``reps`` calls after ``warmup``
    calls."""
    for _ in range(warmup):
        fn()

    def repeated():
        for _ in range(reps):
            fn()

    return cuda_call_ms(repeated)[1] / reps
