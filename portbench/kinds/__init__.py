"""Cell kinds: ``portbench/kinds/<kind>.py`` runs a cell whose traffic file
says ``"kind": "<kind>"``, through ``run(cell, seed, seconds, traced,
device, t0)``."""

import time

import torch


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if on_card(device):
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    """The allocator's peak since :func:`reset_peak` (0 on the CPU)."""
    return torch.cuda.max_memory_allocated() if on_card(device) else 0


def free(device) -> None:
    """Hand the program's freed blocks back before the reference runs."""
    if on_card(device):
        torch.cuda.empty_cache()


def timings(t0: float, marks, start: float, window_s: float,
            judged: float):
    """Where a run's time went: set-up (the harness and torch, the port's
    import, the inputs, the model and its warm-up), window, reference."""
    edges = [t0] + list(marks) + [start]
    names = ("torch_import", "port_import", "inputs", "warmup")
    out = {"setup": start - t0}
    out.update({n: b - a for n, a, b in zip(names, edges, edges[1:])})
    out.update(window=window_s, reference=time.perf_counter() - judged)
    return out
