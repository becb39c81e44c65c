"""What the drivers share: the card's memory peak, freeing the program
before the reference runs, and a seeded reservoir of answers to check."""

import gc
import importlib
import random
import time

import torch


def reference(run):
    """The plain reference module of the run's configuration."""
    return importlib.import_module(
        f"portbench.reference.{run.cell['config']}")


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def reset_peak(device):
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def read_peak(device):
    """``torch.cuda.max_memory_allocated()`` since set-up began (None on the
    CPU)."""
    if device != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def release(device):
    """Free what the program held, before the reference runs."""
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from a
    seed, whatever their count."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, make):
        """``make()`` gives the item; it is called only if kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = make()


def now():
    return time.perf_counter()


class Phases:
    """Seconds of each part of set-up, for the run's notes."""

    def __init__(self, t0):
        self.last = t0
        self.parts = []

    def mark(self, name):
        t = now()
        self.parts.append(f"{name} {t - self.last:.3f}")
        self.last = t

    def note(self):
        return "set-up seconds: " + ", ".join(self.parts)
