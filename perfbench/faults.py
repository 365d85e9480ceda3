"""Faults planted under a job cell's timed path, each of which the
comparison has to reject: the CPU tests plant them in tiny runs, and
``control.py --fault`` reads them at a cell's own size on the card.

``planted(name)`` wraps one function of the program for the length of
a ``with`` block (``None`` plants nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib


def _lloyd_unchanged(f):
    def step(points, cents, *a, **k):
        _, assign = f(points, cents, *a, **k)
        return cents, assign
    return step


def _adam_unchanged(f):
    def update(params, grads, state, **k):
        return params, state
    return update


def _half_batch(f):
    def schedule(order, n, bs, steps, padded_bs):
        idx, mask = f(order, n, bs, steps, padded_bs)
        mask[:, padded_bs // 2:] = 0.0
        return idx, mask
    return schedule


def _eval_altered(f):
    def score(*a, **k):
        out = f(*a, **k).copy()
        out[0] += 1.0
        return out
    return score


def _coreset_altered(f):
    def select(*a, **k):
        idx, w, groups = f(*a, **k)
        return idx[1:], w[1:], groups
    return select


def _fewer_lloyd_steps(f):
    def fit(*a, **k):
        k["iters"] = max(1, k.get("iters", 25) // 5)
        return f(*a, **k)
    return fit


def _stopped_early(f):
    def train(part, cfg, *a, **k):
        cfg = dataclasses.replace(
            cfg, max_epochs=max(1, cfg.max_epochs - 1),
            convergence_eps=cfg.convergence_eps * 10)
        return f(part, cfg, *a, **k)
    return train


#: name: (module, function, wrapper)
FAULTS = {
    "lloyd step returns its state": ("repro_torch.core.kmeans", "lloyd_step",
                                     _lloyd_unchanged),
    "adam step returns its state": ("repro_torch.train.vfl", "adam_update",
                                    _adam_unchanged),
    "half of each batch left out": ("repro_torch.train.vfl",
                                    "epoch_schedule", _half_batch),
    "an evaluation answer altered": ("repro_torch.serve.vfl",
                                     "score_partition", _eval_altered),
    "a coreset answer altered": ("repro_torch.core.coreset",
                                 "select_coreset", _coreset_altered),
    "a fifth of the Lloyd steps": ("repro_torch.core.coreset", "kmeans_fit",
                                   _fewer_lloyd_steps),
    "training stopped early": ("repro_torch.core.treecss", "train_splitnn",
                               _stopped_early),
}
#: the faults that touch the coreset, which a starall job bypasses
CORESET_FAULTS = ("lloyd step returns its state", "a coreset answer altered",
                  "a fifth of the Lloyd steps")


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    module, attr, wrap = FAULTS[name]
    mod = importlib.import_module(module)
    saved = getattr(mod, attr)
    setattr(mod, attr, wrap(saved))
    try:
        yield
    finally:
        setattr(mod, attr, saved)
