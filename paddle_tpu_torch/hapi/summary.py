"""``paddle.summary``: the parameter table of a network, port of
``paddle_tpu/hapi/summary.py``. A parameter is trainable where it
requires a gradient; the returned dict is the JAX package's."""

from __future__ import annotations

__all__ = ["summary"]


def summary(net, input_size=None, dtypes=None, input=None):
    """Print each parameter's name, shape and count, then the totals;
    returns ``{"total_params": n, "trainable_params": m}``."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    print(f"{'Layer (param)':<{width}}{'Shape':<24}{'Param #':>12}")
    print("-" * (width + 36))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<24}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
