"""A stack of structurally identical layers run as one unit, with the
recompute structure of the JAX package's ``lax.scan`` over them.

Port of ``paddle_tpu/nn/scan.py`` (``can_scan``, ``scan_layers``). On
the TPU the scan exists for code size: an unrolled stack compiles to one
copy of the layer per layer, a scan to one. Here nothing is compiled
per layer (each layer launches its kernels), so that reason does not
exist; the port keeps the structure for its memory and recompute
behaviour: with ``remat`` each layer is recomputed whole in the backward
(under ``FLAGS_recompute_policy``), and ``full_save_interval`` groups
the layers so that the last of each group keeps its activations. The
layers run in a plain loop, one after the other, so the numbers are
those of the unrolled loop over the same layers.

``can_scan`` gives the JAX package's decisions and decline reasons,
each reason logged once through ``profiler.trace.log_perf_event``
(``scan/declined``).
"""

from __future__ import annotations

import warnings

from ..incubate.recompute import recompute
from ..profiler.trace import log_perf_event

__all__ = ["scan_layers", "can_scan"]


def _log_decline(reason):
    log_perf_event("scan/declined",
                   f"scan_layers declined ({reason}); falling back to the "
                   "unrolled per-layer path",
                   once_key=("scan/declined", reason))


def can_scan(layers):
    """True iff the stack is scannable: more than one layer, one class and
    the same parameter shapes and dtypes in every layer. A decline is
    logged at INFO on the ``paddle_tpu_torch.perf`` logger, once a
    reason."""
    layers = list(layers)
    if len(layers) < 2:
        _log_decline(f"stack has {len(layers)} layer(s), need >= 2")
        return False
    sig0 = None
    for i, layer in enumerate(layers):
        sig = (type(layer), tuple((tuple(p.shape), str(p.dtype))
                                  for p in layer.parameters()))
        if sig0 is None:
            sig0 = sig
        elif sig != sig0:
            what = "class" if sig[0] is not sig0[0] else \
                "parameter shapes/dtypes"
            _log_decline(
                f"layer {i} ({type(layer).__name__}) differs from layer 0 "
                f"({sig0[0].__name__}) in {what}")
            return False
    if not sig0[1]:
        _log_decline(f"layers ({sig0[0].__name__}) have no parameters")
        return False
    return True


def scan_layers(layers, x, extra_inputs=(), remat=False,
                full_save_interval=0):
    """``layers[L-1](...layers[0](x, *extra_inputs)..., *extra_inputs)``.

    ``extra_inputs`` go unchanged to every layer after ``x`` (a mask, the
    RoPE tables). ``remat`` recomputes each layer in the backward.
    ``full_save_interval`` (fs, with ``remat``) runs the stack as L / fs
    groups of fs layers, the first fs - 1 recomputed and the group's last
    one saved whole; fs 1 is no recompute at all. It must tile L: if not,
    a warning and fs 0. ``None`` is 0 (the JAX package's tuner cache,
    which it consults there, is not ported)."""
    layers = list(layers)
    L = len(layers)
    fs = max(int(full_save_interval or 0), 0)
    if fs and not remat:
        fs = 0
    if fs == 1:
        remat, fs = False, 0
    if fs and L % fs:
        warnings.warn(
            f"scan_layers: full_save_interval={fs} must tile "
            f"num_layers ({L}); running without the dose",
            stacklevel=2)
        log_perf_event(
            "scan/full_save_interval_dropped",
            f"full_save_interval={fs} does not tile num_layers={L}; "
            "remat dose dropped (every layer recomputes)",
            once_key=("scan/fs_dropped", fs, L))
        fs = 0
    for i, layer in enumerate(layers):
        saved = not remat or (fs and i % fs == fs - 1)
        x = layer(x, *extra_inputs) if saved else \
            recompute(layer, x, *extra_inputs)
    return x
