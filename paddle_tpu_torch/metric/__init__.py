"""``metric`` of the port: a port of ``paddle_tpu/metric/__init__.py``.

``accuracy`` and ``Accuracy.compute`` run on the tensors' device (the
top-k by a stable descending sort, as ``jnp.argsort(-x)`` orders ties);
the streaming ``update``/``accumulate`` of ``Accuracy``, ``Precision``,
``Recall`` and ``Auc`` count on the host, from tensors or numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _topk_hits(input, label, k):
    """[..., k] bools: is the label among the ``k`` largest (ties in
    index order)?"""
    input, label = torch.as_tensor(input), torch.as_tensor(label)
    idx = torch.argsort(-input, dim=-1, stable=True)[..., :k]
    lab = label.to(idx.device)
    if lab.dim() == idx.dim():
        lab = lab[..., 0]
    return idx == lab[..., None]


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is in the top ``k``: an f32 tensor
    of ones' shape (the mean with its dims kept)."""
    hit = _topk_hits(input, label, k).any(-1).float()
    return hit.mean(dim=tuple(range(hit.dim())), keepdim=True)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """[N, max(topk)] f32: 1 where the label is at that rank."""
        return _topk_hits(pred, label, max(self.topk)).float()

    def update(self, correct, *args):
        c = _np(correct)
        n = c.shape[0] if c.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            hit = c[..., :k].any(-1).sum()
            self.total[i] += float(hit)
            self.count[i] += n
            accs.append(float(hit) / max(n, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        out = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return out[0] if len(out) == 1 else out

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_pos = (p > 0.5).reshape(-1)
        lab = l.reshape(-1).astype(bool)
        self.tp += int((pred_pos & lab).sum())
        self.fp += int((pred_pos & ~lab).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_pos = (p > 0.5).reshape(-1)
        lab = l.reshape(-1).astype(bool)
        self.tp += int((pred_pos & lab).sum())
        self.fn += int((~pred_pos & lab).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels).reshape(-1)
        pos_prob = p[:, 1] if p.ndim == 2 and p.shape[1] == 2 else \
            p.reshape(-1)
        bins = np.minimum((pos_prob * self.num_thresholds).astype(int),
                          self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name
