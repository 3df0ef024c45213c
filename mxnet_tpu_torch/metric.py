"""Evaluation metrics — the port of ``mxnet_tpu/metric.py``:
``EvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``CrossEntropy``,
``CompositeEvalMetric`` and ``create``.

Two update paths per metric, as in the JAX package:

- ``update(labels, preds)`` — the reference's numpy path: fetches the
  predictions to the host every call.
- ``device_update(label, pred)`` — a tensor form returning ``(sum_delta,
  inst_delta)`` on the predictions' device.  The fused train step
  (``parallel/train_step.py``) folds it into every step: the sum is
  added IN PLACE into a fixed device accumulator (so a captured step's
  replays keep adding to it) and the instance count, known from shapes,
  is host arithmetic done once per step outside the step's body.  The
  host reads the accumulator only when :meth:`EvalMetric.get` drains it
  and zeroes it in place (``metric.host_syncs`` counts the drains), so
  the steady-state fit loop never waits on the device for a metric.
"""
from __future__ import annotations

import numpy

import torch

from . import instrument

__all__ = ['EvalMetric', 'CompositeEvalMetric', 'Accuracy', 'TopKAccuracy',
           'CrossEntropy', 'create', 'check_label_shapes']


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError('Shape of labels {} does not match shape of '
                         'predictions {}'.format(label_shape, pred_shape))


class EvalMetric(object):
    """Base metric (metric.py:22)."""

    # subclasses with a device form override this with
    # ``device_update(self, label, pred) -> (sum_delta, inst_delta)``
    device_update = None

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, label, pred):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num
        # the device accumulator, created on first use, is zeroed in
        # place, never replaced: captured steps hold its address.
        # _dev_inst is the host count pending in it (None: nothing)
        acc = getattr(self, '_dev_sum', None)
        if acc is not None:
            acc.zero_()
        self._dev_sum = acc
        self._dev_inst = None

    # -- on-device accumulation --------------------------------------------
    def device_capable(self):
        """Whether a device form exists and the single-accumulator form
        is in use."""
        return callable(self.device_update) and self.num is None

    def device_fold(self, label, pred):
        """Add this batch's deltas to the accumulators: the sum stays a
        device tensor (no host synchronisation), the instance count is
        known from shapes on the host."""
        self._fold_count(self._fold_device(label, pred))

    def _accumulators(self, device):
        """The device accumulators on ``device``, made (zero) if absent:
        a step captures their addresses, so they exist before it."""
        device = torch.device(device)
        if self._dev_sum is not None and self._dev_sum.device != device:
            self._drain_device()
            self._dev_sum = None
        if self._dev_sum is None:
            self._dev_sum = torch.zeros((), dtype=torch.float32,
                                        device=device)
        return [self._dev_sum]

    def _fold_device(self, label, pred):
        """The device half of :meth:`device_fold`: the batch's sum added
        in place into the accumulator.  Returns the batch's instance
        count for :meth:`_fold_count`."""
        ds, dn = self.device_update(label, pred)
        self._accumulators(ds.device)[0].add_(ds)
        return int(dn)

    def _fold_count(self, n):
        """The host half of :meth:`device_fold`."""
        self._dev_inst = (self._dev_inst or 0) + n

    def _take_device_state(self):
        """Pending accumulators: ``[(owner, sum, inst)]``."""
        if self._dev_inst is None:
            return []
        n, self._dev_inst = self._dev_inst, None
        return [(self, self._dev_sum, n)]

    def _drain_device(self):
        """Fold the device accumulators into the host sums and zero
        them in place: THE host sync of the device-metric path, one per
        drain however many accumulators are pending."""
        pending = self._take_device_state()
        if not pending:
            return
        sums = torch.stack([s.double() for _, s, _ in pending]).cpu()
        instrument.inc('metric.host_syncs')
        for (metric, acc, n), s in zip(pending, sums.tolist()):
            acc.zero_()
            metric.sum_metric += s
            metric.num_inst += n

    def get(self):
        self._drain_device()
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float('nan'))
            return (self.name, self.sum_metric / self.num_inst)
        names = ['%s_%d' % (self.name, i) for i in range(self.num)]
        values = [x / y if y != 0 else float('nan')
                  for x, y in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return 'EvalMetric: {}'.format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics (metric.py:81)."""

    def __init__(self, **kwargs):
        super().__init__('composite')
        self.metrics = kwargs.get('metrics', [])

    def add(self, metric):
        self.metrics.append(metric)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, 'metrics', []):
            metric.reset()

    def get(self):
        # one batched drain for every child, then per-child get()
        self._drain_device()
        names, results = [], []
        for metric in self.metrics:
            name, result = metric.get()
            names.append(name)
            results.append(result)
        return (names, results)

    def device_capable(self):
        return bool(self.metrics) and \
            all(m.device_capable() for m in self.metrics)

    def device_fold(self, label, pred):
        for metric in self.metrics:
            metric.device_fold(label, pred)

    def _accumulators(self, device):
        return [a for m in self.metrics for a in m._accumulators(device)]

    def _fold_device(self, label, pred):
        return [m._fold_device(label, pred) for m in self.metrics]

    def _fold_count(self, n):
        for metric, k in zip(self.metrics, n):
            metric._fold_count(k)

    def _take_device_state(self):
        return [p for m in self.metrics for p in m._take_device_state()]


def _host(arr):
    return arr.asnumpy() if hasattr(arr, 'asnumpy') else numpy.asarray(arr)


class Accuracy(EvalMetric):
    """Classification accuracy (metric.py:128)."""

    def __init__(self):
        super().__init__('accuracy')

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = _host(pred_label)
            label_np = _host(label).astype('int32')
            if pred.shape != label_np.shape:
                pred = numpy.argmax(pred, axis=1)
            pred = pred.astype('int32')
            check_label_shapes(label_np, pred)
            self.sum_metric += int((pred.flat == label_np.flat).sum())
            self.num_inst += len(pred.flat)

    def device_update(self, label, pred):
        if pred.shape != label.shape:
            pred = torch.argmax(pred, dim=1)
        hits = pred.to(torch.int32).reshape(-1) == \
            label.to(torch.int32).reshape(-1)
        return hits.sum().float(), hits.numel()


class TopKAccuracy(EvalMetric):
    """Top-k accuracy (metric.py:160)."""

    def __init__(self, **kwargs):
        super().__init__('top_k_accuracy')
        self.top_k = kwargs.get('top_k', 1)
        assert self.top_k > 1, 'Please use Accuracy if top_k is no more than 1'
        self.name += '_%d' % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            scores = _host(pred_label).astype('float32')
            truth = _host(label).astype('int32').ravel()
            if scores.ndim == 1:
                scores = scores[:, None]
            k = min(self.top_k, scores.shape[1])
            # stable argsort: among equal scores the higher class index
            # wins, the reference's tie-break at the k boundary
            topk = numpy.argsort(scores, axis=1, kind='stable')[:, -k:]
            self.sum_metric += int((topk == truth[:, None]).any(axis=1).sum())
            self.num_inst += scores.shape[0]

    def device_update(self, label, pred):
        scores = pred.float()
        truth = label.to(torch.int64).reshape(-1)
        if scores.ndim == 1:
            scores = scores[:, None]
        k = min(self.top_k, scores.shape[1])
        topk = torch.argsort(scores, dim=1, stable=True)[:, -k:]
        hits = (topk == truth[:, None]).any(dim=1)
        return hits.sum().float(), scores.shape[0]


class CrossEntropy(EvalMetric):
    """Cross-entropy of softmax outputs (metric.py:370)."""

    def __init__(self, eps=1e-8):
        super().__init__('cross-entropy')
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _host(label).ravel()
            pred = _host(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]

    def device_update(self, label, pred):
        # read as jnp.take_along_axis reads it: -1 (padding) wraps to the
        # last class, a label outside [-C, C) gives NaN
        from .ops.tensor import fill_index
        label = label.reshape(-1).to(torch.int64)
        index, kept = fill_index(label, pred.shape[1])
        prob = torch.gather(pred.float(), 1, index[:, None])[:, 0]
        prob = prob.masked_fill(~kept, float('nan'))
        return (-torch.log(prob + self.eps)).sum(), label.shape[0]


def create(metric, **kwargs):
    """Create by name, list of names, EvalMetric (metric.py:462)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite_metric = CompositeEvalMetric()
        for child_metric in metric:
            composite_metric.add(create(child_metric, **kwargs))
        return composite_metric
    metrics = {'acc': Accuracy, 'accuracy': Accuracy, 'ce': CrossEntropy,
               'top_k_accuracy': TopKAccuracy}
    try:
        return metrics[metric.lower()](**kwargs)
    except Exception:
        raise ValueError('Metric must be one of {}'.format(sorted(metrics)))
