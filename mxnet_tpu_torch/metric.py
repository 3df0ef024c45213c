"""Evaluation metrics — the port of ``mxnet_tpu/metric.py``:
``EvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``F1``, ``Perplexity``,
``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``, ``Torch``/``Caffe``,
``CustomMetric``, ``np``, ``CompositeEvalMetric`` and ``create``.

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

Accuracy, TopKAccuracy, CrossEntropy, Perplexity, MAE, MSE and RMSE have
a device form; ``device_fold_key`` is the identity of the folded
computation (a fresh metric of equal key reuses a fused step).

Over a dp×tp mesh (``Module.fit(mesh=...)``) each rank folds its own rows
of the batch.  While such a fit runs it hands the metric its dp group
(:func:`set_dp_group`), and each drain sums the accumulators over dp (one
all-reduce, on every rank at the same drain) and counts dp times the
rank's instances, so a reading is the global batch's on every rank: a
callback that reads the metric inside the fit does so on every rank.
The fit takes the group back when it returns or unwinds, after its last
drain, so a later read issues no collective.
"""
from __future__ import annotations

import math

import numpy

import torch

from . import instrument

__all__ = ['EvalMetric', 'CompositeEvalMetric', 'Accuracy', 'TopKAccuracy',
           'F1', 'Perplexity', 'MAE', 'MSE', 'RMSE', 'CrossEntropy', 'Torch',
           'Caffe', 'CustomMetric', 'np', 'create', 'check_label_shapes',
           'set_dp_group']


def set_dp_group(metric, group, dp):
    """Let ``metric`` (and a composite's children) sum its device
    accumulators over ``group``, a mesh's dp process group of ``dp``
    ranks, at every drain (``group`` None: its own rows only, with no
    collective).  ``BaseModule.fit`` sets it for the fit's duration."""
    metric._dp_sum = (group, int(dp)) if group is not None else None
    for child in getattr(metric, 'metrics', ()):
        set_dp_group(child, group, dp)


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
        # instances of health-skipped steps the host count overstates
        # (a float64 device scalar, made by a skip_update fused step)
        held = getattr(self, '_dev_held', None)
        if held is not None:
            held.zero_()
        self._dev_held = held

    # -- on-device accumulation --------------------------------------------
    def device_capable(self):
        """Whether a device form exists and the single-accumulator form
        is in use."""
        return callable(self.device_update) and self.num is None

    def device_fold_key(self):
        """Hashable identity of the folded computation: two metrics of
        equal keys fold the same device form (``mxnet_tpu/metric.py:94``);
        subclasses whose form depends on parameters add them."""
        return (type(self).__module__, type(self).__qualname__)

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

    def _take_accumulators(self, other):
        """Take over ``other``'s (drained) device accumulators: a fused
        step and its graphs keep adding into the same tensors."""
        self._drain_device()
        self._dev_sum, other._dev_sum = other._dev_sum, None
        self._dev_held = getattr(other, '_dev_held', None)
        other._dev_held = None

    def _held(self, device):
        """The held-back instance count on ``device``, made (zero) if
        absent: a skip_update step captures its address."""
        device = torch.device(device)
        if getattr(self, '_dev_held', None) is not None and \
                self._dev_held.device != device:
            self._drain_device()
            self._dev_held = None
        if getattr(self, '_dev_held', None) is None:
            self._dev_held = torch.zeros((), dtype=torch.float64,
                                         device=device)
        return self._dev_held

    def _hold_back(self, bad, count):
        """A health-skipped step (``bad``, a 0-dim bool tensor) does not
        count: its ``count`` instances, which the host adds per step, are
        held back on the device and subtracted at the drain."""
        if count:
            self._held(bad.device).add_(bad.double() * count)

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
        drain however many accumulators are pending.  The active health
        monitor's state rides the SAME transfer
        (``health._piggyback_take``), so a fit with sentinels on pays no
        extra sync: ``health.host_syncs`` counts only a drain health
        forced on its own (no metric state pending)."""
        from . import health as _health
        pending = self._take_device_state()
        extra = _health._piggyback_take()
        if not pending and not extra:
            return
        from . import iowatch as _iowatch
        from . import perfwatch as _perfwatch
        held = [m._dev_held for m, _, _ in pending
                if getattr(m, '_dev_held', None) is not None]
        parts = [s for _, s, _ in pending] + held + list(extra)
        dp_sum = getattr(self, '_dp_sum', None) if pending else None
        # the goodput ledger charges the transfer to metric_drain: one
        # ledger event per counted host sync
        with _perfwatch.phase('metric_drain'), \
                _iowatch.account('metric_drain'):
            flat = torch.cat([t.double().reshape(-1) for t in parts])
            if dp_sum is not None:
                # the metric's part summed over the mesh's dp ranks (the
                # health state rides along unsummed)
                from .parallel import collectives
                k = sum(s.numel() for _, s, _ in pending) + len(held)
                flat = torch.cat([collectives.psum(flat[:k], dp_sum[0]),
                                  flat[k:]])
            flat = flat.cpu().tolist()
        if pending:
            instrument.inc('metric.host_syncs')
        else:
            instrument.inc('health.host_syncs')
        i = sum(s.numel() for _, s, _ in pending)
        held_values = dict(zip(map(id, held), flat[i:i + len(held)]))
        health_values = flat[i + len(held):]
        i = 0
        for metric, acc, n in pending:
            if dp_sum is not None:
                n *= dp_sum[1]
            if getattr(metric, '_dev_held', None) is not None:
                n -= int(round(held_values[id(metric._dev_held)]))
                metric._dev_held.zero_()
            metric._apply_drained(flat[i:i + acc.numel()], n)
            i += acc.numel()
            acc.zero_()
        # everything recorded before the transfer has completed
        _perfwatch.harvest()
        # applied last: the divergence action may raise, and the metric
        # sums above must land first
        _health._piggyback_apply(extra, health_values)

    def _apply_drained(self, values, n):
        """Fold one drained accumulator (its values, as floats) and the
        host count into the host sums."""
        self.sum_metric += values[0]
        self.num_inst += n

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

    def device_fold_key(self):
        return ('composite',) + tuple(m.device_fold_key()
                                      for m in self.metrics)

    def _accumulators(self, device):
        return [a for m in self.metrics for a in m._accumulators(device)]

    def _take_accumulators(self, other):
        for metric, theirs in zip(self.metrics, other.metrics):
            metric._take_accumulators(theirs)

    def _held(self, device):
        return [m._held(device) for m in self.metrics]

    def _hold_back(self, bad, count):
        for metric, k in zip(self.metrics, count):
            metric._hold_back(bad, k)

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

    def device_fold_key(self):
        return super().device_fold_key() + (self.top_k,)


class F1(EvalMetric):
    """Binary-classification F1 of each batch, averaged over batches
    (metric.py:346); host only."""

    def __init__(self):
        super().__init__('f1')

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            scores = _host(pred)
            truth = _host(label).astype('int32')
            check_label_shapes(truth, scores)
            if numpy.unique(truth).size > 2:
                raise ValueError('F1 currently only supports binary '
                                 'classification.')
            truth = truth.ravel()
            decided = numpy.argmax(scores, axis=1)
            tp = int(numpy.sum((decided == 1) & (truth == 1)))
            fp = int(numpy.sum((decided == 1) & (truth == 0)))
            fn = int(numpy.sum((decided == 0) & (truth == 1)))
            precision = tp / (tp + fp) if tp + fp else 0.0
            recall = tp / (tp + fn) if tp + fn else 0.0
            self.sum_metric += (2 * precision * recall /
                                (precision + recall)
                                if precision + recall else 0.0)
            self.num_inst += 1


class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of the labels
    (metric.py:380); labels equal to ``ignore_label`` count for nothing.
    Probabilities are floored at 1e-10."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__('Perplexity')
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss, num = 0., 0
        for label, pred in zip(labels, preds):
            assert label.size == pred.size / pred.shape[-1], \
                'shape mismatch: %s vs. %s' % (label.shape, pred.shape)
            label_np = _host(label).reshape(-1).astype('int32')
            pred_np = _host(pred).reshape(-1, pred.shape[-1])
            probs = pred_np[numpy.arange(label_np.shape[0]), label_np]
            if self.ignore_label is not None:
                ignore = label_np == self.ignore_label
                probs = numpy.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += pred_np.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def device_update(self, label, pred):
        # the count of kept labels is data: it rides in the accumulator's
        # second slot (_accumulators), and the host count is 0.  Labels
        # read as jnp.take_along_axis reads them: -1 wraps, one outside
        # [-C, C) gives NaN
        from .ops.tensor import fill_index
        label = label.reshape(-1).to(torch.int64)
        pred2 = pred.reshape(-1, pred.shape[-1]).float()
        index, kept = fill_index(label, pred2.shape[1])
        probs = torch.gather(pred2, 1, index[:, None])[:, 0]
        probs = probs.masked_fill(~kept, float('nan'))
        num = torch.full((), float(pred2.shape[0]), device=pred.device)
        if self.ignore_label is not None:
            ignore = label == int(self.ignore_label)
            probs = torch.where(ignore, torch.ones_like(probs), probs)
            num = num - ignore.sum().float()
        loss = -torch.sum(torch.log(torch.clamp(probs, min=1e-10)))
        return torch.stack([loss, num]), 0

    def _accumulators(self, device):
        device = torch.device(device)
        if self._dev_sum is not None and (self._dev_sum.device != device or
                                          self._dev_sum.shape != (2,)):
            self._drain_device()
            self._dev_sum = None
        if self._dev_sum is None:
            self._dev_sum = torch.zeros(2, dtype=torch.float32,
                                        device=device)
        return [self._dev_sum]

    def _apply_drained(self, values, n):
        self.sum_metric += values[0]
        self.num_inst += int(round(values[1]))

    def device_fold_key(self):
        return super().device_fold_key() + (self.ignore_label, self.axis)

    def get(self):
        self._drain_device()
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


def _align_regression(label, pred):
    """Column-ize 1-D labels and predictions so that a difference never
    broadcasts (N,) against (N, 1) into (N, N)."""
    if len(label.shape) == 1:
        label = label.reshape(label.shape[0], 1)
    if len(pred.shape) == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


class _Regression(EvalMetric):
    """MAE / MSE / RMSE: one value per batch, averaged over batches."""

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _align_regression(_host(label), _host(pred))
            self.sum_metric += self._np(label - pred)
            self.num_inst += 1

    def device_update(self, label, pred):
        label, pred = _align_regression(label, pred)
        return self._value(label.float() - pred.float()).float(), 1


class MAE(_Regression):
    """Mean absolute error (metric.py:466)."""

    def __init__(self):
        super().__init__('mae')

    @staticmethod
    def _np(diff):
        return numpy.abs(diff).mean()

    @staticmethod
    def _value(diff):
        return torch.abs(diff).mean()


class MSE(_Regression):
    """Mean squared error (metric.py:486)."""

    def __init__(self):
        super().__init__('mse')

    @staticmethod
    def _np(diff):
        return (diff ** 2.0).mean()

    @staticmethod
    def _value(diff):
        return (diff ** 2.0).mean()


class RMSE(_Regression):
    """Root mean squared error (metric.py:506)."""

    def __init__(self):
        super().__init__('rmse')

    @staticmethod
    def _np(diff):
        return numpy.sqrt((diff ** 2.0).mean())

    @staticmethod
    def _value(diff):
        return torch.sqrt((diff ** 2.0).mean())


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

    def device_fold_key(self):
        return super().device_fold_key() + (self.eps,)


class Torch(EvalMetric):
    """The mean of the outputs, for loss outputs (metric.py:551)."""

    def __init__(self, name='torch'):
        super().__init__(name)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += _host(pred).mean()
        self.num_inst += 1


class Caffe(Torch):
    def __init__(self):
        super().__init__('caffe')


class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a
    value or ``(sum, count)`` (metric.py:563); host only."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find('<') != -1:
                name = 'custom(%s)' % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_host(label), _host(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy eval function into a :class:`CustomMetric`
    (metric.py:603)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, **kwargs):
    """Create by name, list of names, EvalMetric or callable
    (metric.py:620)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite_metric = CompositeEvalMetric()
        for child_metric in metric:
            composite_metric.add(create(child_metric, **kwargs))
        return composite_metric
    metrics = {'acc': Accuracy, 'accuracy': Accuracy, 'ce': CrossEntropy,
               'f1': F1, 'mae': MAE, 'mse': MSE, 'rmse': RMSE,
               'top_k_accuracy': TopKAccuracy, 'perplexity': Perplexity}
    try:
        return metrics[metric.lower()](**kwargs)
    except Exception:
        raise ValueError('Metric must be either callable or in {}'.format(
            sorted(metrics)))
