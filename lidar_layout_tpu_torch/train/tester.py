"""Evaluation engines: the pointcept TESTERS registry.

Counterpart of ``lidar_layout_tpu/train/tester.py``: ``TesterBase`` (run
``apply_fn(batch)`` over batches, update meters, summarise), and the six
testers ``SemSegTester`` (per-class IoU: mIoU, mAcc, allAcc),
``ClsTester``, ``ReconTester`` (MAE, MSE and PSNR of range
reconstructions in [-1, 1]), ``DINOSemSegTester`` (softmax accumulated
over a scene's fragments), ``ClsVotingTester`` (softmax summed over a
sample's views, ``test_repeated`` keeps the best of ``num_repeat`` passes)
and ``PartSegTester`` (IoU over a category's parts). The meters are host
numpy, as in JAX; ``apply_fn`` may return torch tensors on any device, and
batches may hold them.

Usage:
    tester = TESTERS["SemSegTester"](apply_fn, num_classes=19)
    summary = tester.test(batches)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Sequence, Type

import numpy as np


def _np(x: Any) -> np.ndarray:
    """A torch tensor (any device) or array-like -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy() if x.is_floating_point() else \
            x.detach().cpu().numpy()
    return np.asarray(x)


TESTERS: Dict[str, Type["TesterBase"]] = {}


def register_tester(cls: Type["TesterBase"]) -> Type["TesterBase"]:
    TESTERS[cls.__name__] = cls
    return cls


class TesterBase:
    """Loop: for each batch run ``apply_fn(batch) -> outputs``, update meters,
    then summarize (engines/test.py:34-113 lifecycle)."""

    def __init__(self, apply_fn: Callable[[Dict[str, Any]], Any],
                 verbose: bool = False):
        self.apply_fn = apply_fn
        self.verbose = verbose

    def update(self, outputs: Any, batch: Dict[str, Any]) -> None:
        raise NotImplementedError

    def summary(self) -> Dict[str, float]:
        raise NotImplementedError

    def test(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        for i, batch in enumerate(batches):
            outputs = self.apply_fn(batch)
            self.update(outputs, batch)
            if self.verbose:
                print(f"[tester] batch {i}: {self.summary()}", flush=True)
        return self.summary()


@register_tester
class SemSegTester(TesterBase):
    """Per-class IoU meters over point logits (engines/test.py:115-353).

    ``apply_fn(batch) -> (N, num_classes) logits`` (or (B, N, C));
    batch carries ``"label"`` int targets and optional ``"mask"`` validity.
    ``ignore_index`` points are excluded (the reference's ignore_index=-1).
    """

    def __init__(self, apply_fn, num_classes: int, ignore_index: int = -1,
                 verbose: bool = False):
        super().__init__(apply_fn, verbose)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.inter = np.zeros(num_classes)
        self.union = np.zeros(num_classes)
        self.target = np.zeros(num_classes)
        self.correct = 0
        self.total = 0

    def update(self, outputs, batch):
        logits = _np(outputs).reshape(-1, self.num_classes)
        label = _np(batch["label"]).reshape(-1)
        valid = label != self.ignore_index
        if "mask" in batch:
            valid &= _np(batch["mask"]).reshape(-1).astype(bool)
        pred = logits.argmax(-1)[valid]
        label = label[valid]
        self.correct += int((pred == label).sum())
        self.total += int(label.size)
        for c in range(self.num_classes):
            p, t = pred == c, label == c
            self.inter[c] += np.logical_and(p, t).sum()
            self.union[c] += np.logical_or(p, t).sum()
            self.target[c] += t.sum()

    def summary(self):
        iou = self.inter / np.maximum(self.union, 1)
        acc = self.inter / np.maximum(self.target, 1)
        present = self.target > 0
        return {
            "mIoU": float(iou[present].mean()) if present.any() else 0.0,
            "mAcc": float(acc[present].mean()) if present.any() else 0.0,
            "allAcc": self.correct / max(self.total, 1),
        }


@register_tester
class ClsTester(TesterBase):
    """Per-class top-1 accuracy for classification heads
    (engines/test.py:600-676). ``apply_fn(batch) -> (B, num_classes)``."""

    def __init__(self, apply_fn, num_classes: int, verbose: bool = False):
        super().__init__(apply_fn, verbose)
        self.num_classes = num_classes
        self.hit = np.zeros(num_classes)
        self.count = np.zeros(num_classes)

    def update(self, outputs, batch):
        pred = _np(outputs).reshape(-1, self.num_classes).argmax(-1)
        label = _np(batch["label"]).reshape(-1)
        for c in range(self.num_classes):
            sel = label == c
            self.hit[c] += int((pred[sel] == c).sum())
            self.count[c] += int(sel.sum())

    def summary(self):
        present = self.count > 0
        per_class = self.hit / np.maximum(self.count, 1)
        return {
            "mAcc": float(per_class[present].mean()) if present.any() else 0.0,
            "allAcc": float(self.hit.sum() / max(self.count.sum(), 1)),
        }


@register_tester
class ReconTester(TesterBase):
    """Range-reconstruction tester (the eval_ae.py path as a TESTERS member):
    mean absolute error + PSNR over model-space range images.
    ``apply_fn(batch) -> (B, H, W, C) reconstruction``; batch has "image"."""

    def __init__(self, apply_fn, verbose: bool = False):
        super().__init__(apply_fn, verbose)
        self.abs_err = 0.0
        self.sq_err = 0.0
        self.n = 0

    def update(self, outputs, batch):
        rec = _np(outputs)
        x = _np(batch["image"])[..., : rec.shape[-1]]
        rec = rec[..., : x.shape[-1]]
        self.abs_err += float(np.abs(rec - x).sum())
        self.sq_err += float(((rec - x) ** 2).sum())
        self.n += x.size

    def summary(self):
        mae = self.abs_err / max(self.n, 1)
        mse = self.sq_err / max(self.n, 1)
        psnr = 10.0 * np.log10(4.0 / max(mse, 1e-12))  # range [-1, 1]
        return {"mae": mae, "mse": mse, "psnr": float(psnr)}


@register_tester
class DINOSemSegTester(SemSegTester):
    """Fragment-accumulating semantic segmentation with DINO-feature side
    inputs (engines/test.py:355-599).

    Each batch is ONE scene: ``{"fragment_list": [frag, ...], "segment": (N,)
    labels, "dino_coord"/"dino_feat" (optional side inputs)}``. Every fragment
    dict carries an ``"index"`` (n_frag,) mapping back into the scene's N
    points; ``apply_fn(fragment)`` returns (n_frag, num_classes) logits whose
    softmax is scatter-added into a scene-level accumulator before the argmax
    (:421-445) — the dino_* side inputs are attached to each fragment exactly
    as the reference re-injects them per fragment (:431-434). Meters are the
    SemSegTester intersection/union family (:474-520).
    """

    DINO_KEYS = ("dino_coord", "dino_feat", "dino_offset")

    def test(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        for i, scene in enumerate(batches):
            segment = _np(scene["segment"]).reshape(-1)
            pred = np.zeros((segment.size, self.num_classes), np.float32)
            side = {k: scene[k] for k in self.DINO_KEYS if k in scene}
            for frag in scene["fragment_list"]:
                logits = _np(self.apply_fn({**frag, **side}))
                logits = logits.reshape(-1, self.num_classes)
                x = logits - logits.max(-1, keepdims=True)
                prob = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
                idx = _np(frag["index"]).reshape(-1)
                if "mask" in frag:
                    keep = _np(frag["mask"]).reshape(-1).astype(bool)
                    idx, prob = idx[keep], prob[keep]
                np.add.at(pred, idx, prob)
            self.update(pred, {"label": segment})
            if self.verbose:
                print(f"[tester] scene {i}: {self.summary()}", flush=True)
        return self.summary()


@register_tester
class ClsVotingTester(TesterBase):
    """Vote-augmented classification (engines/test.py:677-793): each batch is
    one sample's stack of augmented views; predictions are softmax-summed over
    the views before the argmax. ``apply_fn(batch) -> (V, num_classes)``
    logits for the V views in ``batch["voting"]``; batch carries a scalar
    ``"category"`` label. ``test_repeated`` mirrors the reference's
    ``num_repeat`` best-record loop (the views are randomly augmented, so each
    pass differs): call it with a factory yielding a fresh batch iterable.
    """

    def __init__(self, apply_fn, num_classes: int, num_repeat: int = 1,
                 metric: str = "allAcc", verbose: bool = False):
        super().__init__(apply_fn, verbose)
        self.num_classes = num_classes
        self.num_repeat = num_repeat
        self.metric = metric
        self._reset()

    def _reset(self):
        self.inter = np.zeros(self.num_classes)
        self.target = np.zeros(self.num_classes)

    def update(self, outputs, batch):
        logits = _np(outputs).reshape(-1, self.num_classes)
        x = logits - logits.max(-1, keepdims=True)
        prob = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        pred = int(prob.sum(0).argmax())
        cat = int(_np(batch["category"]).reshape(()))
        self.inter[cat] += pred == cat
        self.target[cat] += 1

    def summary(self):
        present = self.target > 0
        acc = self.inter / np.maximum(self.target, 1)
        return {
            "mAcc": float(acc[present].mean()) if present.any() else 0.0,
            "allAcc": float(self.inter.sum() / max(self.target.sum(), 1)),
        }

    def test_repeated(self, batches_factory: Callable[[], Iterable]) -> Dict:
        """num_repeat passes, keep the best record by ``metric``
        (engines/test.py:692-705)."""
        best: Dict[str, float] = {}
        for i in range(self.num_repeat):
            self._reset()
            record = self.test(batches_factory())
            if not best or record[self.metric] > best[self.metric]:
                best = dict(record, best_pass=i)
        return best


@register_tester
class PartSegTester(TesterBase):
    """Part segmentation (engines/test.py:794-888): per sample, softmax-sum
    the view predictions, then score IoU only over the parts belonging to the
    sample's object category (``category2part``); both-empty parts count as
    IoU 1. Summary: ``ins_mIoU`` (instance-averaged) and ``cat_mIoU``
    (category-averaged). ``apply_fn(batch) -> (V, N, num_classes)`` logits;
    batch carries ``"label"`` (N,) part ids and scalar ``"category"``.
    """

    def __init__(self, apply_fn, num_classes: int,
                 category2part: Dict[int, Sequence[int]],
                 verbose: bool = False):
        super().__init__(apply_fn, verbose)
        self.num_classes = num_classes
        self.category2part = {int(k): list(v)
                              for k, v in category2part.items()}
        n_cat = max(self.category2part) + 1
        self.iou_category = np.zeros(n_cat)
        self.iou_count = np.zeros(n_cat)

    def update(self, outputs, batch):
        logits = _np(outputs)
        logits = logits.reshape(-1, logits.shape[-2], self.num_classes)
        x = logits - logits.max(-1, keepdims=True)
        prob = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        pred = prob.sum(0).argmax(-1)                      # (N,)
        label = _np(batch["label"]).reshape(-1)
        cat = int(_np(batch["category"]).reshape(()))
        parts = self.category2part[cat]
        ious = np.zeros(len(parts))
        for j, part in enumerate(parts):
            p, t = pred == part, label == part
            if not t.any() and not p.any():
                ious[j] = 1.0
            else:
                ious[j] = np.logical_and(p, t).sum() / (
                    np.logical_or(p, t).sum() + 1e-10)
        self.iou_category[cat] += ious.mean()
        self.iou_count[cat] += 1

    def summary(self):
        present = self.iou_count > 0
        per_cat = self.iou_category / np.maximum(self.iou_count, 1)
        return {
            "ins_mIoU": float(self.iou_category.sum()
                              / max(self.iou_count.sum(), 1e-10)),
            "cat_mIoU": float(per_cat[present].mean()) if present.any()
            else 0.0,
        }
