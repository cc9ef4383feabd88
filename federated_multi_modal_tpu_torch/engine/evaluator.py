"""Classification evaluator.

Equivalent of Dassl's ``Classification`` evaluator used by the single-site
trainers; prints the exact ``* accuracy: XX.XX%`` line that
``parse_test_res.py`` regex-parses (reference ``parse_test_res.py:127-130``).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from federated_multi_modal_tpu_torch.engine.registry import EVALUATOR_REGISTRY


@EVALUATOR_REGISTRY.register()
class Classification:
    def __init__(self, cfg, lab2cname=None):
        self.cfg = cfg
        self._lab2cname = lab2cname or {}
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0
        self._per_class = defaultdict(lambda: [0, 0])  # label -> [correct, total]
        self._y_true = []
        self._y_pred = []

    def process(self, logits: np.ndarray, labels: np.ndarray):
        preds = np.asarray(logits).argmax(axis=1)
        labels = np.asarray(labels)
        matches = preds == labels
        self._correct += int(matches.sum())
        self._total += len(labels)
        self._y_true.extend(labels.tolist())
        self._y_pred.extend(preds.tolist())
        for lb, m in zip(labels.tolist(), matches.tolist()):
            self._per_class[lb][1] += 1
            self._per_class[lb][0] += int(m)

    def evaluate(self) -> dict:
        acc = 100.0 * self._correct / max(1, self._total)
        err = 100.0 - acc
        macro_f1 = self._macro_f1()
        results = {
            "accuracy": acc,
            "error_rate": err,
            "macro_f1": macro_f1,
            "total": self._total,
            "correct": self._correct,
        }
        print("=> result")
        print(f"* total: {self._total:,}")
        print(f"* correct: {self._correct:,}")
        print(f"* accuracy: {acc:.2f}%")
        print(f"* error: {err:.2f}%")
        print(f"* macro_f1: {macro_f1:.2f}%")
        if self.cfg.TEST.PER_CLASS_RESULT and self._lab2cname:
            print("=> per-class result")
            accs = []
            for lb in sorted(self._per_class):
                c, t = self._per_class[lb]
                a = 100.0 * c / max(1, t)
                accs.append(a)
                cname = self._lab2cname.get(lb, str(lb))
                print(
                    f"* class: {lb} ({cname})\t"
                    f"total: {t:,}\tcorrect: {c:,}\tacc: {a:.2f}%"
                )
            results["perclass_accuracy"] = float(np.mean(accs)) if accs else 0.0
        if self.cfg.TEST.COMPUTE_CMAT and self._y_true:
            # Dassl saves a confusion matrix to OUTPUT_DIR/cmat.pt; same
            # artifact here as a numpy .npy
            import os

            y_true = np.asarray(self._y_true)
            y_pred = np.asarray(self._y_pred)
            # full class vocabulary, not max observed label (Dassl's cmat
            # covers all classes even when a split omits some)
            n = int(max(y_true.max(), y_pred.max())) + 1
            if self._lab2cname:
                n = max(n, max(self._lab2cname) + 1)
            cmat = np.zeros((n, n), np.int64)
            np.add.at(cmat, (y_true, y_pred), 1)
            os.makedirs(self.cfg.OUTPUT_DIR, exist_ok=True)
            path = os.path.join(self.cfg.OUTPUT_DIR, "cmat.npy")
            np.save(path, cmat)
            print(f"Confusion matrix is saved to {path}")
        return results

    def _macro_f1(self) -> float:
        if not self._y_true:
            return 0.0
        y_true = np.asarray(self._y_true)
        y_pred = np.asarray(self._y_pred)
        f1s = []
        for lb in np.unique(y_true):
            tp = int(((y_pred == lb) & (y_true == lb)).sum())
            fp = int(((y_pred == lb) & (y_true != lb)).sum())
            fn = int(((y_pred != lb) & (y_true == lb)).sum())
            denom = 2 * tp + fp + fn
            f1s.append(2 * tp / denom if denom else 0.0)
        return 100.0 * float(np.mean(f1s))


def compute_accuracy(logits, labels, topk=(1,)):
    """Top-k accuracy in percent (Dassl ``compute_accuracy`` analog used at
    ``trainers/coop.py:281``)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    maxk = max(topk)
    order = np.argsort(-logits, axis=1)[:, :maxk]
    res = []
    for k in topk:
        correct = (order[:, :k] == labels[:, None]).any(axis=1)
        res.append(100.0 * float(correct.mean()))
    return res
