"""Legacy classification and volume metrics (JAX ``utils/
classification.py``; reference src/util.py:311-415), numpy in and out.

``classification_metrics`` is the reference's confusion-matrix panel
(src/util.py:348-379); ``roc_auc`` a rank-based AUC (sklearn's
``roc_auc_score``, which neither machine needs); ``compute_stat`` the
reconstruction / segmentation stat dispatch (src/util.py:311-346), whose
reconstruction metrics run through the port's ``metrics.py`` on
``device`` (CUDA unless asked); ``majority_vote_volume_prediction`` the
per-volume vote over interior slices (src/util.py:394-404).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from representation_disentanglement_torch.metrics import (
    compute_reconstruction_metrics)


def classification_metrics(real: np.ndarray, fake: np.ndarray) -> Dict:
    real = np.asarray(real).ravel()
    fake = np.asarray(fake).ravel()
    tp = float(((fake == 1.0) & (real == 1.0)).sum())
    tn = float(((fake == 0.0) & (real == 0.0)).sum())
    fp = float(((fake == 1.0) & (real == 0.0)).sum())
    fn = float(((fake == 0.0) & (real == 1.0)).sum())
    div = lambda a, b: a / b if b else float("nan")
    tpr, tnr = div(tp, tp + fn), div(tn, tn + fp)
    ppv, npv = div(tp, tp + fp), div(tn, tn + fn)
    return {"tpr": tpr, "tnr": tnr, "ppv": ppv, "npv": npv,
            "fnr": 1 - tpr, "fpr": 1 - tnr, "fdr": 1 - ppv,
            "fomr": 1 - npv,
            "acc": div(tp + tn, tp + tn + fp + fn),
            "dice": div(2 * tp, 2 * tp + fp + fn),
            "iou": div(tp, tp + fp + fn)}


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """The Mann-Whitney U of the positive scores over (positives x
    negatives), ties at their average rank; NaN without both classes."""
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores).ravel()
    pos, neg = scores[labels == 1], scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    both = np.concatenate([neg, pos])
    order = np.argsort(both, kind="mergesort")
    _, inv, cnt = np.unique(both[order], return_inverse=True,
                            return_counts=True)
    ranks = np.empty(len(order))
    ranks[order] = (np.cumsum(cnt) - (cnt - 1) / 2.0)[inv]
    u = ranks[len(neg):].sum() - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def compute_stat(real_b: np.ndarray, fake_b: np.ndarray,
                 task: str = "reconstruction", device=None) -> Dict:
    """One slice pair [H, W]: PSNR/SSIM/MSE ('rmse', as the reference
    names it) for 'reconstruction'; else AUC, Dice, TPR, TNR and the
    absolute volume difference of the 0.5-thresholded prediction."""
    if task == "reconstruction":
        m = compute_reconstruction_metrics(real_b[None, ..., None],
                                           fake_b[None, ..., None],
                                           device=device)
        return {"psnr": m["psnr"][0], "ssim": m["ssim"][0],
                "rmse": m["rmse"][0]}
    fake = np.where(np.asarray(fake_b) >= 0.5, 1.0, 0.0).ravel()
    real = np.asarray(real_b).ravel()
    cm = classification_metrics(real, fake)
    return {"auc": roc_auc(real, fake), "dice": cm["dice"],
            "tpr": cm["tpr"], "tnr": cm["tnr"],
            "alvd": float(np.abs(real.sum() - fake.sum()))}


def majority_vote_volume_prediction(prediction_list: np.ndarray,
                                    label_list: np.ndarray,
                                    slice_per_subj: int = 48):
    """Per-volume mean prediction over the interior slices [10, -10) and
    mean label (src/util.py:394-404)."""
    subj_num = int(prediction_list.shape[0] // slice_per_subj)
    preds, labels = [], []
    for s in range(subj_num):
        lo = s * slice_per_subj
        preds.append(float(prediction_list[
            lo + 10:lo + slice_per_subj - 10].mean()))
        labels.append(float(label_list[lo:lo + slice_per_subj].mean()))
    return preds, labels
