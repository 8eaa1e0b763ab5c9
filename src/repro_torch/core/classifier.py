"""Map-based classification (paper §3.4), port of ``repro.core.classifier``.

1. After training, each unit j is labelled with the class of its nearest
   training sample (Eq. 7).
2. A query sample is classified by the label of its BMU.

Macro-averaged precision/recall match the paper's Table 2 reporting.
"""
from __future__ import annotations

import torch

from repro_torch.core import search as search_lib
from repro_torch.device import exact_f32_matmul


def label_units(w: torch.Tensor, samples: torch.Tensor, labels: torch.Tensor,
                chunk: int = 4096) -> torch.Tensor:
    """Eq. (7): y_j = label of argmin_i |w_j - s_i|. Returns (N,) int32."""
    n = w.shape[0]
    best_q = torch.full((n,), float("inf"), dtype=torch.float32,
                        device=w.device)
    best_label = torch.zeros(n, dtype=torch.int32, device=w.device)
    w2 = torch.sum(w * w, dim=-1, keepdim=True)
    for lo in range(0, samples.shape[0], chunk):
        s = samples[lo:lo + chunk]
        y = labels[lo:lo + chunk].to(torch.int32)
        s2 = torch.sum(s * s, dim=-1)
        q2 = w2 - 2.0 * exact_f32_matmul(w, s.T) + s2[None, :]   # (N, chunk)
        k = torch.argmin(q2, dim=-1, keepdim=True)
        q = q2.gather(-1, k)[:, 0]
        better = q < best_q
        best_q = torch.where(better, q, best_q)
        best_label = torch.where(better, y[k[:, 0]], best_label)
    return best_label


def label_units_majority(w: torch.Tensor, samples: torch.Tensor,
                         labels: torch.Tensor, num_classes: int | None = None,
                         chunk: int = 4096) -> torch.Tensor:
    """Majority vote of the samples whose BMU is unit j; units that attract
    no samples fall back to the Eq. (7) nearest-sample label."""
    labels = labels.long()
    if num_classes is None:
        num_classes = int(labels.max()) + 1
    votes = torch.zeros((w.shape[0], num_classes), dtype=torch.float32,
                        device=w.device)
    for lo in range(0, samples.shape[0], chunk):
        bmu, _ = search_lib.exact_bmu(w, samples[lo:lo + chunk])
        votes.index_put_((bmu.long(), labels[lo:lo + chunk]),
                         torch.ones(bmu.shape[0], device=w.device),
                         accumulate=True)
    majority = torch.argmax(votes, dim=-1).to(torch.int32)
    hit = votes.sum(dim=-1) > 0
    return torch.where(hit, majority, label_units(w, samples, labels, chunk))


def predict(w: torch.Tensor, unit_labels: torch.Tensor, queries: torch.Tensor,
            chunk: int = 4096) -> torch.Tensor:
    """Label of each query's BMU. Returns (B,) int32."""
    outs = []
    for lo in range(0, queries.shape[0], chunk):
        bmu, _ = search_lib.exact_bmu(w, queries[lo:lo + chunk])
        outs.append(unit_labels[bmu.long()])
    return torch.cat(outs)


def precision_recall(pred: torch.Tensor, true: torch.Tensor,
                     num_classes: int):
    """Macro-averaged precision and recall (classes absent from both sides
    contribute 0, matching sklearn's zero_division=0)."""
    conf = torch.zeros((num_classes, num_classes), dtype=torch.float32,
                       device=pred.device)
    conf.index_put_((true.long(), pred.long()),
                    torch.ones(pred.shape[0], device=pred.device),
                    accumulate=True)
    tp = torch.diagonal(conf)
    pred_tot = conf.sum(dim=0)
    true_tot = conf.sum(dim=1)
    zero = torch.zeros_like(tp)
    prec = torch.where(pred_tot > 0, tp / torch.clamp(pred_tot, min=1.0), zero)
    rec = torch.where(true_tot > 0, tp / torch.clamp(true_tot, min=1.0), zero)
    present = true_tot > 0
    denom = torch.clamp(present.sum(), min=1)
    return (torch.sum(torch.where(present, prec, zero)) / denom,
            torch.sum(torch.where(present, rec, zero)) / denom)
