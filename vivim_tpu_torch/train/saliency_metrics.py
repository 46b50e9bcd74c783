"""Saliency / binary-segmentation evaluation measures (host numpy).

Copy of the JAX package's ``train/saliency_metrics.py``: independent numpy
implementations of the measures the reference's binary validation uses
(the reference repo's poloy_metrics.py): S-measure [Fan et al. 2017], E-measure
[Fan et al. 2018], MAE, F-measure curves (adaptive and 256-threshold),
weighted F-measure [Margolin et al. 2014] and the 256-threshold "Medical"
Sen/Spe/Dice/IoU curves, with the same ``step`` / ``get_results`` API and
result keys (train_binary.py:207-270).  Predictions are continuous saliency
maps (any range, normalized inside), ground truths binary.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-8


def _prepare(pred, gt):
    gt = np.asarray(gt)
    gt = gt > 128 if gt.max() > 1 else gt > 0.5
    pred = np.asarray(pred, np.float64)
    if pred.max() > 1:
        pred = pred / 255.0
    if pred.max() != pred.min():
        pred = (pred - pred.min()) / (pred.max() - pred.min())
    return pred, gt


def _adaptive_threshold(pred):
    return min(2.0 * pred.mean(), 1.0)


def _prf(pred_bin, gt):
    tp = np.count_nonzero(pred_bin & gt)
    p = tp / (np.count_nonzero(pred_bin) + _EPS)
    r = tp / (np.count_nonzero(gt) + _EPS)
    return p, r


class MAE:
    def __init__(self, length=None):
        self.maes = []

    def step(self, pred, gt, idx=None):
        pred, gt = _prepare(pred, gt)
        self.maes.append(float(np.mean(np.abs(pred - gt))))

    def get_results(self):
        return dict(MAE=float(np.mean(self.maes)))


class Fmeasure:
    """Adaptive F and the 256-threshold F curve (beta^2 = 0.3)."""

    def __init__(self, length=None, beta: float = 0.3):
        self.beta = beta  # interpreted as beta^2, as in the reference
        self.adaptive_fms = []
        self.curves = []

    def _fm(self, p, r):
        return (1 + self.beta) * p * r / (self.beta * p + r + _EPS)

    def step(self, pred, gt, idx=None):
        pred, gt = _prepare(pred, gt)
        pb = pred >= _adaptive_threshold(pred)
        p, r = _prf(pb, gt)
        self.adaptive_fms.append(self._fm(p, r))
        # histogram-based threshold sweep
        bins = np.linspace(0, 1, 257)
        fg_hist, _ = np.histogram(pred[gt], bins=bins)
        all_hist, _ = np.histogram(pred, bins=bins)
        # tp(th_i) = # of fg pixels with pred >= bin i
        tp = np.cumsum(fg_hist[::-1])[::-1].astype(np.float64)
        pp = np.cumsum(all_hist[::-1])[::-1].astype(np.float64)
        prec = tp / (pp + _EPS)
        rec = tp / (np.count_nonzero(gt) + _EPS)
        self.curves.append(self._fm(prec, rec))

    def get_results(self):
        adp = float(np.mean(self.adaptive_fms))
        curve = np.mean(np.stack(self.curves), axis=0)
        return dict(adpFm=adp, meanFm=float(curve.mean()),
                    maxFm=float(curve.max()), curve=curve)


class Smeasure:
    """Structure measure: alpha*S_object + (1-alpha)*S_region."""

    def __init__(self, length=None, alpha: float = 0.5):
        self.alpha = alpha
        self.sms = []

    def step(self, pred, gt, idx=None):
        pred, gt = _prepare(pred, gt)
        gt_mean = gt.mean()
        if gt_mean == 0:
            sm = 1.0 - pred.mean()
        elif gt_mean == 1:
            sm = pred.mean()
        else:
            sm = (self.alpha * self._s_object(pred, gt)
                  + (1 - self.alpha) * self._s_region(pred, gt))
            sm = max(0.0, sm)
        self.sms.append(float(sm))

    @staticmethod
    def _object_score(x):
        if x.size == 0:
            return 0.0
        mean, std = x.mean(), x.std()
        return 2.0 * mean / (mean * mean + 1.0 + std + _EPS)

    def _s_object(self, pred, gt):
        fg = self._object_score(pred[gt])
        bg = self._object_score((1.0 - pred)[~gt])
        u = gt.mean()
        return u * fg + (1 - u) * bg

    @staticmethod
    def _centroid(gt):
        h, w = gt.shape
        if gt.sum() == 0:
            return h // 2, w // 2
        ys, xs = np.nonzero(gt)
        return int(round(ys.mean())) + 1, int(round(xs.mean())) + 1

    @staticmethod
    def _ssim(x, y):
        n = x.size
        if n <= 1:
            return 1.0
        mx, my = x.mean(), y.mean()
        sx = ((x - mx) ** 2).sum() / (n - 1)
        sy = ((y - my) ** 2).sum() / (n - 1)
        sxy = ((x - mx) * (y - my)).sum() / (n - 1)
        a = 4 * mx * my * sxy
        b = (mx**2 + my**2) * (sx + sy)
        if a != 0:
            return a / (b + _EPS)
        return 1.0 if b == 0 else 0.0

    def get_results(self):
        return dict(Smeasure=float(np.mean(self.sms)))

    def _s_region(self, pred, gt):
        cy, cx = self._centroid(gt)
        h, w = gt.shape
        area = h * w
        score = 0.0
        for (ys, xs) in (((0, cy), (0, cx)), ((0, cy), (cx, w)),
                         ((cy, h), (0, cx)), ((cy, h), (cx, w))):
            g = gt[ys[0]:ys[1], xs[0]:xs[1]].astype(np.float64)
            p = pred[ys[0]:ys[1], xs[0]:xs[1]]
            weight = g.size / area
            score += weight * self._ssim(p, g)
        return score


class Emeasure:
    """Enhanced-alignment measure: adaptive + 256-threshold curve."""

    def __init__(self, length=None):
        self.adaptive_ems = []
        self.changeable_ems = []

    @staticmethod
    def _em_binary(pred_bin, gt):
        N = gt.size
        gt_numel = np.count_nonzero(gt)
        if gt_numel == 0:
            enhanced = 1.0 - pred_bin.astype(np.float64)
            return enhanced.sum() / (N - 1 + _EPS)
        if gt_numel == N:
            enhanced = pred_bin.astype(np.float64)
            return enhanced.sum() / (N - 1 + _EPS)
        fg_fg = np.count_nonzero(pred_bin & gt)
        fg_bg = np.count_nonzero(pred_bin & ~gt)
        pred_numel = fg_fg + fg_bg
        mu_p = pred_numel / N
        mu_g = gt_numel / N
        parts = [
            (fg_fg, 1 - mu_p, 1 - mu_g),
            (fg_bg, 1 - mu_p, -mu_g),
            (gt_numel - fg_fg, -mu_p, 1 - mu_g),
            (N - pred_numel - (gt_numel - fg_fg), -mu_p, -mu_g),
        ]
        total = 0.0
        for numel, dp, dg in parts:
            align = 2 * dp * dg / (dp * dp + dg * dg + _EPS)
            total += numel * ((align + 1) ** 2 / 4.0)
        return total / (N - 1 + _EPS)

    def step(self, pred, gt, idx=None):
        pred, gt = _prepare(pred, gt)
        self.adaptive_ems.append(
            self._em_binary(pred >= _adaptive_threshold(pred), gt))
        ths = np.linspace(0, 1, 256)
        curve = np.array([self._em_binary(pred >= t, gt) for t in ths])
        self.changeable_ems.append(curve)

    def get_results(self):
        adp = float(np.mean(self.adaptive_ems))
        curve = np.mean(np.stack(self.changeable_ems), axis=0)
        return dict(adpEm=adp, meanEm=float(curve.mean()),
                    maxEm=float(curve.max()), curve=curve)


class WeightedFmeasure:
    """Weighted F-measure (Margolin et al., "How to Evaluate Foreground
    Maps?", CVPR 2014)."""

    def __init__(self, length=None, beta: float = 1.0):
        self.beta = beta
        self.wfms = []

    def step(self, pred, gt, idx=None):
        from scipy.ndimage import distance_transform_edt, gaussian_filter

        pred, gt = _prepare(pred, gt)
        if gt.sum() == 0:
            self.wfms.append(0.0)
            return
        E = np.abs(pred - gt.astype(np.float64))
        dst, idxs = distance_transform_edt(~gt, return_indices=True)
        Et = E.copy()
        Et[~gt] = E[idxs[0][~gt], idxs[1][~gt]]
        EA = gaussian_filter(Et, sigma=5, truncate=0.6, mode="constant")
        MIN_E_EA = np.where(gt & (EA < E), EA, E)
        B = np.where(gt, 1.0, 2.0 - np.exp(np.log(0.5) / 5 * dst))
        Ew = MIN_E_EA * B
        TPw = gt.sum() - Ew[gt].sum()
        FPw = Ew[~gt].sum()
        R = 1 - Ew[gt].mean()
        P = TPw / (TPw + FPw + _EPS)
        b2 = self.beta**2
        self.wfms.append(float((1 + b2) * R * P / (R + b2 * P + _EPS)))

    def get_results(self):
        return dict(wFmeasure=float(np.mean(self.wfms)))


class Medical:
    """256-threshold Sensitivity/Specificity/Dice/IoU curves
    (poloy_metrics.py:405-470)."""

    def __init__(self, length=None):
        self.thresholds = np.linspace(1, 0, 256)
        self.sen, self.spe, self.dic, self.iou = [], [], [], []

    def step(self, pred, gt, idx=None):
        pred, gt = _prepare(pred, gt)
        gt_n = np.count_nonzero(gt)
        bg_n = gt.size - gt_n
        sen = np.zeros(256)
        spe = np.zeros(256)
        dic = np.zeros(256)
        iou = np.zeros(256)
        # histogram sweep (equivalent to per-threshold binarization)
        bins = np.concatenate([self.thresholds[::-1], [np.inf]])
        fg_hist, _ = np.histogram(pred[gt], bins=bins)
        all_hist, _ = np.histogram(pred, bins=bins)
        tp_rev = np.cumsum(fg_hist[::-1])
        pp_rev = np.cumsum(all_hist[::-1])
        for j in range(256):
            tp = tp_rev[j]
            pp = pp_rev[j]
            fp = pp - tp
            fn = gt_n - tp
            tn = bg_n - fp
            sen[j] = tp / (gt_n + _EPS)
            spe[j] = tn / (bg_n + _EPS)
            dic[j] = 2 * tp / (2 * tp + fp + fn + _EPS)
            iou[j] = tp / (tp + fp + fn + _EPS)
        self.sen.append(sen)
        self.spe.append(spe)
        self.dic.append(dic)
        self.iou.append(iou)

    def get_results(self):
        sen = np.mean(np.stack(self.sen), axis=0)
        spe = np.mean(np.stack(self.spe), axis=0)
        dic = np.mean(np.stack(self.dic), axis=0)
        iou = np.mean(np.stack(self.iou), axis=0)
        return dict(meanSen=sen, meanSpe=spe, meanDice=dic, meanIoU=iou,
                    maxDice=float(dic.max()), maxIoU=float(iou.max()))
