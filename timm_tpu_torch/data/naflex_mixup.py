"""Mixup/CutMix for variable-size (NaFlex) batches (counterpart of
timm_tpu/data/naflex_mixup.py, plain Python and numpy on the host).

Operates on the list of post-resize HWC numpy arrays BEFORE patchification:
samples are sorted by aspect ratio and paired with their nearest neighbor,
then only the mutual central overlap region of each pair is mixed (Mixup) or
cut-pasted (CutMix). Per-sample effective lambdas account for the overlap
fraction, so the target mixing matches exactly what happened to the pixels.
"""
from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np

__all__ = ['mix_batch_variable_size']


def mix_batch_variable_size(
        imgs: List[np.ndarray],
        mixup_alpha: float = 0.8,
        cutmix_alpha: float = 1.0,
        switch_prob: float = 0.5,
        local_shuffle: int = 4,
        rng: random.Random = None,
) -> Tuple[List[np.ndarray], List[float], Dict[int, int]]:
    """Mix a batch of HWC float arrays pairwise.

    Returns (mixed_imgs, lam_list, pair_to); lam_list[i] is the weight of
    sample i's OWN content in its mixed image, pair_to[i] the partner index
    (absent for an odd unpaired sample).
    """
    if len(imgs) < 2:
        return imgs, [1.0] * len(imgs), {}
    rng = rng or random
    if mixup_alpha > 0.0 and cutmix_alpha > 0.0:
        use_cutmix = rng.random() < switch_prob
        alpha = cutmix_alpha if use_cutmix else mixup_alpha
    elif mixup_alpha > 0.0:
        use_cutmix, alpha = False, mixup_alpha
    elif cutmix_alpha > 0.0:
        use_cutmix, alpha = True, cutmix_alpha
    else:
        raise ValueError('both mixup_alpha and cutmix_alpha are zero')
    # drawn from the caller's seeded rng so epochs replay deterministically
    lam_raw = float(min(max(rng.betavariate(alpha, alpha), 0.0), 1.0))

    order = sorted(range(len(imgs)), key=lambda i: imgs[i].shape[1] / imgs[i].shape[0])
    if local_shuffle > 1:
        for start in range(0, len(order), local_shuffle):
            sub = order[start:start + local_shuffle]
            rng.shuffle(sub)
            order[start:start + local_shuffle] = sub

    pair_to: Dict[int, int] = {}
    for a, b in zip(order[::2], order[1::2]):
        pair_to[a] = b
        pair_to[b] = a
    odd_one = order[-1] if len(imgs) % 2 else None

    mixed: List[np.ndarray] = [None] * len(imgs)
    lam_list: List[float] = [1.0] * len(imgs)

    # cutmix rectangle chosen once in the overlap frame, shared by both pair
    # members (reference draws per pair; mirrored here via the pair loop)
    done = set()
    for i in range(len(imgs)):
        if i == odd_one or i in done:
            if i == odd_one:
                mixed[i] = imgs[i]
            continue
        j = pair_to[i]
        xi, xj = imgs[i], imgs[j]
        hi, wi = xi.shape[:2]
        hj, wj = xj.shape[:2]
        oh, ow = min(hi, hj), min(wi, wj)
        ti, li = (hi - oh) // 2, (wi - ow) // 2
        tj, lj = (hj - oh) // 2, (wj - ow) // 2

        if use_cutmix:
            cut_ratio = np.sqrt(1.0 - lam_raw)
            ch, cw = int(oh * cut_ratio), int(ow * cut_ratio)
            if ch and cw:
                cy = rng.randint(0, oh - ch)
                cx = rng.randint(0, ow - cw)
            else:
                cy = cx = 0
            for a, xa, xb, (ta, la), (tb, lb), ha, wa in (
                    (i, xi, xj, (ti, li), (tj, lj), hi, wi),
                    (j, xj, xi, (tj, lj), (ti, li), hj, wj)):
                out = xa.copy()
                if ch and cw:
                    out[ta + cy:ta + cy + ch, la + cx:la + cx + cw] = \
                        xb[tb + cy:tb + cy + ch, lb + cx:lb + cx + cw]
                mixed[a] = out
                lam_list[a] = 1.0 - (ch * cw) / float(ha * wa)
        else:
            for a, xa, xb, (ta, la), (tb, lb), ha, wa in (
                    (i, xi, xj, (ti, li), (tj, lj), hi, wi),
                    (j, xj, xi, (tj, lj), (ti, li), hj, wj)):
                out = xa.copy()
                patch_a = xa[ta:ta + oh, la:la + ow]
                patch_b = xb[tb:tb + oh, lb:lb + ow]
                out[ta:ta + oh, la:la + ow] = lam_raw * patch_a + (1.0 - lam_raw) * patch_b
                mixed[a] = out
                # effective own-content weight: mixed overlap + untouched border
                overlap_frac = (oh * ow) / float(ha * wa)
                lam_list[a] = 1.0 - overlap_frac * (1.0 - lam_raw)
        done.add(i)
        done.add(j)
    return mixed, lam_list, pair_to
