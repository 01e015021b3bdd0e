"""Run directory and summary CSV (copy of timm_tpu/utils/summary.py, the
same columns). ``log_wandb`` is not ported (ROADMAP A.5.12)."""
from __future__ import annotations

import csv
import os
from collections import OrderedDict

__all__ = ['get_outdir', 'update_summary']


def get_outdir(path: str, *paths, inc: bool = False) -> str:
    outdir = os.path.join(path, *paths)
    if not os.path.exists(outdir):
        os.makedirs(outdir)
    elif inc:
        count = 1
        outdir_inc = outdir + '-' + str(count)
        while os.path.exists(outdir_inc):
            count = count + 1
            outdir_inc = outdir + '-' + str(count)
            assert count < 100
        outdir = outdir_inc
        os.makedirs(outdir)
    return outdir


def update_summary(
        epoch: int,
        train_metrics: dict,
        eval_metrics: dict,
        filename: str,
        lr=None,
        write_header: bool = False,
        log_wandb: bool = False,
):
    if log_wandb:
        raise NotImplementedError('log_wandb is not ported yet (ROADMAP A.5.12)')
    rowd = OrderedDict(epoch=epoch)
    rowd.update([('train_' + k, v) for k, v in train_metrics.items()])
    if eval_metrics:
        rowd.update([('eval_' + k, v) for k, v in eval_metrics.items()])
    if lr is not None:
        rowd['lr'] = lr
    with open(filename, mode='a') as cf:
        dw = csv.DictWriter(cf, fieldnames=rowd.keys())
        if write_header:
            dw.writeheader()
        dw.writerow(rowd)
