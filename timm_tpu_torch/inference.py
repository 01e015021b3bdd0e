#!/usr/bin/env python3
"""Folder inference of the port: ``python -m timm_tpu_torch.inference``.

Counterpart of the root ``inference.py``, with its command line: top-k
class indices and probabilities of every image of a folder dataset,
written as CSV, JSON or (with pandas and pyarrow installed) parquet. Every
batch, the last one padded, runs at one bucket shape. It runs on ``cuda``
unless ``--device cpu`` is given, and raises with no card; on the card TF32
is off (``_device.use_full_fp32``).

``--label-type`` other than ``index`` (class names from ImageNet metadata)
and ``--pretrained`` raise ``NotImplementedError`` naming their ROADMAP
item. ``--block-scan`` is accepted (the block loop runs as a graph replay
either way); ``--model-kwargs`` passes the model arguments a checkpoint was
trained with, as in ``validate``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from .train import ParseKwargs

_logger = logging.getLogger('inference')

parser = argparse.ArgumentParser(description='Inference of the PyTorch / CUDA port')
parser.add_argument('data', nargs='?', metavar='DIR', const=None)
parser.add_argument('--data-dir', metavar='DIR')
parser.add_argument('--dataset', metavar='NAME', default='')
parser.add_argument('--split', metavar='NAME', default='validation')
parser.add_argument('--model', '-m', metavar='NAME', default='vit_tiny_patch16_224')
parser.add_argument('--pretrained', action='store_true')
parser.add_argument('--checkpoint', default='', type=str, metavar='PATH')
parser.add_argument('--use-ema', action='store_true')
parser.add_argument('-b', '--batch-size', default=256, type=int)
parser.add_argument('--img-size', default=None, type=int)
parser.add_argument('--input-size', default=None, nargs=3, type=int)
parser.add_argument('--crop-pct', default=None, type=float)
parser.add_argument('--crop-mode', default=None, type=str)
parser.add_argument('--num-classes', type=int, default=None)
parser.add_argument('--model-kwargs', nargs='*', default={}, action=ParseKwargs,
                    help='model arguments, key=value (as the train script takes them)')
parser.add_argument('--class-map', default='', type=str)
parser.add_argument('--label-type', default='index', type=str,
                    choices=['index', 'name', 'description', 'detail'],
                    help="only 'index' is ported (ROADMAP A.5.1)")
parser.add_argument('-j', '--workers', default=4, type=int)
parser.add_argument('--amp', action='store_true', default=False)
parser.add_argument('--device', default=None, type=str,
                    help="device to run on: 'cuda' (the default) or 'cpu'")
parser.add_argument('--topk', default=1, type=int, metavar='N')
parser.add_argument('--fullname', action='store_true', default=False)
parser.add_argument('--outputs-name', default=None)
parser.add_argument('--output-dir', default=None)
parser.add_argument('--output-type', default='csv', choices=['csv', 'json', 'parquet'])
parser.add_argument('--filename-col', default='filename')
parser.add_argument('--block-scan', action='store_true', default=False,
                    help="accepted: the model's block loop runs as a CUDA graph replay either way")
parser.add_argument('--device-prefetch', type=int, default=0, metavar='N',
                    help='keep N batches in flight on the device while the step runs; 0 disables')

_UNPORTED = (('pretrained', 'A.5.1: no hub; pass --checkpoint'), ('label_type', 'A.5.1'))


def main(argv=None) -> int:
    from ._device import resolve_device, use_full_fp32
    from .data import resolve_data_config
    from .serve import batch_bucket, pad_rows, strip_rows
    from .task import Normalize
    from .utils import setup_default_logging
    from .utils.cuda_graph import StepGraphs
    from .validate import build_model, check_unported, eval_loader

    if not logging.root.handlers:
        setup_default_logging()
    args = parser.parse_args(argv)
    check_unported(args, _UNPORTED, parser)
    if args.output_type == 'parquet':
        try:
            import pandas  # noqa: F401
            import pyarrow  # noqa: F401
        except ImportError as e:
            raise RuntimeError('--output-type parquet needs pandas and pyarrow, which are not '
                               'installed; use csv or json') from e
    device = resolve_device(args.device)
    use_full_fp32(device)
    model = build_model(args, device)
    data_config = resolve_data_config(vars(args), model=model)
    dataset, loader = eval_loader(args, data_config, device)
    normalize = Normalize(data_config['mean'], data_config['std'], device)
    k = min(args.topk, args.num_classes or model.num_classes)

    def infer_body(b):
        probs = torch.softmax(model(normalize(b['x'])).float(), dim=-1)
        # descending, ties to the higher index, as JAX's reversed argsort
        order = torch.argsort(probs, dim=-1, stable=True).flip(-1)[:, :k]
        return order, torch.gather(probs, 1, order)

    # the jitted step's counterpart: one CUDA graph per input shape (eager
    # on the CPU)
    infer_graphs = StepGraphs(infer_body, device)

    @torch.no_grad()
    def infer_step(x):
        return infer_graphs({'x': x})

    bucket = batch_bucket(args.batch_size)
    all_indices, all_probs = [], []
    t0 = time.time()
    for x, _ in loader:
        n = int(x.shape[0])
        if n != bucket:  # the last, partial batch pads up to the bucket shape
            x, _valid = pad_rows(x, bucket)
        idx, prb = strip_rows(infer_step(x), n)
        all_indices.append(idx.cpu().numpy())
        all_probs.append(prb.cpu().numpy())
    if not all_indices:
        raise RuntimeError(f'No images found for inference under {args.data_dir or args.data!r} '
                           f'(split {args.split!r})')
    num = sum(a.shape[0] for a in all_indices)
    elapsed = time.time() - t0
    _logger.info(f'Inference complete: {num} images in {elapsed:.3f}s')

    indices = np.concatenate(all_indices)
    probs = np.concatenate(all_probs)
    filenames = dataset.filenames(basename=not args.fullname)[:num]
    rows = []
    for fn, ind, prb in zip(filenames, indices, probs):
        row = {args.filename_col: fn}
        if k == 1:
            row['label'] = int(ind[0])
            row['prob'] = float(prb[0])
        else:
            for j in range(k):
                row[f'label_{j}'] = int(ind[j])
                row[f'prob_{j}'] = float(prb[j])
        rows.append(row)

    out_dir = args.output_dir or '.'
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, args.outputs_name or f'{args.model}-results')
    if args.output_type == 'json':
        with open(base + '.json', 'w') as f:
            json.dump(rows, f, indent=2)
    elif args.output_type == 'parquet':
        import pandas as pd
        pd.DataFrame(rows).set_index(args.filename_col).to_parquet(base + '.parquet')
    else:
        import csv
        with open(base + '.csv', 'w') as f:
            dw = csv.DictWriter(f, fieldnames=rows[0].keys())
            dw.writeheader()
            for r in rows:
                dw.writerow(r)
    _logger.info(f'Wrote results to {base}.{args.output_type}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
