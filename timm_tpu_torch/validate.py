#!/usr/bin/env python3
"""Checkpoint evaluation of the port: ``python -m timm_tpu_torch.validate``.

Counterpart of the root ``validate.py``, with its command line. It
evaluates a model, from ``--checkpoint`` (the port's or the JAX package's
.npz, .safetensors or .pth; ``--use-ema`` picks the EMA weights), on a
folder dataset and reports top-1, top-5 and loss, as CSV or JSON with
``--results-file``, for one model or a ``--model-list``. Every batch,
the last one padded, runs at one bucket shape (``serve.batch_bucket`` /
``pad_rows``); padded rows are masked out of the means. It runs on
``cuda`` unless ``--device cpu`` is given, and raises with no card. On the
card a ViT's attention is the flash-attention kernel, and TF32 is off
(``_device.use_full_fp32``): fp32 convolutions and matmuls compute in fp32.

``--test-pool`` wraps the model in ``TestTimePoolHead`` when the eval size
exceeds the model's default in both dims, and then evaluates full images
(``crop_pct`` 1.0), as the JAX script does; the results row says whether it
did (``test_time_pool``). A checkpoint of a ``--split-bn`` run loads into
the plain model: its aux statistics are left out (eval uses the primary
ones only; the JAX script refuses such a checkpoint).

``--quantize``, ``--real-labels``, ``--fsdp``, ``--tp``, ``--block-scan``
and ``--pretrained`` raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import sys
import time
from collections import OrderedDict

import torch

_logger = logging.getLogger('validate')

parser = argparse.ArgumentParser(description='Validation of the PyTorch / CUDA port')
parser.add_argument('data', nargs='?', metavar='DIR', const=None, help='path to dataset (positional)')
parser.add_argument('--data-dir', metavar='DIR', help='path to dataset root')
parser.add_argument('--dataset', metavar='NAME', default='')
parser.add_argument('--split', metavar='NAME', default='validation')
parser.add_argument('--model', '-m', metavar='NAME', default='vit_tiny_patch16_224')
parser.add_argument('--pretrained', dest='pretrained', action='store_true')
parser.add_argument('--checkpoint', default='', type=str, metavar='PATH')
parser.add_argument('--use-ema', dest='use_ema', action='store_true')
parser.add_argument('-b', '--batch-size', default=256, type=int, metavar='N')
parser.add_argument('--img-size', default=None, type=int, metavar='N')
parser.add_argument('--device', default=None, type=str,
                    help="device to run on: 'cuda' (the default) or 'cpu'")
parser.add_argument('--input-size', default=None, nargs=3, type=int, metavar='N N N')
parser.add_argument('--crop-pct', default=None, type=float, metavar='N')
parser.add_argument('--crop-mode', default=None, type=str, metavar='N')
parser.add_argument('--mean', type=float, nargs='+', default=None, metavar='MEAN')
parser.add_argument('--std', type=float, nargs='+', default=None, metavar='STD')
parser.add_argument('--interpolation', default='', type=str, metavar='NAME')
parser.add_argument('--num-classes', type=int, default=None)
parser.add_argument('--class-map', default='', type=str, metavar='FILENAME')
parser.add_argument('-j', '--workers', default=4, type=int, metavar='N')
parser.add_argument('--log-freq', default=20, type=int, metavar='N')
parser.add_argument('--amp', action='store_true', default=False, help='bf16 compute')
parser.add_argument('--test-pool', dest='test_pool', action='store_true',
                    help='enable test time pool')
parser.add_argument('--real-labels', default='', type=str, metavar='FILENAME',
                    help='not ported (ROADMAP A.5.1)')
parser.add_argument('--results-file', default='', type=str, metavar='FILENAME')
parser.add_argument('--results-format', default='csv', type=str)
parser.add_argument('--model-list', default='', type=str, metavar='FILENAME or WILDCARD',
                    help='evaluate a list/wildcard of models in sequence')
parser.add_argument('--retry', default=False, action='store_true',
                    help='halve batch size and retry when the card runs out of memory')
parser.add_argument('--block-scan', action='store_true', default=False,
                    help='not ported (ROADMAP A.5.7)')
parser.add_argument('--device-prefetch', type=int, default=0, metavar='N',
                    help='keep N batches in flight on the device while the step runs; 0 disables')
parser.add_argument('--quantize', default='', type=str, choices=['', 'int8'],
                    help='not ported (ROADMAP A.5.10)')
parser.add_argument('--quant-top1-delta', default=0.5, type=float, metavar='PCT',
                    help='with --quantize (not ported)')
parser.add_argument('--fsdp', type=int, default=0, metavar='N', help='not ported (ROADMAP A.5.11)')
parser.add_argument('--tp', type=int, default=0, metavar='N', help='not ported (ROADMAP A.5.11)')

_UNPORTED = (
    ('pretrained', 'A.5.1: no hub; pass --checkpoint'), ('quantize', 'A.5.10'),
    ('real_labels', 'A.5.1'), ('fsdp', 'A.5.11'), ('tp', 'A.5.11'),
    ('block_scan', 'A.5.7'),
)


def check_unported(args, unported=_UNPORTED, defaults=parser) -> None:
    for dest, item in unported:
        if getattr(args, dest) != defaults.get_default(dest):
            raise NotImplementedError(
                f'--{dest.replace("_", "-")} is not ported yet (ROADMAP {item})')


def build_model(args, device):
    """The model of ``args`` on ``device`` (bf16 compute with ``--amp``),
    with ``--checkpoint`` loaded, in eval mode."""
    from .models import create_model, load_checkpoint
    dtype = torch.bfloat16 if args.amp else None
    kwargs = dict(num_classes=args.num_classes, dtype=dtype, device=device)
    try:
        model = create_model(args.model, img_size=args.img_size, **kwargs)
    except TypeError as e:
        if 'img_size' not in str(e):
            raise
        model = create_model(args.model, **kwargs)
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint, use_ema=args.use_ema)
    return model.eval()


def eval_loader(args, data_config, device):
    """(dataset, loader) of the folder dataset at ``args``' data path."""
    from .data import create_loader
    from .data.dataset_factory import create_dataset
    root = args.data_dir or args.data
    dataset = create_dataset(args.dataset, root=root, split=args.split, class_map=args.class_map)
    loader = create_loader(
        dataset,
        input_size=data_config['input_size'],
        batch_size=args.batch_size,
        interpolation=data_config['interpolation'],
        mean=data_config['mean'],
        std=data_config['std'],
        num_workers=args.workers,
        crop_pct=data_config['crop_pct'],
        crop_mode=data_config['crop_mode'],
        device_prefetch=args.device_prefetch,
        device=device,
    )
    return dataset, loader


def validate(args, predictions=None):
    """Evaluate ``args``; returns the results row. ``predictions``, a list,
    receives each image's top-5 class indices (best first) in dataset
    order."""
    from ._device import resolve_device, use_full_fp32
    from .data import resolve_data_config
    from .serve import batch_bucket, pad_rows
    from .task import Normalize
    from .utils import AverageMeter, eval_metrics
    from .utils.cuda_graph import StepGraphs

    check_unported(args)
    device = resolve_device(args.device)
    use_full_fp32(device)
    model = build_model(args, device)
    data_config = resolve_data_config(vars(args), model=model)
    param_count = sum(p.numel() for p in model.parameters())
    _logger.info(f'Model {args.model} created, param count: {param_count / 1e6:.1f}M')
    test_time_pool = False
    if args.test_pool:
        from .layers import apply_test_time_pool
        model, test_time_pool = apply_test_time_pool(model, data_config)
        if test_time_pool:
            data_config['crop_pct'] = 1.0  # full-image input for the pooled head
        else:
            _logger.info('--test-pool requested but the eval size does not exceed the '
                         'pretrained default; using the standard head')
    _, loader = eval_loader(args, data_config, device)
    normalize = Normalize(data_config['mean'], data_config['std'], device)

    # the jitted eval step's counterpart: one CUDA graph per input shape
    # (eager on the CPU)
    eval_graphs = StepGraphs(
        lambda b: eval_metrics(model(normalize(b['x'])), b['target'], b['valid']), device)

    @torch.no_grad()
    def eval_step(x, target, valid):
        return eval_graphs({'x': x, 'target': target, 'valid': valid})

    # one bucket shape for the whole eval: the last, partial batch pads up
    # to the shape of every other
    bucket = batch_bucket(args.batch_size)
    loss_m, top1_m, top5_m, time_m = AverageMeter(), AverageMeter(), AverageMeter(), AverageMeter()
    end = t0 = time.time()
    for batch_idx, (x, t) in enumerate(loader):
        n = int(x.shape[0])
        x, t, valid = pad_rows(x, bucket, t)
        loss, acc1, acc5, top = eval_step(x, t, valid)  # staged into the graph's inputs
        if predictions is not None:
            predictions.extend(top[:n].flip(-1).cpu().tolist())
        loss_m.update(float(loss), n)
        top1_m.update(float(acc1), n)
        top5_m.update(float(acc5), n)
        time_m.update(time.time() - end)
        end = time.time()
        if batch_idx % args.log_freq == 0:
            _logger.info(
                f'Test: [{batch_idx:>4d}/{len(loader)}]  '
                f'Time: {time_m.val:.3f}s ({n / max(time_m.avg, 1e-9):>7.1f}/s)  '
                f'Loss: {loss_m.val:>7.4f} ({loss_m.avg:>6.4f})  '
                f'Acc@1: {top1_m.val:>7.3f} ({top1_m.avg:>7.3f})  '
                f'Acc@5: {top5_m.val:>7.3f} ({top5_m.avg:>7.3f})')

    results = OrderedDict(
        model=args.model,
        top1=round(top1_m.avg, 4), top1_err=round(100 - top1_m.avg, 4),
        top5=round(top5_m.avg, 4), top5_err=round(100 - top5_m.avg, 4),
        param_count=round(param_count / 1e6, 2),
        img_size=data_config['input_size'][-1],
        crop_pct=data_config['crop_pct'],
        interpolation=data_config['interpolation'],
        test_time_pool=test_time_pool,
    )
    # the unrounded loss, for callers that compare runs, and the rate of the
    # eval loop (data loading included)
    results['loss'] = loss_m.avg
    results['img_per_s'] = loss_m.count / max(time.time() - t0, 1e-9)
    _logger.info(' * Acc@1 {:.3f} ({:.3f}) Acc@5 {:.3f} ({:.3f})'.format(
        results['top1'], results['top1_err'], results['top5'], results['top5_err']))
    return results


def _validate_with_retry(args):
    """Halve the batch size and retry when the card runs out of memory
    (``--retry``)."""
    batch_size = args.batch_size
    while True:
        args.batch_size = batch_size
        try:
            return validate(args)
        except torch.cuda.OutOfMemoryError:
            if not args.retry or batch_size <= 1:
                raise
            torch.cuda.empty_cache()
            batch_size = max(1, batch_size // 2)
            _logger.warning(f'Out of memory, retrying with batch size {batch_size}')


def main(argv=None) -> int:
    import os

    from .models import list_models
    from .utils import setup_default_logging
    if not logging.root.handlers:
        setup_default_logging()
    args = parser.parse_args(argv)

    model_names = []
    if args.model_list:
        if os.path.exists(args.model_list):
            with open(args.model_list) as f:
                model_names = [line.strip() for line in f if line.strip()]
        else:
            model_names = list_models(args.model_list)

    if model_names:
        results = []
        orig_batch = args.batch_size
        for name in model_names:
            args.model = name
            args.batch_size = orig_batch
            try:
                results.append(_validate_with_retry(args))
            except NotImplementedError:
                raise
            except Exception as e:
                _logger.error(f'{name} failed: {e}')
        results = sorted(results, key=lambda x: x['top1'], reverse=True)
    else:
        results = [_validate_with_retry(args)]

    if args.results_file:
        if args.results_format == 'json':
            with open(args.results_file, 'w') as f:
                json.dump(results, f, indent=2)
        else:
            with open(args.results_file, 'w') as f:
                dw = csv.DictWriter(f, fieldnames=results[0].keys())
                dw.writeheader()
                for r in results:
                    dw.writerow(r)
    print(f'--result\n{json.dumps(results if len(results) > 1 else results[0], indent=4)}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
