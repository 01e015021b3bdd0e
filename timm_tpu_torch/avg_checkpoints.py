#!/usr/bin/env python3
"""Average the weights of N checkpoints into one:
``python -m timm_tpu_torch.avg_checkpoints`` (counterpart of the root
``avg_checkpoints.py``, with its command line).

Inputs are read with ``models.load_state_dict`` (the port's or the JAX
package's .npz, .safetensors, .pth), so the output is in the port's names
and layout. The mean is taken in fp64 and stored as fp32. A .safetensors
output (the default) needs the safetensors package; an .npz output is
written durably with its hash manifest.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np

parser = argparse.ArgumentParser(description='Checkpoint averager of the PyTorch / CUDA port')
parser.add_argument('--input', default='', type=str, metavar='PATH', help='checkpoint dir or glob')
parser.add_argument('--output', default='./averaged.safetensors', type=str, metavar='PATH')
parser.add_argument('--filter', default='checkpoint-*.npz', type=str)
parser.add_argument('-n', type=int, default=10, help='average the last/best n')
parser.add_argument('--use-ema', action='store_true')


def _num_key(path):
    nums = re.findall(r'(\d+)', os.path.basename(path))
    return [int(n) for n in nums] if nums else [0]


def main(argv=None) -> int:
    from .models import load_state_dict, save_state_dict
    args = parser.parse_args(argv)
    pattern = args.input
    if os.path.isdir(pattern):
        pattern = os.path.join(pattern, args.filter)
    files = sorted(glob.glob(pattern), key=_num_key)[-args.n:]
    if not files:
        raise FileNotFoundError(f'No checkpoints found for {pattern}')
    print(f'Averaging {len(files)} checkpoints:')
    for f in files:
        print(f'  {f}')

    avg = None
    for f in files:
        sd = load_state_dict(f, use_ema=args.use_ema)
        if avg is None:
            avg = {k: v.astype(np.float64) for k, v in sd.items()}
        else:
            if set(sd) != set(avg):
                raise ValueError(f'{f}: its keys differ from those of {files[0]}')
            for k, v in sd.items():
                avg[k] += v.astype(np.float64)
    avg = {k: (v / len(files)).astype(np.float32) for k, v in avg.items()}
    save_state_dict(avg, args.output)
    print(f'Wrote averaged checkpoint to {args.output}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
