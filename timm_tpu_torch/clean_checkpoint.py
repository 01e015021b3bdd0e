#!/usr/bin/env python3
"""Strip a training checkpoint to its release weights:
``python -m timm_tpu_torch.clean_checkpoint`` (counterpart of the root
``clean_checkpoint.py``, with its command line).

It drops the optimizer state and the resume entries, keeps the weights (the
EMA weights with ``--use-ema``) in the port's names and layout, writes them
as .safetensors (the default; needs the safetensors package) or .npz, and
tags the file name with the first 8 hex digits of its SHA-256 unless
``--no-hash``.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys

parser = argparse.ArgumentParser(description='Checkpoint cleaner of the PyTorch / CUDA port')
parser.add_argument('--checkpoint', default='', type=str, metavar='PATH')
parser.add_argument('--output', default='', type=str, metavar='PATH')
parser.add_argument('--use-ema', dest='use_ema', action='store_true')
parser.add_argument('--no-hash', dest='no_hash', action='store_true')


def main(argv=None) -> int:
    from .models import load_state_dict, save_state_dict
    args = parser.parse_args(argv)
    if not args.checkpoint:
        raise SystemExit('--checkpoint required')
    sd = load_state_dict(args.checkpoint, use_ema=args.use_ema)
    print(f"Loaded {len(sd)} weight tensors from '{args.checkpoint}'")

    out = args.output or os.path.splitext(args.checkpoint)[0] + '_clean.safetensors'
    save_state_dict(sd, out)
    if not args.no_hash:
        with open(out, 'rb') as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        base, ext = os.path.splitext(out)
        final = f'{base}-{sha[:8]}{ext}'
        os.rename(out, final)
        out = final
    print(f"Wrote cleaned checkpoint to '{out}'")
    return 0


if __name__ == '__main__':
    sys.exit(main())
