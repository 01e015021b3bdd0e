#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (timm_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, checks
ViT-B/16 in bf16 on the card against the same weights in fp32 on the CPU,
and serves ViT-B/16 through the port's InferenceEngine. Each phase prints
one JSON line; then come the kernel summary line, the card's name and power
limit as nvidia-smi gives them, and the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; with no CUDA device, or outside the repository, it exits
non-zero at once. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PARITY_TOL = 2e-2          # max abs, kernel vs plain (the TPU registry's parity_tol)
MODEL_REL_L2_TOL = 2e-2    # bf16 on the card vs fp32 on the CPU
SERVE_REL_L2_TOL = 2e-2    # a served row vs the direct bf16 forward of its image
SERVE_BUCKETS = (1, 4, 16, 64)
SERVE_BURSTS = (1, 3, 10, 64, 64, 40, 2, 16)  # 200 requests; every bucket dispatches


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f'nvidia-smi failed: {proc.stderr.strip()}')
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---- phases -----------------------------------------------------------------

def phase_device():
    import torch
    smi = nvidia_smi_line()
    info = {'phase': 'device', 'name': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(), 'nvidia_smi': smi,
            'torch': torch.__version__, 'cuda': torch.version.cuda}
    emit(info)
    return info


def _ptxas_summary(log: str):
    """Registers and spills per kernel entry from ``nvcc -Xptxas -v``."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = {'entry': m.group(1)}
            out.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            entry['spill_stores'], entry['spill_loads'] = int(m.group(1)), int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            entry['registers'] = int(m.group(1))
    return out


def phase_build():
    import torch
    from timm_tpu_torch.kernels import kernel_smem_bytes
    from timm_tpu_torch.kernels._build import load_library
    built = load_library('flash_attention')
    entries = _ptxas_summary(built.log)
    emit({'phase': 'build', 'kernel': 'flash_attention', 'built': built.built,
          'nvcc_seconds': built.build_seconds, 'library': os.path.relpath(built.path, HERE),
          'entries': len(entries),
          'max_registers': max((e.get('registers', 0) for e in entries), default=None),
          'spill_bytes': sum(e.get('spill_stores', 0) + e.get('spill_loads', 0) for e in entries),
          'smem_bytes_bf16_d64': kernel_smem_bytes(torch.bfloat16, 64),
          'smem_bytes_bf16_d256': kernel_smem_bytes(torch.bfloat16, 256),
          'ptxas': entries})


def _attention_case(name, B, H, N, D, valid, seed):
    """bf16 q, k, v from a seeded generator; ``valid`` = per-row count of
    valid keys (None: unmasked)."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    shape = (B, H, N, D)
    q, k, v = (torch.randn(shape, generator=g, device='cuda').mul_(0.5).to(torch.bfloat16)
               for _ in range(3))
    mask = None
    if valid is not None:
        mask = (torch.arange(N, device='cuda')[None, :] <
                torch.as_tensor(valid, device='cuda')[:, None]).view(B, 1, 1, N)
    keys = [N] * B if valid is None else list(valid)
    # the least work the card could do: read q, k, v (and the mask) once,
    # write o once; 4 * N * keys * D operations per (batch, head)
    nbytes = 4 * B * H * N * D * 2 + (0 if mask is None else B * N)
    flops = sum(4 * H * N * kb * D for kb in keys)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return dict(name=name, q=q, k=k, v=v, mask=mask, shape=[B, H, N, D],
                bound_ms=max(t_bytes, t_ops), bound_by='bytes' if t_bytes >= t_ops else 'operations')


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from timm_tpu_torch.kernels import flash_attention, flash_attention_reference
    cases = [
        _attention_case('vit_b16_bucket64', 64, 12, 197, 64, None, 0),
        _attention_case('vit_b16_pad256', 64, 12, 256, 64, [197] * 64, 1),
        _attention_case('masked_n576', 16, 12, 576, 64,
                        [max(1, int(576 * 0.8) - 8 * i) for i in range(16)], 2),
    ]
    rows = []
    for c in cases:
        q, k, v, mask = c['q'], c['k'], c['v'], c['mask']
        launches_before = flash_attention.launches
        with torch.inference_mode():
            out = flash_attention(q, k, v, mask=mask)
            ref = flash_attention_reference(q, k, v, mask=mask)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f'{c["name"]}: non-finite kernel output')
            err = float((out.float() - ref.float()).abs().max())
            kernel_ms = time_ms(lambda: flash_attention(q, k, v, mask=mask))
            plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, mask=mask), iters=10)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        rows.append({'case': c['name'], 'shape': c['shape'], 'dtype': 'bfloat16',
                     'masked': mask is not None, 'max_abs_err': err, 'tol': PARITY_TOL,
                     'kernel_ms': kernel_ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
                     'bound_ms': c['bound_ms'], 'bound_by': c['bound_by'],
                     # the check, the warm-up and the timed launches of this case
                     'launches': flash_attention.launches - launches_before})
        check(err <= PARITY_TOL, f'{c["name"]}: kernel vs plain max abs err {err} > {PARITY_TOL}')
    emit({'phase': 'kernels', 'kernel': 'flash_attention',
          'replaces': 'timm_tpu/kernels/flash_attention.py:79 (_fwd_kernel)', 'cases': rows})
    return rows


def _images(n: int, size: int = 224, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def phase_model():
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels import flash_attention
    x = _images(8)
    card = timm_tpu_torch.create_model('vit_base_patch16_224', dtype=torch.bfloat16,
                                       seed=0, device='cuda').eval()
    plain = timm_tpu_torch.create_model('vit_base_patch16_224', seed=0, device='cpu').eval()
    with torch.inference_mode():
        xc = torch.from_numpy(x).cuda()
        card(xc)  # first call: kernel and library set-up
        torch.cuda.synchronize()
        flash_attention.launches = 0
        logits_card = card(xc).float().cpu().numpy()
        launches = flash_attention.launches
        t0 = time.perf_counter()
        logits_cpu = plain(torch.from_numpy(x)).numpy()
        cpu_s = time.perf_counter() - t0
    err = rel_l2(logits_card, logits_cpu)
    depth = len(card.blocks)
    emit({'phase': 'model', 'model': 'vit_base_patch16_224', 'batch': 8, 'dtype': 'bfloat16',
          'rel_l2_vs_cpu_fp32': err, 'tol': MODEL_REL_L2_TOL, 'finite': bool(np.isfinite(logits_card).all()),
          'flash_launches_per_forward': launches, 'depth': depth, 'cpu_fp32_seconds': cpu_s})
    check(np.isfinite(logits_card).all(), 'model: non-finite logits on the card')
    check(logits_card.shape == (8, 1000), f'model: logits shape {logits_card.shape}')
    check(err <= MODEL_REL_L2_TOL, f'model: rel L2 {err} > {MODEL_REL_L2_TOL}')
    check(launches == depth, f'model: {launches} flash launches per forward, expected {depth}')


def phase_serve():
    """The port's main path: an InferenceEngine on the card serving ViT-B/16
    in bf16. The launch count is read around this run only."""
    import torch
    from timm_tpu_torch import InferenceEngine
    from timm_tpu_torch.kernels import flash_attention
    n = sum(SERVE_BURSTS)
    images = _images(n, seed=1)
    engine = InferenceEngine(buckets=SERVE_BUCKETS, max_wait_ms=5.0, device='cuda')
    engine.add_model('vit_base_patch16_224', dtype=torch.bfloat16, seed=0)
    flash_attention.launches = 0
    engine.start()
    futures, submitted = [], []
    t0 = time.perf_counter()
    i = 0
    for burst in SERVE_BURSTS:
        batch = []
        for _ in range(burst):
            submitted.append(time.perf_counter())
            batch.append(engine.submit(images[i]))
            i += 1
        for f in batch:
            f.result(timeout=120.0)
        futures.extend(batch)
    wall = time.perf_counter() - t0
    engine.shutdown(drain=True)
    launches = flash_attention.launches
    stats = engine.snapshot_stats()
    served = np.stack([f.result() for f in futures])
    lat_ms = np.array([(f.done_at - s) * 1e3 for f, s in zip(futures, submitted)])

    model = engine.pool.acquire('vit_base_patch16_224').model
    with torch.inference_mode():
        direct = np.concatenate([
            model(torch.from_numpy(images[j:j + 8]).cuda()).float().cpu().numpy()
            for j in range(0, n, 8)])
    errs = [rel_l2(served[j], direct[j]) for j in range(n)]
    depth = len(model.blocks)
    emit({'phase': 'serve', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
          'requests': n, 'completed': stats['completed'], 'failed': stats['failed'],
          'steps': stats['steps'], 'steps_by_bucket': stats['steps_by_bucket'],
          'p50_ms': float(np.percentile(lat_ms, 50)), 'p99_ms': float(np.percentile(lat_ms, 99)),
          'img_per_s': n / wall, 'wall_s': wall, 'flash_launches': launches,
          'max_rel_l2_vs_direct': max(errs), 'tol': SERVE_REL_L2_TOL,
          'prewarm_ms': stats['prewarm']['vit_base_patch16_224']['ms']})
    check(stats['completed'] == n and stats['failed'] == 0, f'serve: {stats["failed"]} failed requests')
    check(set(stats['steps_by_bucket']) == set(SERVE_BUCKETS),
          f'serve: buckets dispatched {stats["steps_by_bucket"]}, expected all of {SERVE_BUCKETS}')
    check(all(np.isfinite(served).ravel()), 'serve: non-finite logits')
    check(max(errs) <= SERVE_REL_L2_TOL, f'serve: max rel L2 {max(errs)} > {SERVE_REL_L2_TOL}')
    check(launches > 0 and launches == depth * stats['steps'],
          f'serve: {launches} flash launches for {stats["steps"]} steps of depth {depth}')
    return launches, model


def phase_breakdown(model):
    """Where the time of the served model goes: the forward time per bucket
    from CUDA events, and the device time of a bucket-64 forward by kernel
    from torch.profiler, with the device's idle share of the host wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    per_bucket = {}
    with torch.inference_mode():
        for b in SERVE_BUCKETS:
            x = torch.from_numpy(_images(b, seed=2)).cuda()
            ms = time_ms(lambda: model(x), iters=10, warmup=2)
            per_bucket[str(b)] = {'forward_ms': ms, 'img_per_s': b / ms * 1e3}
        x = torch.from_numpy(_images(64, seed=3)).cuda()
        model(x)
        torch.cuda.synchronize()
        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3 / reps
    busy = sum(kernels.values())
    flash = sum(v for k, v in kernels.items() if 'flash_fwd_kernel' in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit({'phase': 'breakdown', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
          'per_bucket': per_bucket, 'profiled_batch': 64,
          'wall_ms_per_forward': wall_ms,
          # no device events means the profiler could not trace the card here
          'device_ms_per_forward': busy if kernels else 'not measured',
          'idle_share': 1.0 - busy / wall_ms if kernels else 'not measured',
          'flash_share_of_device': flash / busy if kernels else 'not measured',
          'top_kernels': [{'kernel': k[:120], 'ms': v} for k, v in top]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import timm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port is not beside this script ({e})', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        device = phase_device()
        phase_build()
        rows = phase_kernels()
        phase_model()
        serve_launches, served_model = phase_serve()
        phase_breakdown(served_model)
    except Exception:
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1
    main_row = rows[0]
    emit({'kernels': [{
        'name': 'flash_attention', 'route': 'cuda',
        'source': 'timm_tpu_torch/kernels/csrc/flash_attention.cu',
        'replaces': 'timm_tpu/kernels/flash_attention.py:79',
        'launches': serve_launches,
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': main_row['kernel_ms'], 'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'], 'bound_by': main_row['bound_by'],
        'library_ms': main_row['library_ms'],
    }], 'seconds': time.perf_counter() - t0})
    print(device['nvidia_smi'], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': device['name'],
                                 'count': device['count']}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
