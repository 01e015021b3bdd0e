#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (timm_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
nvcc per source, side by side), holds each kernel against its plain PyTorch
version on the card, checks ViT-B/16 in bf16 on the card against the same
weights in fp32 on the CPU, serves ViT-B/16 through the port's
InferenceEngine, trains ViT-B/16 through the port's ClassificationTask
(AdamW through the fused AdamW + EMA kernel) on one fixed batch, with its
gradients checked against the CPU in fp32 and a profiler breakdown of the
train step, and trains it again from a folder of seeded PNGs through the
port's input path (threaded loader, CUDA-stream prefetcher, mixup, cutmix
and erasing sampled on the host, the augment-epilogue kernel). The flash
and augment kernels' times are device times from CUDA-graph replays
(``kernel_ms``) beside the time of eager calls, the wrapper's host time
included (``call_ms``); each kernel's time is set against its bound
(``bound_share``) and against the time of the design it replaced
(``previous_ms``), which is built from ``kernels/csrc/previous/`` and timed
on the same inputs in the same way. Each
phase prints one JSON line; then come the kernel summary line, the card's
name and power limit as nvidia-smi gives them, and the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; with no CUDA device, or outside the repository, it exits
non-zero at once. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
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
PEAK_FP32_FLOPS = 67e12    # outside the tensor cores
PARITY_TOL = 2e-2          # max abs, flash kernel vs plain (the TPU registry's parity_tol)
# fused_adamw kernel vs plain (the TPU registry's parity_tol): max abs on p and
# ema; m and v, far below 1, relative to their largest magnitude
ADAMW_TOL = 1e-6
# augment_epilogue kernel vs plain (the TPU registry's parity_tol): max abs
# for fp32 out; for bf16 out one bf16 ulp of the plain value, and no less
# than AUGMENT_TOL where the blend cancels to near zero (there one fp32 ulp
# of difference before the cast is many bf16 ulps of the result)
AUGMENT_TOL = 1e-6
MODEL_REL_L2_TOL = 2e-2    # bf16 on the card vs fp32 on the CPU
SERVE_REL_L2_TOL = 2e-2    # a served row vs the direct bf16 forward of its image
GRAD_REL_L2_TOL = 5e-2     # one step's bf16 gradients on the card vs fp32 on the CPU
SERVE_BUCKETS = (1, 4, 16, 64)
SERVE_BURSTS = (1, 3, 10, 64, 64, 40, 2, 16)  # 200 requests; every bucket dispatches
KERNELS = ('flash_attention', 'fused_adamw', 'augment_epilogue')
ADAMW_HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP_STEPS, TRAIN_LR = 64, 20, 2, 3e-4
# phase input_train: a folder of seeded PNGs, 3 classes, 256-320 px a side
INPUT_IMAGES_PER_CLASS, INPUT_WORKERS = 192, 6
# kernels whose previous design is kept in kernels/csrc/previous/, built
# beside them and timed on the same inputs (previous_ms)
PREVIOUS_KERNELS = ('flash_attention', 'augment_epilogue')
# flash cases held to an fp64 oracle (scores spread over several units):
# the kernel's own roundings (p and the output rounded to a type with
# 2^-8 relative precision, bf16) allow 2^-8 (softmax-weighted |v| + |o|)
# per element, and SHARP_SLACK covers ex2.approx and fp32 sums
SHARP_PRECISION_BITS = {'bfloat16': 8, 'float16': 11}
SHARP_SLACK = 1e-4


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


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one call: CUDA events around replays of a CUDA graph
    that holds ``per_graph`` calls, so the wrapper's host time (tens of
    microseconds of Python) is left out of a kernel that runs for less."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (per_graph * replays)
    del graph
    return ms


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
    """Registers, stack frame and spills per kernel entry from
    ``nvcc -Xptxas -v``."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = {'entry': m.group(1)}
            out.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r'(\d+) bytes stack frame', line)
        if m:
            entry['stack_frame'] = int(m.group(1))
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            entry['spill_stores'], entry['spill_loads'] = int(m.group(1)), int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            entry['registers'] = int(m.group(1))
    return out


def _declare_previous(name: str, lib):
    """The C signatures of a previous design's library: those of the
    current kernel's entry."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == 'flash_attention':
        fn = lib.timm_flash_attention_fwd
        fn.argtypes = [i, i] + [p] * 5 + [i] * 3 + [i64] * 13 + [ctypes.c_float, p]
    else:
        fn = lib.timm_augment_epilogue
        fn.argtypes = [p, p, i, p, p, i, p, p] + [i] * 5 + [ctypes.POINTER(ctypes.c_float)] * 3 + [i, p]
    fn.restype = i
    return lib


def phase_build():
    """One nvcc per kernel source, the previous designs' included, all
    started together. Returns the previous designs' libraries by name."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from timm_tpu_torch.kernels import kernel_smem_bytes
    from timm_tpu_torch.kernels._build import SOURCE_DIR, load_library
    jobs = ([(name, SOURCE_DIR) for name in KERNELS]
            + [(name, SOURCE_DIR / 'previous') for name in PREVIOUS_KERNELS])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: load_library(*job), jobs))
    wall = time.perf_counter() - t0
    previous = {}
    for (name, source_dir), lib in zip(jobs, built):
        entries = _ptxas_summary(lib.log)
        is_previous = source_dir != SOURCE_DIR
        if is_previous:
            previous[name] = _declare_previous(name, lib.lib)
        row = {'phase': 'build', 'kernel': name + (' (previous)' if is_previous else ''),
               'source': os.path.relpath(source_dir / f'{name}.cu', HERE), 'built': lib.built,
               'nvcc_seconds': lib.build_seconds, 'build_wall_seconds_all': wall,
               'library': os.path.relpath(lib.path, HERE), 'entries': len(entries),
               'max_registers': max((e.get('registers', 0) for e in entries), default=None),
               'spill_bytes': sum(e.get('spill_stores', 0) + e.get('spill_loads', 0)
                                  for e in entries),
               'max_stack_frame': max((e.get('stack_frame', 0) for e in entries), default=None),
               'ptxas': entries}
        if name == 'flash_attention' and not is_previous:
            row['smem_bytes_bf16_d64'] = kernel_smem_bytes(torch.bfloat16, 64)
            row['smem_bytes_bf16_d256'] = kernel_smem_bytes(torch.bfloat16, 256)
            row['smem_bytes_fp32_d64'] = kernel_smem_bytes(torch.float32, 64)
            # registers and spills of each 16-bit instantiation, by dtype and head dim
            per_dim = {}
            for e in entries:
                m = re.search(r'flash_fwd_kernelI(13__nv_bfloat16|6__half)Li(\d+)E', e['entry'])
                if m:
                    key = f"{'bf16' if 'bfloat' in m.group(1) else 'fp16'}_d{m.group(2)}"
                    per_dim[key] = {'registers': e.get('registers'),
                                    'spill_bytes': e.get('spill_stores', 0) + e.get('spill_loads', 0)}
            row['flash_16bit'] = per_dim
            row['flash_16bit_spill_free_d32_d128'] = all(
                v['spill_bytes'] == 0 for k, v in per_dim.items() if not k.endswith('d256'))
        emit(row)
    return previous


def _attention_case(name, B, H, N, D, valid, seed, dtype='bfloat16', qk_scale=0.5, v_scale=0.5):
    """q, k, v of ``dtype`` (bf16 or fp16) from a seeded generator, standard
    normal times ``qk_scale`` (q, k) and ``v_scale`` (v); ``valid`` = per-row
    count of valid keys (None: unmasked). At the default scales the scores
    lie within about one unit and the case is held to the plain version;
    with larger ones, to the fp64 oracle."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    shape = (B, H, N, D)
    q, k, v = (torch.randn(shape, generator=g, device='cuda').mul_(a).to(getattr(torch, dtype))
               for a in (qk_scale, qk_scale, v_scale))
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
    return dict(name=name, q=q, k=k, v=v, mask=mask, shape=[B, H, N, D], dtype=dtype,
                reference='plain' if qk_scale == 0.5 else 'fp64',
                bound_ms=max(t_bytes, t_ops), bound_by='bytes' if t_bytes >= t_ops else 'operations')


def _previous_flash(lib, q, k, v, mask, scale: float):
    """One launch of the previous flash design through its C entry, on
    contiguous (B, H, N, D) q, k, v and an optional (B, 1, 1, N) bool key
    mask, into the current kernel's (B, N, H, D) output storage."""
    import torch
    B, H, N, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    key_mask = None if mask is None else mask.reshape(B, N)
    rc = lib.timm_flash_attention_fwd(
        {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}[q.dtype], D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(), out.data_ptr(), B, H, N,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        0 if key_mask is None else key_mask.stride(0), scale,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f'previous flash kernel launch failed ({rc})')
    return out


def _fp64_oracle(q, k, v, mask):
    """Attention at the kernel's exact rounding point (q * scale rounded to
    q's type), the rest in fp64: the output and the softmax-weighted |v|."""
    import torch
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    s = (q * scale).double() @ k.double().transpose(-2, -1)
    if mask is not None:
        s = s.masked_fill(~mask, float('-inf'))
    p = torch.softmax(s, dim=-1)
    return p @ v.double(), p @ v.double().abs()


def _held_to(c, out, reference):
    """(max abs error, the check's measure, the measure's limit): against
    the plain version, max abs within PARITY_TOL; against the fp64 oracle,
    the largest ratio of error to the per-element bound, within 1."""
    if c['reference'] == 'plain':
        err = float((out.float() - reference.float()).abs().max())
        return err, err, PARITY_TOL
    o, pv_abs = reference
    diff = (out.double() - o).abs()
    bound = 2.0 ** -SHARP_PRECISION_BITS[c['dtype']] * (pv_abs + o.abs()) + SHARP_SLACK
    return float(diff.max()), float((diff / bound).max()), 1.0


def phase_kernels(previous_lib):
    import torch
    import torch.nn.functional as F
    from timm_tpu_torch.kernels import flash_attention, flash_attention_reference
    cases = [
        _attention_case('vit_b16_bucket64', 64, 12, 197, 64, None, 0),
        _attention_case('vit_b16_pad256', 64, 12, 256, 64, [197] * 64, 1),
        _attention_case('masked_n576', 16, 12, 576, 64,
                        [max(1, int(576 * 0.8) - 8 * i) for i in range(16)], 2),
        # the serving bucket whose grid is under one wave of blocks
        _attention_case('vit_b16_bucket1', 1, 12, 197, 64, None, 3),
        _attention_case('vit_b16_bucket64_fp16', 64, 12, 197, 64, None, 4, dtype='float16'),
        # scores with a standard deviation of 4: the running max changes from
        # key tile to key tile, so the alpha rescale carries the result
        _attention_case('vit_b16_bucket64_sharp', 64, 12, 197, 64, [197 - 3 * i for i in range(64)],
                        5, qk_scale=2.0, v_scale=1.0),
    ]
    rows = []
    for c in cases:
        q, k, v, mask = c['q'], c['k'], c['v'], c['mask']
        scale = torch.tensor(c['shape'][-1] ** -0.5, dtype=q.dtype).item()
        launches_before = flash_attention.launches
        with torch.inference_mode():
            out = flash_attention(q, k, v, mask=mask)
            previous_out = _previous_flash(previous_lib, q, k, v, mask, scale)
            if c['reference'] == 'plain':
                ref = flash_attention_reference(q, k, v, mask=mask)
            else:
                ref = _fp64_oracle(q, k, v, mask)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f'{c["name"]}: non-finite kernel output')
            err, measure, limit = _held_to(c, out, ref)
            previous_err, previous_measure, _ = _held_to(c, previous_out, ref)
            del out, previous_out, ref
            # device time (graph replay) and a caller's time (eager calls,
            # the wrapper's host time included), the previous design's the same way
            kernel_ms = graph_ms(lambda: flash_attention(q, k, v, mask=mask))
            call_ms = time_ms(lambda: flash_attention(q, k, v, mask=mask))
            previous_ms = graph_ms(lambda: _previous_flash(previous_lib, q, k, v, mask, scale))
            previous_call_ms = time_ms(lambda: _previous_flash(previous_lib, q, k, v, mask, scale))
            plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, mask=mask), iters=10)
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        rows.append({'case': c['name'], 'shape': c['shape'], 'dtype': c['dtype'],
                     'masked': mask is not None, 'reference': c['reference'],
                     'max_abs_err': err,
                     'tol': PARITY_TOL if c['reference'] == 'plain' else
                     f'2^-{SHARP_PRECISION_BITS[c["dtype"]]} (softmax-weighted |v| + |o|) '
                     f'+ {SHARP_SLACK} per element',
                     'error_over_bound': None if c['reference'] == 'plain' else measure,
                     'kernel_ms': kernel_ms, 'call_ms': call_ms, 'plain_ms': plain_ms,
                     'library_ms': library_ms,
                     'previous_ms': previous_ms, 'previous_call_ms': previous_call_ms,
                     'previous_max_abs_err': previous_err,
                     'bound_ms': c['bound_ms'], 'bound_by': c['bound_by'],
                     'bound_share': c['bound_ms'] / kernel_ms,
                     'previous_bound_share': c['bound_ms'] / previous_ms,
                     # the check, the warm-ups, the captures and the timed launches of this case
                     'launches': flash_attention.launches - launches_before})
        check(measure <= limit, f'{c["name"]}: kernel vs {c["reference"]}: {measure} > {limit}')
        check(previous_measure <= limit,
              f'{c["name"]}: previous kernel vs {c["reference"]}: {previous_measure} > {limit}')
    emit({'phase': 'kernels', 'kernel': 'flash_attention',
          'replaces': 'timm_tpu/kernels/flash_attention.py:79 (_fwd_kernel)', 'cases': rows})
    return rows


def _adamw_bound(n: int, mu_bytes: int):
    """Least time for one update of n parameters: read p, g, m, v, ema and
    write p, m, v, ema once; about 20 fp32 operations per parameter."""
    nbytes = n * (4 * 2 + 4 + mu_bytes * 2 + 4 * 2 + 4 * 2)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, 20 * n / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def phase_fused_adamw():
    """The fused AdamW + EMA kernel against its plain version on ViT-B/16's
    real leaf set and weight-decay mask (the optimizer's flat layout): 3
    updates from one state with a clip factor, fp32 and bf16 m; a NaN step
    must change nothing; then kernel, plain, library and bound times."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels import fused_adamw, fused_adamw_reference
    from timm_tpu_torch.optim import create_optimizer_v2
    model = timm_tpu_torch.create_model('vit_base_patch16_224', seed=0, device='cuda')
    opt = create_optimizer_v2(model, opt='adamw', lr=1e-3, weight_decay=0.05)
    n, n_decay = opt.flat_param.numel(), opt.n_decay
    gen = torch.Generator(device='cuda').manual_seed(5)
    p0 = opt.flat_param.clone()
    grads = [torch.randn(n, generator=gen, device='cuda').mul_(1e-3) for _ in range(3)]
    m0 = torch.randn(n, generator=gen, device='cuda').mul_(1e-4)
    v0 = torch.rand(n, generator=gen, device='cuda').mul_(1e-6)  # ~g^2 for |g| ~ 1e-3
    scale = torch.tensor(0.5, device='cuda')
    kw = dict(lr=1e-3, n_decay=n_decay, grad_scale=scale, **ADAMW_HP)
    rows = []
    for mu in (torch.float32, torch.bfloat16):
        state = {side: [p0.clone(), m0.to(mu, copy=True), v0.clone(), p0.clone(),
                        torch.zeros((), dtype=torch.int32, device='cuda')]
                 for side in ('kernel', 'plain')}
        for step in range(3):
            d = 0.0 if step == 0 else 0.9998
            kp, km, kv, ke, kc = state['kernel']
            fused_adamw(kp, grads[step], km, kv, ke, kc, ema_decay=d, **kw)
            rp, rm, rv, re, rc = state['plain']
            fused_adamw_reference(rp, grads[step], rm, rv, re, rc, ema_decay=d, **kw)
        torch.cuda.synchronize()
        k, r = state['kernel'], state['plain']
        errs = {name: float((k[i].float() - r[i].float()).abs().max())
                for i, name in enumerate(('p', 'm', 'v', 'ema'))}
        # p and ema are held to ADAMW_TOL absolute; m and v, whose values are
        # far below 1, to ADAMW_TOL of their largest magnitude.
        scale_of = {name: float(r[i].float().abs().max()) for i, name in ((1, 'm'), (2, 'v'))}
        tols = {'p': ADAMW_TOL, 'ema': ADAMW_TOL, 'v': ADAMW_TOL * scale_of['v'],
                'm': ADAMW_TOL * scale_of['m']}
        # m within one bf16 ulp (2^-7 of its magnitude) when stored in bf16
        ulp = (r[1].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -133)
        m_ok = bool(((k[1].float() - r[1].float()).abs() <= ulp).all()) \
            if mu == torch.bfloat16 else errs['m'] <= tols['m']
        bad = grads[0].clone()
        bad[12345] = float('nan')
        keep = [t.clone() for t in k]
        fused_adamw(k[0], bad, k[1], k[2], k[3], k[4], ok=torch.isfinite(bad).all(), **kw)
        torch.cuda.synchronize()
        nan_step_kept = all(torch.equal(a, b) for a, b in zip(k, keep))

        kernel_ms = time_ms(lambda: fused_adamw(k[0], grads[0], k[1], k[2], k[3], k[4],
                                                ema_decay=0.9998, **kw), iters=20, warmup=3)
        plain_ms = time_ms(lambda: fused_adamw_reference(r[0], grads[0], r[1], r[2], r[3], r[4],
                                                         ema_decay=0.9998, **kw),
                           iters=5, warmup=1)
        library_ms = None
        if mu == torch.float32:
            # one PyTorch call for the same update: torch's fused AdamW over
            # the leaves (decay and no-decay groups), then the EMA lerp. It
            # rounds differently (eps and decay order), so it is timed only.
            mask = opt.decay_mask()
            leaves = {name: torch.nn.Parameter(t.clone()) for name, t in opt.views(p0).items()}
            for (name, leaf), g in zip(leaves.items(), opt.views(grads[0]).values()):
                leaf.grad = g.clone()
            ema = [t.clone() for t in leaves.values()]
            lib = torch.optim.AdamW(
                [{'params': [t for nm, t in leaves.items() if mask[nm]], 'weight_decay': 0.05},
                 {'params': [t for nm, t in leaves.items() if not mask[nm]], 'weight_decay': 0.0}],
                lr=1e-3, betas=(0.9, 0.999), eps=1e-8, fused=True)
            params = list(leaves.values())

            @torch.no_grad()
            def library_step():
                lib.step()
                torch._foreach_lerp_(ema, params, 1 - 0.9998)
            library_ms = time_ms(library_step, iters=20, warmup=3)
            del leaves, ema, lib, params
        bound_ms, bound_by = _adamw_bound(n, 2 if mu == torch.bfloat16 else 4)
        rows.append({'mu_dtype': str(mu).replace('torch.', ''), 'n': n, 'n_decay': n_decay,
                     'max_abs_err': errs, 'tol': tols, 'max_abs': scale_of,
                     'm_within_one_ulp_or_tol': m_ok,
                     'nan_step_bit_identical': nan_step_kept, 'count_after': int(k[4]),
                     'kernel_ms': kernel_ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
                     'bound_ms': bound_ms, 'bound_by': bound_by, 'bound_share': bound_ms / kernel_ms})
        for name in ('p', 'v', 'ema'):
            check(errs[name] <= tols[name],
                  f'fused_adamw {mu}: {name} max abs err {errs[name]} > {tols[name]}')
        check(m_ok, f'fused_adamw {mu}: m off by more than its tolerance ({errs["m"]})')
        check(nan_step_kept, f'fused_adamw {mu}: a NaN step changed the state')
        del state, k, r, keep
    emit({'phase': 'kernels', 'kernel': 'fused_adamw',
          'replaces': 'timm_tpu/kernels/fused_adamw.py:54 (_kernel)', 'cases': rows})
    del model, opt, p0, grads, m0, v0
    torch.cuda.empty_cache()
    return rows


def _augment_case(name, B, size, K, mix, out_dtype, seed, width=None):
    """Inputs of the augment epilogue as the JAX registry makes them
    (timm_tpu/kernels/augment_epilogue.py ``_make_inputs``): a uint8 batch,
    K erase boxes per image, and with ``mix`` per-image lam, cutmix flags and
    boxes; without, the identity values the device stage passes."""
    import torch
    rng = np.random.default_rng(seed)
    h, w = size, width or size
    image = rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)
    boxes = np.zeros((B, K, 4), np.int32)
    for i in range(B):
        for k in range(K):
            eh, ew = rng.integers(4, h // 2), rng.integers(4, w // 2)
            boxes[i, k] = (rng.integers(0, h - eh), rng.integers(0, w - ew), eh, ew)
    if mix:
        yl, xl = rng.integers(0, h // 2, B), rng.integers(0, w // 2, B)
        lam = rng.uniform(0.2, 1.0, B).astype(np.float32)
        cut = rng.integers(0, 2, B).astype(bool)
        bbox = np.stack([yl, yl + h // 4, xl, xl + w // 4], 1).astype(np.int32)
    else:
        lam, cut, bbox = np.ones(B, np.float32), np.zeros(B, np.int32), np.zeros((B, 4), np.int32)
    args = [torch.from_numpy(a).cuda() for a in (image, lam, cut, bbox, boxes)]
    out_bytes = torch.empty((), dtype=out_dtype).element_size()
    n = image.size
    # the least work: read the uint8 batch once, write the output once;
    # about 20 fp32 operations per element (two divisions, the blend, the
    # box tests, the normalise)
    nbytes = n * (1 + out_bytes) + sum(a.numel() * a.element_size() for a in args[1:])
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, 20 * n / PEAK_FP32_FLOPS * 1e3
    return dict(name=name, args=args, shape=[B, h, w, 3], boxes=K, mix=mix, out_dtype=out_dtype,
                bound_ms=max(t_bytes, t_ops), bound_by='bytes' if t_bytes >= t_ops else 'operations')


def _within_one_ulp(out, ref, mantissa_bits: int, floor: float) -> bool:
    """|out - ref| <= max(one ulp of ref, floor) in a format with
    ``mantissa_bits`` explicit mantissa bits (7 for bf16)."""
    import torch
    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r.abs())[1] - (mantissa_bits + 1))
    return bool(((out.float() - r).abs() <= ulp.clamp_min(floor)).all())


def _previous_augment(lib, image, lam, use_cutmix, bbox, erase_box, *, mean, std, re_mean, out_dtype):
    """One launch of the previous augment design through its C entry (4 or
    1 bytes a thread)."""
    import torch
    b, h, w, c = image.shape
    k = erase_box.shape[1]
    out = torch.empty(image.shape, dtype=out_dtype, device=image.device)

    def floats(values):
        return (ctypes.c_float * 4)(*[float(np.float32(x)) for x in values])
    rc = lib.timm_augment_epilogue(
        image.data_ptr(), out.data_ptr(), {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}[out_dtype],
        lam.data_ptr(), use_cutmix.data_ptr(), int(use_cutmix.dtype == torch.bool), bbox.data_ptr(),
        erase_box.data_ptr() if k else None, b, h, w, c, k, floats(mean), floats(std), floats(re_mean),
        4 if (h * w * c) % 4 == 0 else 1, torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f'previous augment kernel launch failed ({rc})')
    return out


def phase_augment_epilogue(previous_lib):
    """The augment-epilogue kernel against its plain version on the card:
    the registry's two cases (mix_erase with K 1, no_mix) at batch 64 and
    128 at 224 px with fp32 out, and two edge cases (odd batch, W*C not a
    multiple of 4, K 3, bf16 out; H*W*C a multiple of 4 or odd); then
    kernel, previous design, plain and bound times."""
    import torch
    from timm_tpu_torch.kernels import augment_epilogue, augment_epilogue_reference
    kw = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), re_mean=(0.485, 0.456, 0.406))
    cases = [
        _augment_case('mix_erase_b64', 64, 224, 1, True, torch.float32, 0),
        _augment_case('no_mix_b64', 64, 224, 1, False, torch.float32, 1),
        _augment_case('mix_erase_b128', 128, 224, 1, True, torch.float32, 2),
        _augment_case('no_mix_b128', 128, 224, 1, False, torch.float32, 3),
        # W*C = 663: 4-byte groups cross rows (H*W*C a multiple of 4), and
        # one byte a thread (H*W*C odd)
        _augment_case('edge_odd_b_bf16', 63, 224, 3, True, torch.bfloat16, 4, width=221),
        _augment_case('edge_odd_b_bf16_odd_hwc', 63, 223, 3, True, torch.bfloat16, 5, width=221),
    ]
    rows = []
    for c in cases:
        args, dt = c['args'], c['out_dtype']
        launches_before = augment_epilogue.launches
        out = augment_epilogue(*args, out_dtype=dt, **kw)
        previous_out = _previous_augment(previous_lib, *args, out_dtype=dt, **kw)
        ref = augment_epilogue_reference(*args, out_dtype=dt, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ok = err <= AUGMENT_TOL if dt == torch.float32 else _within_one_ulp(out, ref, 7, AUGMENT_TOL)
        previous_ok = (bool(torch.equal(previous_out, ref)) if dt == torch.float32
                       else _within_one_ulp(previous_out, ref, 7, AUGMENT_TOL))
        kernel_ms = graph_ms(lambda: augment_epilogue(*args, out_dtype=dt, **kw))
        call_ms = time_ms(lambda: augment_epilogue(*args, out_dtype=dt, **kw))
        previous_ms = graph_ms(lambda: _previous_augment(previous_lib, *args, out_dtype=dt, **kw))
        previous_call_ms = time_ms(lambda: _previous_augment(previous_lib, *args, out_dtype=dt, **kw))
        plain_ms = time_ms(lambda: augment_epilogue_reference(*args, out_dtype=dt, **kw), iters=10)
        rows.append({'case': c['name'], 'shape': c['shape'], 'boxes': c['boxes'], 'mix': c['mix'],
                     'out_dtype': str(dt).replace('torch.', ''), 'max_abs_err': err,
                     'bit_identical': bool(torch.equal(out, ref)),
                     'tol': AUGMENT_TOL if dt == torch.float32 else 'one bf16 ulp, at least 1e-6',
                     'within_tol': ok, 'finite': bool(torch.isfinite(out).all()),
                     'kernel_ms': kernel_ms, 'call_ms': call_ms, 'plain_ms': plain_ms,
                     'library_ms': None, 'previous_ms': previous_ms,
                     'previous_call_ms': previous_call_ms, 'previous_within_tol': previous_ok,
                     'bound_ms': c['bound_ms'], 'bound_by': c['bound_by'],
                     'bound_share': c['bound_ms'] / kernel_ms,
                     'previous_bound_share': c['bound_ms'] / previous_ms,
                     'launches': augment_epilogue.launches - launches_before})
        check(ok, f'{c["name"]}: kernel vs plain max abs err {err} outside the tolerance')
        check(previous_ok, f'{c["name"]}: previous kernel vs plain outside the tolerance')
        check(rows[-1]['finite'], f'{c["name"]}: non-finite kernel output')
        del out, previous_out, ref
    emit({'phase': 'kernels', 'kernel': 'augment_epilogue',
          'replaces': 'timm_tpu/kernels/augment_epilogue.py:55 (_epilogue_kernel)', 'cases': rows})
    del cases
    torch.cuda.empty_cache()
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


def _train_task(seed: int, device, dtype, drop_path_rate: float, **task_kw):
    import timm_tpu_torch
    from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
    model = timm_tpu_torch.create_model('vit_base_patch16_224', dtype=dtype, seed=seed,
                                        drop_path_rate=drop_path_rate, device=device)
    opt = timm_tpu_torch.create_optimizer_v2(model, opt='adamw', lr=TRAIN_LR, weight_decay=0.05)
    return timm_tpu_torch.ClassificationTask(
        model, optimizer=opt, train_loss_fn=LabelSmoothingCrossEntropy(0.1), seed=seed, **task_kw)


def _train_batch(n: int, seed: int, device):
    import torch
    labels = np.random.default_rng(seed).integers(0, 1000, n)
    return {'input': torch.from_numpy(_images(n, seed=seed)).to(device),
            'target': torch.from_numpy(labels).to(device)}


def phase_train():
    """The port's training path: ClassificationTask trains ViT-B/16 (bf16
    compute, fp32 parameters) with AdamW, the weight-decay mask, clipping,
    EMA, a cosine schedule with warmup and the non-finite guard, 20 steps on
    one fixed batch. The launch counts are read around this run only."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels import flash_attention, fused_adamw
    task = _train_task(0, 'cuda', torch.bfloat16, 0.1, clip_grad=1.0)
    task.setup_ema(decay=0.9998)
    sched, _ = timm_tpu_torch.create_scheduler_v2(
        TRAIN_LR, 'cosine', num_epochs=TRAIN_STEPS, warmup_epochs=3, warmup_lr=1e-6)
    batch = _train_batch(TRAIN_BATCH, 4, 'cuda')
    depth = len(task.model.blocks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flash_attention.launches = 0
    fused_adamw.launches = 0
    metrics, flash_steps, adamw_steps, lrs = [], [], [], []
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        if step == TRAIN_WARMUP_STEPS:
            start.record()
        f0, a0 = flash_attention.launches, fused_adamw.launches
        lrs.append(sched.step(step)[0])
        metrics.append(task.train_step(batch, lr=lrs[-1], step=step + 1))
        flash_steps.append(flash_attention.launches - f0)
        adamw_steps.append(fused_adamw.launches - a0)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'flash_attention': flash_attention.launches, 'fused_adamw': fused_adamw.launches}
    step_ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP_STEPS)
    losses = [float(m['loss']) for m in metrics]
    last = metrics[-1]
    emit({'phase': 'train', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
          'batch': TRAIN_BATCH, 'steps': TRAIN_STEPS, 'drop_path_rate': 0.1,
          'losses': losses, 'grad_norms': [float(m['grad_norm']) for m in metrics], 'lrs': lrs,
          'step_ms': step_ms, 'img_per_s': TRAIN_BATCH / step_ms * 1e3, 'wall_s': wall,
          'peak_memory_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
          'nonfinite_count': int(last['nonfinite_count']),
          'nonfinite_total': int(last['nonfinite_total']),
          'optimizer_count': int(task.optimizer.count),
          'flash_launches_per_step': flash_steps, 'fused_adamw_launches_per_step': adamw_steps,
          'launches': launches})
    check(all(np.isfinite(losses)), f'train: non-finite loss in {losses}')
    check(losses[-1] < losses[0], f'train: last loss {losses[-1]} not below first {losses[0]}')
    check(adamw_steps == [1] * TRAIN_STEPS, f'train: fused_adamw launches per step {adamw_steps}')
    check(flash_steps == [depth] * TRAIN_STEPS, f'train: flash launches per step {flash_steps}')
    check(int(last['nonfinite_total']) == 0 and int(task.optimizer.count) == TRAIN_STEPS,
          'train: the guard skipped a step')
    return launches, task, batch, step_ms


def _write_image_folder(root: str, per_class: int, seed: int = 0):
    """A folder of class folders of seeded RGB PNGs, 256-320 px a side:
    smooth random colour fields with pixel noise, written in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    rng = np.random.default_rng(seed)
    jobs = []
    for c in range(3):
        os.makedirs(os.path.join(root, f'class{c}'))
        for i in range(per_class):
            h, w = (int(v) for v in rng.integers(256, 321, 2))
            coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
            noise = rng.integers(-12, 13, (h, w, 3))
            jobs.append((os.path.join(root, f'class{c}', f'{i:04d}.png'), coarse, noise, (w, h)))

    def write(job):
        path, coarse, noise, size = job
        smooth = np.asarray(Image.fromarray(coarse).resize(size, Image.BILINEAR), np.int64)
        Image.fromarray(np.clip(smooth + noise, 0, 255).astype(np.uint8)).save(path, compress_level=1)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    return len(jobs)


def _input_loader(root, data_config, device, seed=0, num_workers=INPUT_WORKERS, no_aug=False):
    """The recipe's loader: create_dataset over the folder, create_loader
    with device_augment (erasing 0.25 'const', Mixup 0.8 / CutMix 1.0 with
    label smoothing 0.1) and device_prefetch 2."""
    import torch
    from timm_tpu_torch.data import Mixup, create_loader
    from timm_tpu_torch.data.dataset_factory import create_dataset
    mixup = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, num_classes=1000,
                  seed=seed)
    return create_loader(
        create_dataset('', root, split='train'), data_config['input_size'], TRAIN_BATCH,
        is_training=True, no_aug=no_aug, re_prob=0.25, re_mode='const',
        interpolation=data_config['interpolation'], mean=data_config['mean'],
        std=data_config['std'], num_workers=num_workers, seed=seed, device_augment=True,
        device_prefetch=2, mixup=mixup, device=torch.device(device))


def _batches(loader):
    """Batches of the loader over successive epochs, without end."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def _host_ms_per_image(root, data_config, n: int = 64):
    """Host time per image of each stage of the train transform, one thread:
    decode (the dataset with no transform), then each transform in turn."""
    import random

    from timm_tpu_torch.data.dataset_factory import create_dataset
    from timm_tpu_torch.data.transforms_factory import create_transform
    ds = create_dataset('', root, split='train')
    tf = create_transform(data_config['input_size'], is_training=True,
                          interpolation=data_config['interpolation'], mean=data_config['mean'],
                          std=data_config['std'], output_dtype=np.uint8)
    random.seed(0)
    ms = {'decode': 0.0}
    for i in range(n):
        t = time.perf_counter()
        img, _ = ds[i * (len(ds) // n)]
        ms['decode'] += time.perf_counter() - t
        for step in tf.transforms:
            t = time.perf_counter()
            img = step(img)
            name = type(step).__name__
            ms[name] = ms.get(name, 0.0) + time.perf_counter() - t
    return {k: v * 1e3 / n for k, v in ms.items()}


def phase_input_train(train_step_ms: float):
    """The input path of training: ClassificationTask trains ViT-B/16 (bf16
    compute, fp32 params, SoftTargetCrossEntropy, the task's normalize off
    since the stage normalises) for 20 steps at batch 64 from a folder of
    seeded PNGs through create_dataset -> create_loader (threaded decode and
    transforms, DevicePrefetcher(size=2), DeviceAugmentStage with Mixup /
    CutMix and RandomErasing sampled on the host, the augment-epilogue
    kernel). The launch counts are read around this run only. Then: a
    profiler breakdown over 3 steps, the input path's own rate over 2 epochs
    without training, and a card stage and a CPU stage over the same
    deterministic loader, which must agree."""
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import timm_tpu_torch
    from timm_tpu_torch.data import resolve_model_data_config
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    from timm_tpu_torch.loss import SoftTargetCrossEntropy
    with tempfile.TemporaryDirectory(prefix='chip_smoke_images_') as root:
        t0 = time.perf_counter()
        n_images = _write_image_folder(root, INPUT_IMAGES_PER_CLASS)
        write_s = time.perf_counter() - t0
        model = timm_tpu_torch.create_model('vit_base_patch16_224', dtype=torch.bfloat16, seed=0,
                                            drop_path_rate=0.1, device='cuda')
        data_config = resolve_model_data_config(model)
        opt = timm_tpu_torch.create_optimizer_v2(model, opt='adamw', lr=TRAIN_LR, weight_decay=0.05)
        task = timm_tpu_torch.ClassificationTask(
            model, optimizer=opt, train_loss_fn=SoftTargetCrossEntropy(), seed=0, clip_grad=1.0,
            mean=None)
        task.setup_ema(decay=0.9998)
        sched, _ = timm_tpu_torch.create_scheduler_v2(
            TRAIN_LR, 'cosine', num_epochs=TRAIN_STEPS, warmup_epochs=3, warmup_lr=1e-6)
        loader = _input_loader(root, data_config, 'cuda')
        depth = len(model.blocks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        batches = _batches(loader)
        flash_attention.launches = fused_adamw.launches = augment_epilogue.launches = 0
        metrics, wait_ms, step_wall_ms, per_step = [], [], [], []
        t0 = time.perf_counter()
        for step in range(TRAIN_STEPS):
            if step == TRAIN_WARMUP_STEPS:
                start.record()
            counts = (flash_attention.launches, fused_adamw.launches, augment_epilogue.launches)
            tw = time.perf_counter()
            x, y = next(batches)
            wait_ms.append((time.perf_counter() - tw) * 1e3)
            metrics.append(task.train_step({'input': x, 'target': y},
                                           lr=sched.step(step)[0], step=step + 1))
            # the step ends in the guard's counter read-back, as in JAX
            step_wall_ms.append((time.perf_counter() - tw) * 1e3)
            per_step.append([now - was for now, was in zip(
                (flash_attention.launches, fused_adamw.launches, augment_epilogue.launches), counts)])
            del x, y
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {'flash_attention': flash_attention.launches,
                    'fused_adamw': fused_adamw.launches,
                    'augment_epilogue': augment_epilogue.launches}
        step_ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(m['loss']) for m in metrics]

        # where the time goes over 3 more steps, input wait included
        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            for i in range(reps):
                x, y = next(batches)
                task.train_step({'input': x, 'target': y}, lr=1e-5, step=TRAIN_STEPS + 1 + i)
                del x, y
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - tp) * 1e3 / reps
        batches.close()
        # the input path alone, no training: 2 epochs of a fresh loader
        loader_only = _batches(_input_loader(root, data_config, 'cuda'))
        loader_wait_ms = []
        tl = time.perf_counter()
        for _ in range(2 * len(loader)):
            tb = time.perf_counter()
            next(loader_only)
            loader_wait_ms.append((time.perf_counter() - tb) * 1e3)
        torch.cuda.synchronize()
        loader_img_per_s = 2 * len(loader) * TRAIN_BATCH / (time.perf_counter() - tl)
        loader_only.close()
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, 'is_user_annotation', False):
                kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3 / reps
        busy = sum(kernels.values())
        epilogue = sum(v for k, v in kernels.items() if 'augment_epilogue_kernel' in k)

        host_ms = _host_ms_per_image(root, data_config)

        # a card stage and a CPU stage over the same deterministic loader
        # (one worker, resize and centre crop, same seeds): 2 batches each
        stages = {}
        for device in ('cuda', 'cpu'):
            it = iter(_input_loader(root, data_config, device, num_workers=1, no_aug=True))
            stages[device] = [tuple(t.float().cpu() for t in next(it)) for _ in range(2)]
            it.close()
        stage_err = max(float((a - b).abs().max())
                        for (xa, ya), (xb, yb) in zip(stages['cuda'], stages['cpu'])
                        for a, b in ((xa, xb), (ya, yb)))
    row = {'phase': 'input_train', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
           'batch': TRAIN_BATCH, 'steps': TRAIN_STEPS, 'images': n_images,
           'batches_per_epoch': len(loader), 'workers': INPUT_WORKERS, 'pillow': True,
           'data_config': {k: data_config[k] for k in ('input_size', 'interpolation', 'mean', 'std')},
           'write_images_s': write_s, 'losses': losses,
           'grad_norms': [float(m['grad_norm']) for m in metrics],
           'step_ms': step_ms, 'img_per_s': TRAIN_BATCH / step_ms * 1e3,
           'train_fixed_batch_step_ms': train_step_ms, 'wall_s': wall,
           'input_wait_ms_per_step': wait_ms,
           'input_wait_ms_mean_steps_3_20': float(np.mean(wait_ms[TRAIN_WARMUP_STEPS:])),
           'step_wall_ms_per_step': step_wall_ms,
           # steps that do not open an epoch (no pipeline restart)
           'step_wall_ms_median_within_epoch': float(np.median(
               [ms for i, ms in enumerate(step_wall_ms) if i % len(loader)])),
           'loader_only_img_per_s': loader_img_per_s,
           'loader_only_wait_ms_per_batch': loader_wait_ms,
           'host_ms_per_image_one_thread': host_ms,
           'peak_memory_gb': peak_gb,
           'launches_per_step': per_step, 'launches': launches,
           'profiled_steps': reps, 'wall_ms_per_step_profiled': prof_wall_ms,
           'device_ms_per_step': busy if kernels else 'not measured',
           'idle_share': 1.0 - busy / prof_wall_ms if kernels else 'not measured',
           'augment_epilogue_ms_per_step': epilogue if kernels else 'not measured',
           'augment_epilogue_share': epilogue / busy if kernels else 'not measured',
           'card_vs_cpu_stage_max_abs_err': stage_err, 'card_vs_cpu_stage_tol': AUGMENT_TOL,
           'nonfinite_total': int(metrics[-1]['nonfinite_total'])}
    emit(row)
    check(all(np.isfinite(losses)), f'input_train: non-finite loss in {losses}')
    check([p[2] for p in per_step] == [1] * TRAIN_STEPS,
          f'input_train: augment_epilogue launches per step {[p[2] for p in per_step]}')
    check([p[1] for p in per_step] == [1] * TRAIN_STEPS,
          f'input_train: fused_adamw launches per step {[p[1] for p in per_step]}')
    check([p[0] for p in per_step] == [depth] * TRAIN_STEPS,
          f'input_train: flash launches per step {[p[0] for p in per_step]}')
    check(stage_err <= AUGMENT_TOL, f'input_train: card vs CPU stage max abs err {stage_err}')
    del task, model, opt, loader
    torch.cuda.empty_cache()
    return launches


def phase_train_vs_cpu():
    """One step's gradients of ViT-B/16, bf16 on the card against the same
    seeded weights in fp32 on the CPU, batch 8, drop_path 0."""
    import torch
    from timm_tpu_torch.kernels import flash_attention
    batch = _train_batch(8, 5, 'cpu')
    grads = {}
    for device, dtype in (('cuda', torch.bfloat16), ('cpu', None)):
        task = _train_task(0, device, dtype, 0.0, nonfinite_guard=False)
        before = flash_attention.launches
        t0 = time.perf_counter()
        task.train_step(batch, lr=0.0, step=1)
        grads[device] = (task.optimizer.flat_grad.float().cpu(), flash_attention.launches - before,
                         time.perf_counter() - t0)
        del task
    g_card, launches, _ = grads['cuda']
    g_cpu, _, cpu_s = grads['cpu']
    err = float((g_card - g_cpu).norm() / g_cpu.norm())
    emit({'phase': 'train_vs_cpu', 'model': 'vit_base_patch16_224', 'batch': 8,
          'grad_rel_l2_bf16_card_vs_fp32_cpu': err, 'tol': GRAD_REL_L2_TOL,
          'finite': bool(torch.isfinite(g_card).all()), 'flash_launches_card_step': launches,
          'cpu_fp32_step_seconds': cpu_s})
    check(bool(torch.isfinite(g_card).all()), 'train_vs_cpu: non-finite gradients on the card')
    check(err <= GRAD_REL_L2_TOL, f'train_vs_cpu: gradient rel L2 {err} > {GRAD_REL_L2_TOL}')
    check(launches == 12, f'train_vs_cpu: {launches} flash launches in one step')
    torch.cuda.empty_cache()


def phase_train_breakdown(task, batch):
    """Where the time of a train step goes: device time by kernel from
    torch.profiler over 3 steps, the device's idle share of the host wall
    time, and the shares of the flash forward, the attention backward (the
    named range around the plain recompute) and fused_adamw; the attention
    backward of one layer timed alone with CUDA events; and the library's
    attention backward at the same shapes (SDPA forward + backward less its
    forward), timed only: the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from timm_tpu_torch.kernels import flash_attention_backward
    reps = 3
    task.train_step(batch, lr=1e-5, step=TRAIN_STEPS + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            task.train_step(batch, lr=1e-5, step=TRAIN_STEPS + 2 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels, attn_bwd = {}, 0.0
    for e in prof.events():
        if e.name == 'flash_attention_backward':
            # the named range: its CPU event sums the device time of the
            # kernels it launched; its mirror on the device timeline is a
            # span, not a kernel, and stays out of the busy time
            if e.device_type != DeviceType.CUDA:
                attn_bwd += e.device_time_total / 1e3 / reps
        elif e.device_type == DeviceType.CUDA and not getattr(e, 'is_user_annotation', False):
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3 / reps
    busy = sum(kernels.values())

    def share(part):
        return part / busy if kernels else 'not measured'
    flash = sum(v for k, v in kernels.items() if 'flash_fwd_kernel' in k)
    adamw = sum(v for k, v in kernels.items() if 'fused_adamw_kernel' in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    # one layer's attention backward at the train step's shapes, alone
    g = torch.Generator(device='cuda').manual_seed(7)
    q, k, v, do = (torch.randn(TRAIN_BATCH, 12, 197, 64, generator=g, device='cuda')
                   .to(torch.bfloat16) for _ in range(4))
    bwd_ms = time_ms(lambda: flash_attention_backward(q, k, v, None, 64 ** -0.5, do),
                     iters=20, warmup=3)
    # its least time: q, k, v, do read and dq, dk, dv written once (bf16);
    # five N x N x D products (scores, dv, dp, dq, dk) in fp32, as JAX does
    nbytes = 7 * q.numel() * 2
    flops = 5 * 2 * TRAIN_BATCH * 12 * 197 * 197 * 64
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def library_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(ql, kl, vl), (ql, kl, vl), do)
    library_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl), iters=20, warmup=3)
    library_fwd_bwd_ms = time_ms(library_fwd_bwd, iters=20, warmup=3)
    library_bwd_ms = library_fwd_bwd_ms - library_fwd_ms
    emit({'phase': 'train_breakdown', 'model': 'vit_base_patch16_224', 'batch': TRAIN_BATCH,
          'wall_ms_per_step': wall_ms,
          'device_ms_per_step': busy if kernels else 'not measured',
          'idle_share': 1.0 - busy / wall_ms if kernels else 'not measured',
          'flash_fwd_ms': flash, 'flash_fwd_share': share(flash),
          'attention_bwd_ms': attn_bwd if attn_bwd else 'not measured',
          'attention_bwd_share': share(attn_bwd) if attn_bwd else 'not measured',
          'fused_adamw_ms': adamw, 'fused_adamw_share': share(adamw),
          'attention_bwd_ms_per_layer_alone': bwd_ms,
          'attention_bwd_bound_ms_per_layer': max(t_bytes, t_ops),
          'attention_bwd_bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
          'attention_bwd_library_ms_per_layer': library_bwd_ms,
          'sdpa_fwd_ms': library_fwd_ms, 'sdpa_fwd_bwd_ms': library_fwd_bwd_ms,
          'top_kernels': [{'kernel': k[:120], 'ms': v} for k, v in top]})
    return bwd_ms, library_bwd_ms


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
        previous = phase_build()
        rows = phase_kernels(previous['flash_attention'])
        adamw_rows = phase_fused_adamw()
        augment_rows = phase_augment_epilogue(previous['augment_epilogue'])
        phase_model()
        serve_launches, served_model = phase_serve()
        phase_breakdown(served_model)
        del served_model
        train_launches, task, batch, train_step_ms = phase_train()
        phase_train_vs_cpu()
        attn_bwd_ms, attn_bwd_library_ms = phase_train_breakdown(task, batch)
        del task, batch
        input_launches = phase_input_train(train_step_ms)
    except Exception:
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1
    # bucket-64 attention; fp32-m AdamW; the epilogue at batch 64 with mixup
    main_row, adamw_row, augment_row = rows[0], adamw_rows[0], augment_rows[0]
    emit({'kernels': [{
        'name': 'flash_attention', 'route': 'cuda',
        'source': 'timm_tpu_torch/kernels/csrc/flash_attention.cu',
        'replaces': 'timm_tpu/kernels/flash_attention.py:79',
        'launches': (serve_launches + train_launches['flash_attention']
                     + input_launches['flash_attention']),
        'launches_by_path': {'serve': serve_launches, 'train': train_launches['flash_attention'],
                             'input_train': input_launches['flash_attention']},
        # against the plain version; the sharp case's error over its fp64 bound
        'max_abs_err': max(r['max_abs_err'] for r in rows if r['reference'] == 'plain'),
        'sharp_error_over_bound': max(r['error_over_bound'] for r in rows
                                      if r['reference'] != 'plain'),
        'ms': main_row['kernel_ms'], 'call_ms': main_row['call_ms'],
        'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'], 'bound_by': main_row['bound_by'],
        'bound_share': main_row['bound_share'], 'library_ms': main_row['library_ms'],
        'previous_ms': main_row['previous_ms'], 'previous_call_ms': main_row['previous_call_ms'],
        'previous_source': 'timm_tpu_torch/kernels/csrc/previous/flash_attention.cu',
        'backward_plain_ms_per_layer': attn_bwd_ms,
        'backward_library_ms_per_layer': attn_bwd_library_ms,
    }, {
        'name': 'fused_adamw', 'route': 'cuda',
        'source': 'timm_tpu_torch/kernels/csrc/fused_adamw.cu',
        'replaces': 'timm_tpu/kernels/fused_adamw.py:54',
        'launches': train_launches['fused_adamw'] + input_launches['fused_adamw'],
        'launches_by_path': {'train': train_launches['fused_adamw'],
                             'input_train': input_launches['fused_adamw']},
        'max_abs_err': max(max(r['max_abs_err'][k] for k in ('p', 'v', 'ema'))
                           for r in adamw_rows),
        'ms': adamw_row['kernel_ms'], 'plain_ms': adamw_row['plain_ms'],
        'bound_ms': adamw_row['bound_ms'], 'bound_by': adamw_row['bound_by'],
        'bound_share': adamw_row['bound_share'], 'library_ms': adamw_row['library_ms'],
        # unchanged since it was ported: its previous design is itself
        'previous_ms': adamw_row['kernel_ms'],
        'previous_source': 'timm_tpu_torch/kernels/csrc/fused_adamw.cu',
    }, {
        'name': 'augment_epilogue', 'route': 'cuda',
        'source': 'timm_tpu_torch/kernels/csrc/augment_epilogue.cu',
        'replaces': 'timm_tpu/kernels/augment_epilogue.py:55',
        'launches': input_launches['augment_epilogue'],
        'launches_by_path': {'input_train': input_launches['augment_epilogue']},
        # fp32 cases; the bf16 cases are held to one bf16 ulp ('within_tol')
        'max_abs_err': max(r['max_abs_err'] for r in augment_rows if r['out_dtype'] == 'float32'),
        'bf16_within_one_ulp': all(r['within_tol'] for r in augment_rows
                                   if r['out_dtype'] == 'bfloat16'),
        'bit_identical_fp32': all(r['bit_identical'] for r in augment_rows
                                  if r['out_dtype'] == 'float32'),
        'ms': augment_row['kernel_ms'], 'call_ms': augment_row['call_ms'],
        'plain_ms': augment_row['plain_ms'],
        'bound_ms': augment_row['bound_ms'], 'bound_by': augment_row['bound_by'],
        'bound_share': augment_row['bound_share'], 'library_ms': None,
        'previous_ms': augment_row['previous_ms'], 'previous_call_ms': augment_row['previous_call_ms'],
        'previous_source': 'timm_tpu_torch/kernels/csrc/previous/augment_epilogue.cu',
    }], 'seconds': time.perf_counter() - t0})
    print(device['nvidia_smi'], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': device['name'],
                                 'count': device['count']}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
