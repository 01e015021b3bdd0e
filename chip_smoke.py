#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (timm_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
nvcc per source, side by side), holds each kernel against its plain PyTorch
version on the card, checks ViT-B/16 in bf16 on the card against the same
weights in fp32 on the CPU, serves ViT-B/16 through the port's
InferenceEngine, trains ViT-B/16 through the port's ClassificationTask
(AdamW through the fused AdamW + EMA kernel; the step a CUDA graph from its
second call on, the counterpart of JAX's jitted step) on one fixed batch,
with its gradients checked against the CPU in fp32 and a profiler breakdown
of the train step, holds the replayed train step against its eager body bit
for bit (phase ``train_graph``: AdamW, accumulation 2, SGD, Muon and
NAdamW under lookahead, caution and layer decay over 20 steps with lr and
EMA decay changing every step and a skipped non-finite step; eager against
replayed step ms and idle share; the eval graph against the eager forward),
trains it with Muon (phase ``muon_train``: the Newton-Schulz step in fp32
inside the captured step, its optimizer step and iterations timed alone)
and holds one Muon update on the card against the CPU (``muon_vs_cpu``),
and trains it again from a folder of seeded PNGs through the
port's input path (threaded loader, CUDA-stream prefetcher, mixup, cutmix
and erasing sampled on the host, the augment program's CUDA graph with the
augment-epilogue kernel). Phase ``recipe_train`` trains it with ViT-B/16's
timm / DeiT recipe (RandAugment on the host, 'pixel' erasing and Mixup /
CutMix on the card, the augment program's graph running its torch
program), holds the augment program's replays against its eager run in
every erase mode, checks the erased pixels' statistics and a resumed
epoch's batches, and runs an AugMix arm with the JSD loss. Last, phase
``drivers`` runs the port's command-line drivers through their
``main(argv)``: ``train`` from a folder of PNGs uninterrupted (A), stopped
by an injected SIGTERM after update 12 (B) and resumed with ``--resume
auto`` (C), C's checkpoint held to A's; then ``validate`` and
``inference`` on A's EMA weights, held to A's last evaluation, and one
``python -m timm_tpu_torch.validate`` subprocess. ConvNeXt-B
(``convnext_base``, full width and depth, layer scale and GRN lifted from
their near-identity init) runs after ``train_graph``: its depthwise 7x7
convolution alone, forward and backward against their bounds (phase
``convnext_depthwise``); bf16 on the card against fp32 on the CPU
(``convnext_model``); served through the engine with its bucket graphs
(``convnext_serve``); trained through ClassificationTask with drop path
0.5, one ``fused_adamw`` launch an update and the step a CUDA graph, its
gradients against the CPU and its replays against the eager body
(``convnext_train``); and, last, trained by the train driver from PNGs
through the augment-epilogue kernel under the profiler in a subprocess and
validated (``convnext_drivers``). EfficientNetV2-S (``efficientnetv2_s``,
full width and depth, 300 px, BatchNorm with running statistics) runs after
ConvNeXt-B's train phase: bf16 on the card against fp32 on the CPU in eval
and train mode, running statistics included (``effnet_model``); served
through the engine's bucket graphs in eval mode (``effnet_serve``); trained
through ClassificationTask with drop path and dropout 0.2, one
``fused_adamw`` launch an update, its module families (BatchNorm + SiLU,
depthwise and other convolutions, SE) timed alone, gradients against the
CPU, and the replayed step against its eager body, running statistics
included, with and without gradient accumulation 2 (``effnet_train``);
and, last, the train driver from PNGs through the augment-epilogue kernel,
stopped by SIGTERM and resumed bit for bit, then validated
(``effnet_drivers``); its train phase also trains it with timm's
EfficientNet RMSprop-TF recipe, replays against eager steps. ResNet-50
(``resnet50``, full width and depth, 224 px, the residual branches damped)
runs after EfficientNetV2-S's train phase: bf16 and fp32 on the card against
fp32 on the CPU (``resnet_model``); served through the engine's bucket
graphs (``resnet_serve``); trained with timm's SGD recipe, its BatchNorm +
ReLU timed alone, gradients against the CPU, the replayed step against its
eager body with split BN over 3 splits, an AdamW arm through
``fused_adamw``, and every optimizer name of the JAX registry the port
added last (5 replayed steps against eager ones, two updates against the
CPU, the optimizer step timed) (``resnet_train``); and, last, timm's
ResNet-50 AugMix / JSD / split-BN recipe through the train driver, stopped
by SIGTERM and resumed bit for bit, validated, with test-time pooling, and
inferred (``resnet_drivers``). NaFlex (``naflexvit_base_patch16_gap``,
full width and depth, bf16) runs after ResNet-50's train phase: 4 rows at L
576 with 576 / 401 / 200 / 64 valid tokens against fp32 on the CPU, the
card's fp32 against the CPU, and in both mask modes every block's
attention (the flash kernel with the key-padding mask, JAX's value in the
padded query rows) against the plain version (``naflex_model``); served at
384 px through the engine's bucket graphs, the flash kernel unmasked
(``naflex_serve``); trained through NaFlexClassificationTask from seeded
PNGs of 96-640 px through the NaFlex loader's token-budget buckets (128 to
1024 tokens, 36,864 a batch), mixup, cutmix and 'pixel' erasing on the
card, each bucket's replay checked bit for bit against its eager body
after other buckets ran, per-bucket step, host and attention times, and
gradients against the CPU (``naflex_train``); and, after ResNet-50's
driver phase, the train driver with ``--naflex-loader`` run A, stopped by
SIGTERM and resumed, bit for bit (``naflex_drivers``). Differential
attention (``vit_dlittle_patch16_reg1_gap_256``, full width and depth, 256
px, layer scale lifted from its 1e-5 init) runs after NaFlex's train
phase: bf16 on the card against fp32 on the CPU (``dlittle_model``),
served (``dlittle_serve``), trained with AdamW (replays against the eager
body, its DiffAttention modules timed alone, gradients against the CPU;
``dlittle_train``), and last a driver run with 'const' erasing through the
augment-epilogue kernel at 256 px (``dlittle_drivers``). SigLIP So400m
(``vit_so400m_patch14_siglip_224``, uncut: width 1152, 27 blocks, 16 heads
of 72, the 'map' latent pool, 428.8 M parameters, bf16) runs after
``vit_dlittle``'s train phase: bf16 and fp32 on the card against fp32 on
the CPU, and ``forward_intermediates`` against the blocks' outputs
(``so400m_model``); served through the engine's bucket graphs, 28 flash
kernels a replayed forward (``so400m_serve``); trained in two arms, plain
and with gradient checkpointing, each replayed step bit for bit with its
eager body, the arms' gradients against each other and against the CPU
(``so400m_train``); and, last, the train driver with
``--grad-checkpointing`` at 4 blocks, then ``validate`` (``so400m_drivers``).
To keep the script inside its time limit, earlier paths run at a cut depth:
``train_graph``'s untimed arms (ViT-B/16 at 6 blocks), ``resnet_train``'s
optimizer arms (resnet50 at one bottleneck a stage) and every driver drill
at its model's width: ``drivers`` (ViT-B/16 at 4 blocks, its Muon arm
too), ``convnext_drivers`` (one block a stage), ``effnet_drivers`` (depth
multiplier 0.25), ``resnet_drivers`` (one bottleneck a stage),
``naflex_drivers`` and ``dlittle_drivers`` (4 blocks); validate and
inference take the same ``--model-kwargs``.

Phase ``kernels`` reads the kernel registry (``timm_tpu_torch/kernels/
registry.py``): every registered kernel is held to its plain version at
every case's dry and live arm (within ``parity_tol`` and, for flash,
element by element within its ``error_bound``), then timed by the harness
(``kernels/harness.py``): device time from CUDA-graph replays
(``kernel_ms``), eager calls with the wrapper's host time (``call_ms``), the
plain version and the library call, each set against the registry's bound
(``bound_share``); one verdict line per kernel (keep or delete against the
plain version) precedes the JSON. Then the checks the registry does not
make: the flash kernel's sharp-score case against an fp64 oracle, the
fused AdamW's clipped steps and NaN step on ViT-B/16's leaf set, the
augment epilogue's bf16 output, and the previous designs
(``kernels/csrc/previous/``, ``previous_ms``), timed the same way. The
engine serves every bucket by replaying the CUDA graph it captured at
``add_model``; phase ``serve`` checks under torch.profiler that each
replay, marked off as a call of its own, ran the captured flash kernels,
and holds each replay bit for bit against an eager forward; phase ``breakdown`` times eager forwards against
replays per bucket. A replay runs no Python, so the kernel wrappers' launch
counters move at a graph's warm-up and capture only: the train phases and
run C of ``drivers`` count what the replays ran under the profiler, per
call: each profiled call (a replay, a step) ends in a kernel of its own
(``_mark``) and a kernel's count is the most that any call ran, because
the profiler loses single records in a long process; no whole-run total
decides a check. Each phase prints one JSON line; then come the kernel
summary line, the card's name and power limit as nvidia-smi gives them,
and the last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; with no CUDA device, or outside the repository, it exits
non-zero at once. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Every kernel is held to its plain version within its registry parity_tol
# (timm_tpu_torch/kernels/registry.py, the JAX registry's values) and, for
# flash attention, element by element within its error_bound (scaled to
# each output); and timed and bounded there (kernels/harness.py). Beyond that:
# fused_adamw kernel vs plain over 3 clipped steps on ViT-B/16's leaf set:
# max abs on p and ema; m and v, far below 1, relative to their largest magnitude
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
# the TPU kernel each registered kernel replaces
REPLACES = {'flash_attention': 'timm_tpu/kernels/flash_attention.py:79 (_fwd_kernel)',
            'fused_adamw': 'timm_tpu/kernels/fused_adamw.py:54 (_kernel)',
            'augment_epilogue': 'timm_tpu/kernels/augment_epilogue.py:55 (_epilogue_kernel)'}
# the registered case on each kernel's main path: its numbers head the kernels line
MAIN_CASE = {'flash_attention': 'vit_b16_bucket64', 'fused_adamw': 'vit_b16',
             'augment_epilogue': 'mix_erase_b64'}
ADAMW_HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP_STEPS, TRAIN_LR = 64, 20, 2, 3e-4
# phase input_train: a folder of seeded PNGs, 3 classes, 256-320 px a side
INPUT_IMAGES_PER_CLASS, INPUT_WORKERS = 192, 6
# kernels whose previous design is kept in kernels/csrc/previous/, built
# beside them and timed on the same inputs (previous_ms)
PREVIOUS_KERNELS = ('flash_attention', 'augment_epilogue')
PREVIOUS_FLASH_HEAD_DIMS = (32, 64, 128, 256)
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
    from timm_tpu_torch.kernels import registry
    from timm_tpu_torch.kernels._build import SOURCE_DIR, load_library
    jobs = ([(name, SOURCE_DIR) for name in registry.kernel_names()]
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


def phase_kernels():
    """Every registered kernel through the harness on the card: parity
    against its plain version at every case's dry and live arm, then the
    A/B at the live arm (device time from graph replays, eager call time,
    the plain version's and the library call's, the registry's bound), and
    one verdict line per kernel. Returns {kernel: verdict record}."""
    from timm_tpu_torch.kernels import harness, registry
    counters = registry.launch_counters()
    verdicts = {}
    for spec in registry.all_specs():
        before = counters[spec.name].launches
        rec = harness.ab_verdict(spec, live=True, device='cuda')
        # the parity checks, the warm-ups, the captures and the timed launches
        rec['launches'] = counters[spec.name].launches - before
        print(harness.format_verdict_line(rec), flush=True)
        emit({'phase': 'kernels', 'kernel': spec.name,
              'replaces': REPLACES[spec.name], **rec})
        check(rec['parity_ok'], f'{spec.name}: kernel vs plain {rec["parity_max_err"]} '
                                f'(tol {rec["parity_tol"]}), '
                                f'{rec.get("error_over_bound", 0.0)} times its bound')
        check(rec['verdict'] == 'keep', f'{spec.name}: verdict {rec["verdict"]}: {rec["reason"]}')
        verdicts[spec.name] = rec
    return verdicts


def _sharp_case(B, H, N, D, valid, seed, dtype='bfloat16', qk_scale=2.0, v_scale=1.0):
    """q, k, v from a seeded generator with scores spread over several
    units (standard normal times ``qk_scale`` for q and k), and a key mask
    of ``valid`` keys per row."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    shape = (B, H, N, D)
    q, k, v = (torch.randn(shape, generator=g, device='cuda').mul_(a).to(getattr(torch, dtype))
               for a in (qk_scale, qk_scale, v_scale))
    mask = (torch.arange(N, device='cuda')[None, :] <
            torch.as_tensor(valid, device='cuda')[:, None]).view(B, 1, 1, N)
    return q, k, v, mask


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


def _sharp_excess(out, oracle, dtype):
    """The largest ratio of the error to its per-element bound: p and the
    output rounded to a type with 2^-bits relative precision allow 2^-bits
    (softmax-weighted |v| + |o|), and SHARP_SLACK covers ex2.approx and the
    fp32 sums."""
    o, pv_abs = oracle
    diff = (out.double() - o).abs()
    bound = 2.0 ** -SHARP_PRECISION_BITS[dtype] * (pv_abs + o.abs()) + SHARP_SLACK
    return float(diff.max()), float((diff / bound).max())


def _fully_masked_rows(tol: float):
    """A batch row whose keys are all masked, at ViT-B/16's N = 197 and at
    N = 37 (D 64), at so400m's D 72 (on the kernel's padded 80), and at
    Nq 1 over Nk 197 (the latent pool's shape), in bf16, fp16 and fp32 (B
    3, H 12; row 1 all masked, row 2 half): the kernel gives the TPU
    kernel's sum(v) / round_up(Nk, block_k), within ``tol`` (1e-5 in fp32)
    of the plain version, which gives the same, on every row."""
    import torch
    from timm_tpu_torch.kernels import flash_attention, flash_attention_reference, tpu_key_slots
    out = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for nq, n, d in ((37, 37, 64), (197, 197, 64), (37, 37, 72), (1, 197, 72)):
            g = torch.Generator(device='cuda').manual_seed(n + d)
            q = torch.randn(3, 12, nq, d, generator=g, device='cuda').to(dtype)
            k, v = (torch.randn(3, 12, n, d, generator=g, device='cuda').to(dtype)
                    for _ in range(2))
            v = v + 1  # a mean far from 0, so sum / slots and the mean differ
            mask = torch.ones(3, n, dtype=torch.bool, device='cuda')
            mask[1] = False
            mask[2, n // 2:] = False
            with torch.inference_mode():
                got = flash_attention(q, k, v, mask=mask).float()
                plain = flash_attention_reference(q, k, v, mask=mask.view(3, 1, 1, n)).float()
            want = v[1].float().sum(dim=-2, keepdim=True) / tpu_key_slots(n)
            name = str(dtype).replace('torch.', '') + ('' if nq == n else f'_nq{nq}')
            name = f'{name}_n{n}' + ('' if d == 64 else f'_d{d}')
            out[name] = {
                'max_abs_err_vs_plain': float((got - plain).abs().max()),
                'masked_row_max_abs_err_vs_tpu_value': float((got[1] - want).abs().max()),
                'slots': tpu_key_slots(n)}
            t = 1e-5 if dtype == torch.float32 else tol
            check(all(e <= t for e in list(out[name].values())[:2]),
                  f'fully masked row, {name}: {out[name]} (tol {t})')
    return out


def phase_flash_checks(previous_lib):
    """What the harness does not hold the flash kernel to: the sharp-score
    case (score std 4, the running max changes from key tile to key tile)
    against its fp64 oracle, and the previous design
    (``kernels/csrc/previous/``) at every registered case, against the
    plain version and timed the same way as the kernel."""
    import torch
    from timm_tpu_torch.kernels import flash_attention, flash_attention_reference, harness, registry
    spec = registry.get('flash_attention')
    tol = spec.parity_tol
    q, k, v, mask = _sharp_case(64, 12, 197, 64, [197 - 3 * i for i in range(64)], 5)
    with torch.inference_mode():
        out = flash_attention(q, k, v, mask=mask)
        scale = torch.tensor(64 ** -0.5, dtype=q.dtype).item()
        previous_out = _previous_flash(previous_lib, q, k, v, mask, scale)
        oracle = _fp64_oracle(q, k, v, mask)
        torch.cuda.synchronize()
    sharp_err, sharp_excess = _sharp_excess(out, oracle, 'bfloat16')
    previous_sharp_err, previous_sharp_excess = _sharp_excess(previous_out, oracle, 'bfloat16')
    del q, k, v, mask, out, previous_out, oracle
    masked_rows = _fully_masked_rows(tol)
    rows = []
    for case in spec.cases:
        if case.live.get('head_dim', 64) not in PREVIOUS_FLASH_HEAD_DIMS or 'seq_k' in case.live:
            continue  # the previous design takes these head dims and Nq == Nk only
        inputs = spec.make_inputs(seed=0, device='cuda', **case.live)
        q, k, v, mask = inputs['q'], inputs['k'], inputs['v'], inputs['mask']
        scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype).item()
        with torch.inference_mode():
            plain = flash_attention_reference(q, k, v, mask=mask)
            diff = (_previous_flash(previous_lib, q, k, v, mask, scale).double()
                    - plain.double()).abs()
            err = float(diff.max())
            over = float((diff / spec.error_bound(plain, **inputs).double()).max())
            rows.append({'case': case.name, 'previous_max_abs_err': err,
                         'previous_error_over_bound': over,
                         'previous_ms': harness.graph_ms(
                             lambda: _previous_flash(previous_lib, q, k, v, mask, scale)),
                         'previous_call_ms': harness.time_ms(
                             lambda: _previous_flash(previous_lib, q, k, v, mask, scale))})
        check(err <= tol and over <= 1.0,
              f'{case.name}: previous flash kernel vs plain {err} (tol {tol}), {over} times '
              f'its bound')
        del inputs, q, k, v, mask, plain, diff
    row = {'phase': 'kernels', 'kernel': 'flash_attention', 'check': 'sharp and previous',
           'sharp_case': 'vit_b16_bucket64_sharp', 'sharp_max_abs_err': sharp_err,
           'sharp_error_over_bound': sharp_excess,
           'sharp_tol': f'2^-{SHARP_PRECISION_BITS["bfloat16"]} (softmax-weighted |v| + |o|) '
                        f'+ {SHARP_SLACK} per element',
           'previous_sharp_error_over_bound': previous_sharp_excess,
           'previous_sharp_max_abs_err': previous_sharp_err, 'previous': rows,
           'fully_masked_rows': masked_rows}
    emit(row)
    check(sharp_excess <= 1.0, f'sharp case: kernel error {sharp_excess} times its fp64 bound')
    check(previous_sharp_excess <= 1.0,
          f'sharp case: previous kernel error {previous_sharp_excess} times its fp64 bound')
    torch.cuda.empty_cache()
    return row


def phase_fused_adamw_checks():
    """What the harness does not hold the fused AdamW + EMA kernel to, on
    ViT-B/16's real leaf set and weight-decay mask (the optimizer's flat
    layout): 3 updates from one state with a clip factor, fp32 and bf16 m,
    m and v held relative to their largest magnitude (a bf16 m within one
    bf16 ulp); a NaN step must change nothing."""
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
    # lr and the EMA decay read from device memory, changed every step
    lr_t, decay_t = torch.zeros((), device='cuda'), torch.zeros((), device='cuda')
    kw = dict(lr=lr_t, ema_decay=decay_t, n_decay=n_decay, grad_scale=scale, **ADAMW_HP)
    rows = []
    for mu in (torch.float32, torch.bfloat16):
        state = {side: [p0.clone(), m0.to(mu, copy=True), v0.clone(), p0.clone(),
                        torch.zeros((), dtype=torch.int32, device='cuda')]
                 for side in ('kernel', 'plain')}
        for step in range(3):
            lr_t.fill_((1e-3, 3e-4, 2e-3)[step])
            decay_t.fill_((0.0, 0.9, 0.9998)[step])
            kp, km, kv, ke, kc = state['kernel']
            fused_adamw(kp, grads[step], km, kv, ke, kc, **kw)
            rp, rm, rv, re, rc = state['plain']
            fused_adamw_reference(rp, grads[step], rm, rv, re, rc, **kw)
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
        rows.append({'mu_dtype': str(mu).replace('torch.', ''), 'n': n, 'n_decay': n_decay,
                     'max_abs_err': errs, 'tol': tols, 'max_abs': scale_of,
                     'm_within_one_ulp_or_tol': m_ok,
                     'nan_step_bit_identical': nan_step_kept, 'count_after': int(k[4])})
        for name in ('p', 'v', 'ema'):
            check(errs[name] <= tols[name],
                  f'fused_adamw {mu}: {name} max abs err {errs[name]} > {tols[name]}')
        check(m_ok, f'fused_adamw {mu}: m off by more than its tolerance ({errs["m"]})')
        check(nan_step_kept, f'fused_adamw {mu}: a NaN step changed the state')
        del state, k, r, keep
    emit({'phase': 'kernels', 'kernel': 'fused_adamw',
          'check': '3 clipped steps, lr and EMA decay from device memory, and a NaN step',
          'cases': rows})
    del model, opt, p0, grads, m0, v0
    torch.cuda.empty_cache()
    return rows


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


def phase_augment_checks(previous_lib):
    """What the harness does not hold the augment epilogue to: bf16 output
    at the two edge shapes, within one bf16 ulp of the plain value (at
    least 1e-6 where the blend cancels to near zero), and the previous
    design (``kernels/csrc/previous/``) at every registered case and the
    bf16 ones, against the plain version and timed the same way as the
    kernel."""
    import torch
    from timm_tpu_torch.kernels import augment_epilogue, augment_epilogue_reference, harness, registry
    spec = registry.get('augment_epilogue')
    runs = [(case.name, case.live, case.statics, torch.float32) for case in spec.cases]
    runs += [(case.name + '_bf16', case.live, case.statics, torch.bfloat16)
             for case in spec.cases if case.name.startswith('edge')]
    rows = []
    for name, live, statics, dt in runs:
        args = spec.make_inputs(seed=0, device='cuda', **live)
        kw = dict(statics, out_dtype=dt)
        ref = augment_epilogue_reference(**args, **kw)
        previous_out = _previous_augment(previous_lib, *args.values(), **kw)
        row = {'case': name, 'out_dtype': str(dt).replace('torch.', '')}
        if dt == torch.bfloat16:
            out = augment_epilogue(**args, **kw)
            torch.cuda.synchronize()
            row.update(max_abs_err=float((out.float() - ref.float()).abs().max()),
                       within_one_ulp=_within_one_ulp(out, ref, 7, AUGMENT_TOL),
                       bit_identical=bool(torch.equal(out, ref)),
                       finite=bool(torch.isfinite(out).all()),
                       previous_within_tol=_within_one_ulp(previous_out, ref, 7, AUGMENT_TOL))
            check(row['within_one_ulp'], f'{name}: kernel vs plain outside one bf16 ulp')
            check(row['finite'], f'{name}: non-finite kernel output')
            del out
        else:
            row['previous_within_tol'] = bool(torch.equal(previous_out, ref))
        row.update(previous_ms=harness.graph_ms(
                       lambda: _previous_augment(previous_lib, *args.values(), **kw)),
                   previous_call_ms=harness.time_ms(
                       lambda: _previous_augment(previous_lib, *args.values(), **kw)))
        check(row['previous_within_tol'], f'{name}: previous kernel vs plain outside the tolerance')
        rows.append(row)
        del args, ref, previous_out
    emit({'phase': 'kernels', 'kernel': 'augment_epilogue', 'check': 'bf16 out and previous',
          'tol_bf16': 'one bf16 ulp, at least 1e-6', 'cases': rows})
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


def _serve_bursts(engine, images):
    """SERVE_BURSTS through the engine, each burst awaited before the next:
    the futures, their submit times and the wall seconds."""
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
    return futures, submitted, time.perf_counter() - t0


def phase_serve():
    """The port's main path: an InferenceEngine on the card serving ViT-B/16
    in bf16, one CUDA graph per bucket captured at add_model. The flash
    wrapper's count is zeroed before the engine is built and read after it
    shut down: it holds the prewarm's launches (warm-up forwards and one
    capture per bucket) and must not move while serving, since a replay
    runs no Python and no bucket may run eagerly. The requests are served
    twice: under torch.profiler, whose trace must show depth flash kernels
    for each replay the engine counted, then without it, for latency and
    throughput. Then each bucket's replay is held bit for bit against an
    eager forward of the same batch, and each bucket's replay, profiled as
    marked-off calls (``_profile_kernels``), must run depth flash kernels a
    call; the whole run's profiled total is reported and decides nothing
    (the profiler loses single records in a long process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from timm_tpu_torch import InferenceEngine
    from timm_tpu_torch.kernels import flash_attention
    n = sum(SERVE_BURSTS)
    images = _images(n, seed=1)
    flash_attention.launches = 0
    engine = InferenceEngine(buckets=SERVE_BUCKETS, max_wait_ms=5.0, device='cuda')
    engine.add_model('vit_base_patch16_224', dtype=torch.bfloat16, seed=0)
    prewarm_launches = flash_attention.launches
    engine.start()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _serve_bursts(engine, images)
        torch.cuda.synchronize()
    profiled = engine.snapshot_stats()['replays_by_bucket']
    futures, submitted, wall = _serve_bursts(engine, images)
    engine.shutdown(drain=True)
    launches = flash_attention.launches
    stats = engine.snapshot_stats()
    device_flash = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                       and 'flash_fwd_kernel' in e.name)
    del prof
    served = np.stack([f.result() for f in futures])
    lat_ms = np.array([(f.done_at - s) * 1e3 for f, s in zip(futures, submitted)])

    res = engine.pool.acquire('vit_base_patch16_224')
    model, graphs = res.model, engine.aot_executables('vit_base_patch16_224')
    with torch.inference_mode():
        direct = np.concatenate([
            model(torch.from_numpy(images[j:j + 8]).cuda()).float().cpu().numpy()
            for j in range(0, n, 8)])
        replay_equal, flash_per_replay = {}, {}
        for b in SERVE_BUCKETS:
            x = torch.from_numpy(_images(b, seed=10 + b))
            replayed = graphs[b].run(x.pin_memory())
            eager = model(x.cuda()).float()
            replay_equal[str(b)] = bool(torch.equal(replayed, eager))
            _, counts, _ = _profile_kernels(graphs[b].graph.replay, 3)
            flash_per_replay[str(b)] = sum(c for k, c in counts.items() if 'flash_fwd_kernel' in k)
    errs = [rel_l2(served[j], direct[j]) for j in range(n)]
    depth = len(model.blocks)
    prewarm = stats['prewarm']['vit_base_patch16_224']
    emit({'phase': 'serve', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
          'requests': 2 * n, 'completed': stats['completed'], 'failed': stats['failed'],
          'steps': stats['steps'], 'steps_by_bucket': stats['steps_by_bucket'],
          'replays_by_bucket': stats['replays_by_bucket'],
          # the second, unprofiled serving of the n requests
          'p50_ms': float(np.percentile(lat_ms, 50)), 'p99_ms': float(np.percentile(lat_ms, 99)),
          'img_per_s': n / wall, 'wall_s': wall,
          'flash_launches': launches, 'flash_launches_at_prewarm': prewarm_launches,
          'profiled_replays_by_bucket': profiled, 'profiled_flash_kernels': device_flash,
          'flash_kernels_per_replay_by_bucket': flash_per_replay,
          'max_rel_l2_vs_direct': max(errs), 'tol': SERVE_REL_L2_TOL,
          'prewarm_ms': prewarm['ms'], 'prewarm': prewarm,
          'graph_launches': {str(b): g.launches for b, g in graphs.items()},
          'replay_equals_eager_bit_for_bit': replay_equal})
    check(stats['completed'] == 2 * n and stats['failed'] == 0,
          f'serve: {stats["failed"]} failed requests')
    check(set(stats['steps_by_bucket']) == set(SERVE_BUCKETS),
          f'serve: buckets dispatched {stats["steps_by_bucket"]}, expected all of {SERVE_BUCKETS}')
    check(stats['replays_by_bucket'] == stats['steps_by_bucket'],
          f'serve: replays {stats["replays_by_bucket"]} for steps {stats["steps_by_bucket"]}')
    check(prewarm['mode'] == 'graph' and prewarm['programs'] == len(SERVE_BUCKETS),
          f'serve: prewarm captured {prewarm["programs"]} graphs ({prewarm["mode"]})')
    check(all(g.launches == {'flash_attention': depth} for g in graphs.values()),
          f'serve: graphs captured {[g.launches for g in graphs.values()]} launches')
    check(all(np.isfinite(served).ravel()), 'serve: non-finite logits')
    check(max(errs) <= SERVE_REL_L2_TOL, f'serve: max rel L2 {max(errs)} > {SERVE_REL_L2_TOL}')
    check(prewarm_launches >= depth * len(SERVE_BUCKETS) and launches == prewarm_launches,
          f'serve: {prewarm_launches} flash launches at prewarm, {launches} after serving')
    check(all(v == depth for v in flash_per_replay.values()),
          f'serve: a replay ran {flash_per_replay} flash kernels by bucket, want {depth}')
    check(all(replay_equal.values()), f'serve: replay vs eager bit for bit: {replay_equal}')
    return launches, device_flash, engine


MARK = 'spin_kernel'    # torch.cuda._sleep's kernel: the mark between profiled calls


def _mark():
    """A kernel of its own name on the current stream, after a profiled call."""
    import torch
    torch.cuda._sleep(1)


def _calls(prof):
    """The profile's CUDA kernels: device ms by name over the whole
    profile, and the kernels of each call by name, the calls split at the
    marks (``_mark``; the kernels before the first mark or after the last
    form calls of their own)."""
    from torch.autograd import DeviceType
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not getattr(e, 'is_user_annotation', False)),
                    key=lambda e: e.time_range.start)
    ms, calls = {}, [{}]
    for e in events:
        if MARK in e.name:
            calls.append({})
            continue
        ms[e.name] = ms.get(e.name, 0.0) + e.device_time_total / 1e3
        calls[-1][e.name] = calls[-1].get(e.name, 0) + 1
    return ms, calls


def _max_per_call(prof):
    """The most of each kernel by name that any one call ran. A lost
    record only lowers one call's count, so the maximum stands."""
    _, calls = _calls(prof)
    return {name: max(c.get(name, 0) for c in calls) for c0 in calls for name in c0}


def _kernels_by_call(prof, reps: int):
    """Device time by kernel name per call, and the kernels one call ran by
    name, from a profile of ``reps`` calls each followed by ``_mark()``.

    The profiler loses kernel records: the first of a session, and a few
    more late in a long process (on the card: fractional kernels per graph
    replay in most phases, one depthwise kernel short of a ConvNeXt-B
    replay). A lost record only lowers a call's count, and the calls
    profiled here run the same kernels each time, so a kernel's count is
    the most any call showed.
    If a mark itself was lost, the calls cannot be told apart and the counts
    are the mean over the calls."""
    ms, calls = _calls(prof)
    kernels = {name: t / reps for name, t in ms.items()}
    if len(calls) == reps + 1 and not calls[-1]:
        return kernels, {name: max(c.get(name, 0) for c in calls) for name in kernels}
    totals = {}
    for c in calls:
        for name, n in c.items():
            totals[name] = totals.get(name, 0) + n
    return kernels, {name: n / reps for name, n in totals.items()}


def _profile_kernels(fn, reps: int, attempts: int = 3):
    """Device time by kernel name per call over ``reps`` calls of ``fn``
    under torch.profiler, the kernels one call ran by name (see
    ``_kernels_by_call``), and the host wall time per call. A profile that
    lost one of its marks cannot be split into its calls: it is taken
    again, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
                _mark()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        _, calls = _calls(prof)
        if len(calls) == reps + 1 and not calls[-1]:
            break
    kernels, per_call = _kernels_by_call(prof, reps)
    return kernels, per_call, wall_ms


def phase_breakdown(engine):
    """Where the time of the served model goes: per bucket, an eager forward
    against a replay of its graph (CUDA events), and under torch.profiler
    the device time of an eager bucket-64 forward by kernel, with the
    device's idle share of the host wall time, and of a replayed one, which
    must still run 12 flash kernels."""
    import torch
    from timm_tpu_torch.kernels.harness import time_ms
    res = engine.pool.acquire('vit_base_patch16_224')
    model, graphs = res.model, engine.aot_executables('vit_base_patch16_224')
    per_bucket = {}
    with torch.inference_mode():
        for b in SERVE_BUCKETS:
            x = torch.from_numpy(_images(b, seed=2)).cuda()
            graphs[b].static_in.copy_(x)
            eager_ms = time_ms(lambda: model(x), iters=10, warmup=2)
            replay_ms = time_ms(graphs[b].graph.replay, iters=10, warmup=2)
            per_bucket[str(b)] = {'forward_ms': eager_ms, 'replay_ms': replay_ms,
                                  'img_per_s': b / eager_ms * 1e3,
                                  'replay_img_per_s': b / replay_ms * 1e3}
        x = torch.from_numpy(_images(64, seed=3)).cuda()
        model(x)
        torch.cuda.synchronize()
        reps = 3
        kernels, _, wall_ms = _profile_kernels(lambda: model(x), reps)
        graphs[64].static_in.copy_(x)
        replay_kernels, replay_counts, replay_wall_ms = _profile_kernels(graphs[64].graph.replay, reps)
    busy = sum(kernels.values())
    flash = sum(v for k, v in kernels.items() if 'flash_fwd_kernel' in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    replay_busy = sum(replay_kernels.values())
    replay_flash = sum(c for k, c in replay_counts.items() if 'flash_fwd_kernel' in k)
    emit({'phase': 'breakdown', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
          'per_bucket': per_bucket, 'profiled_batch': 64,
          'wall_ms_per_forward': wall_ms,
          # no device events means the profiler could not trace the card here
          'device_ms_per_forward': busy if kernels else 'not measured',
          'idle_share': 1.0 - busy / wall_ms if kernels else 'not measured',
          'flash_share_of_device': flash / busy if kernels else 'not measured',
          'top_kernels': [{'kernel': k[:120], 'ms': v} for k, v in top],
          'replay_wall_ms': replay_wall_ms,
          'replay_device_ms': replay_busy if replay_kernels else 'not measured',
          'replay_idle_share': 1.0 - replay_busy / replay_wall_ms if replay_kernels else 'not measured',
          'replay_kernels_per_forward': sum(replay_counts.values()) if replay_kernels
          else 'not measured',
          'replay_flash_kernels_per_forward': replay_flash if replay_kernels else 'not measured'})
    check(not replay_kernels or replay_flash == len(model.blocks),
          f'breakdown: a replayed bucket-64 forward ran {replay_flash} flash kernels')


def _train_task(seed: int, device, dtype, drop_path_rate: float, opt: str = 'adamw',
                model_name: str = 'vit_base_patch16_224', opt_kw=None, model_kw=None,
                weight_decay: float = 0.05, split_bn: int = 0, lr: float = TRAIN_LR, model=None,
                **task_kw):
    """A ClassificationTask on a new model (or on ``model``, as it is)."""
    import timm_tpu_torch
    from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
    if model is None:
        model = timm_tpu_torch.create_model(model_name, dtype=dtype, seed=seed,
                                            drop_path_rate=drop_path_rate, device=device,
                                            **(model_kw or {}))
        if model_name.startswith('convnext'):
            _lift_from_init(model)
        if model_name == EFFNET:
            _damp_residual_branches(model)
        if model_name == RESNET:
            _damp_resnet(model)
    if split_bn:
        from timm_tpu_torch.layers import convert_splitbn_model
        convert_splitbn_model(model, split_bn)
    opt = timm_tpu_torch.create_optimizer_v2(model, opt=opt, lr=lr, weight_decay=weight_decay,
                                             **({'momentum': 0.9} if opt == 'sgd' else {}),
                                             **(opt_kw or {}))
    return timm_tpu_torch.ClassificationTask(
        model, optimizer=opt, train_loss_fn=LabelSmoothingCrossEntropy(0.1), seed=seed, **task_kw)


def _train_batch(n: int, seed: int, device, size: int = 224):
    import torch
    labels = np.random.default_rng(seed).integers(0, 1000, n)
    return {'input': torch.from_numpy(_images(n, size=size, seed=seed)).to(device),
            'target': torch.from_numpy(labels).to(device)}


def _per_step(counts, steps: int = 1):
    """Kernels a step ran, by the three kernels' names, from the profiler's
    counts over ``steps`` steps."""
    names = {'flash_attention': 'flash_fwd_kernel', 'fused_adamw': 'fused_adamw_kernel',
             'augment_epilogue': 'augment_epilogue_kernel'}
    return {k: sum(c for name, c in counts.items() if pat in name) / steps
            for k, pat in names.items()}


def phase_train():
    """The port's training path: ClassificationTask trains ViT-B/16 (bf16
    compute, fp32 parameters) with AdamW, the weight-decay mask, clipping,
    EMA, a cosine schedule with warmup and the non-finite guard, 20 steps on
    one fixed batch: step 1 runs the step body eagerly (the warm-up), step 2
    captures it, steps 3-20 replay its graph. The wrappers' launch counts
    are read around this run (they move at the warm-up and the capture
    only); then the profiler counts what 3 more replayed steps ran."""
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
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    reps = 3
    kernels, counts, prof_wall_ms = _profile_kernels(
        lambda: task.train_step(batch, lr=1e-5, step=TRAIN_STEPS + 1), reps)
    replayed = _per_step(counts)
    busy = sum(kernels.values())
    losses = [float(m['loss']) for m in metrics]
    last = metrics[-1]
    emit({'phase': 'train', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
          'batch': TRAIN_BATCH, 'steps': TRAIN_STEPS, 'drop_path_rate': 0.1,
          'losses': losses, 'grad_norms': [float(m['grad_norm']) for m in metrics], 'lrs': lrs,
          'step_ms': step_ms, 'img_per_s': TRAIN_BATCH / step_ms * 1e3, 'wall_s': wall,
          'peak_memory_gb': peak_gb,
          'graph_pool_bytes': task.train_graphs.pool_bytes(),
          'graph_static_input_bytes': task.train_graphs.static_bytes(),
          'captures': task.train_graphs.captures, 'replays': task.train_graphs.replays,
          'nonfinite_count': int(last['nonfinite_count']),
          'nonfinite_total': int(last['nonfinite_total']),
          'optimizer_count': int(task.optimizer.count),
          # the wrappers count at the warm-up and the capture; a replay runs no Python
          'wrapper_flash_launches_per_step': flash_steps,
          'wrapper_fused_adamw_launches_per_step': adamw_steps, 'launches': launches,
          'profiled_replays': reps, 'replayed_kernels_per_step': replayed if kernels else
          'not measured', 'replay_wall_ms_per_step': prof_wall_ms,
          'replay_device_ms_per_step': busy if kernels else 'not measured',
          'replay_idle_share': 1.0 - busy / prof_wall_ms if kernels else 'not measured'})
    check(all(np.isfinite(losses)), f'train: non-finite loss in {losses}')
    check(losses[-1] < losses[0], f'train: last loss {losses[-1]} not below first {losses[0]}')
    check(adamw_steps == [1, 1] + [0] * (TRAIN_STEPS - 2),
          f'train: fused_adamw wrapper launches per step {adamw_steps}')
    check(flash_steps == [depth, depth] + [0] * (TRAIN_STEPS - 2),
          f'train: flash wrapper launches per step {flash_steps}')
    check(task.train_graphs.captures == 1, 'train: the step was not captured once')
    check(bool(kernels), 'train: the profiler saw no kernel of the replayed steps')
    check(replayed['flash_attention'] == depth and replayed['fused_adamw'] == 1,
          f'train: a replayed step ran {replayed}')
    check(int(last['nonfinite_total']) == 0 and int(task.optimizer.count) == TRAIN_STEPS + reps,
          'train: the guard skipped a step')
    return launches, task, batch, step_ms


def _write_image_folder(root: str, per_class: int, seed: int = 0, sides=(256, 320)):
    """A folder of class folders of seeded RGB PNGs, ``sides`` (256-320) px
    a side: smooth random colour fields with pixel noise, written in
    parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    rng = np.random.default_rng(seed)
    jobs = []
    for c in range(3):
        os.makedirs(os.path.join(root, f'class{c}'))
        for i in range(per_class):
            h, w = (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
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


_IMAGE_DATA = {}


def _image_data() -> str:
    """The image phases' folder of seeded 256-320 px PNGs: train/ (3 x
    INPUT_IMAGES_PER_CLASS, seed 0) and validation/ (3 x
    DRIVER_VALIDATION_PER_CLASS, seed 1), written once into a temp dir that
    main removes; the phases only read it."""
    import tempfile
    if 'root' not in _IMAGE_DATA:
        root = tempfile.mkdtemp(prefix='chip_smoke_images_')
        _IMAGE_DATA['root'] = root
        t0 = time.perf_counter()
        _IMAGE_DATA['train'] = _write_image_folder(os.path.join(root, 'train'),
                                                   INPUT_IMAGES_PER_CLASS)
        _IMAGE_DATA['validation'] = _write_image_folder(
            os.path.join(root, 'validation'), DRIVER_VALIDATION_PER_CLASS, seed=1)
        _IMAGE_DATA['write_s'] = time.perf_counter() - t0
    return _IMAGE_DATA['root']


def _input_loader(root, data_config, device, seed=0, num_workers=INPUT_WORKERS, no_aug=False,
                  auto_augment=None, re_mode='const'):
    """The recipe's loader: create_dataset over the folder, create_loader
    with device_augment (erasing 0.25 ``re_mode``, Mixup 0.8 / CutMix 1.0
    with label smoothing 0.1, ``auto_augment`` in place of colour jitter)
    and device_prefetch 2."""
    import torch
    from timm_tpu_torch.data import Mixup, create_loader
    from timm_tpu_torch.data.dataset_factory import create_dataset
    mixup = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, num_classes=1000,
                  seed=seed)
    return create_loader(
        create_dataset('', root, split='train'), data_config['input_size'], TRAIN_BATCH,
        is_training=True, no_aug=no_aug, re_prob=0.25, re_mode=re_mode, auto_augment=auto_augment,
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


def _host_ms_per_image(root, data_config, n: int = 64, auto_augment=None):
    """Host time per image of each stage of the train transform, one thread:
    decode (the dataset with no transform), then each transform in turn."""
    import random

    from timm_tpu_torch.data.dataset_factory import create_dataset
    from timm_tpu_torch.data.transforms_factory import create_transform
    ds = create_dataset('', root, split='train')
    tf = create_transform(data_config['input_size'], is_training=True,
                          interpolation=data_config['interpolation'], mean=data_config['mean'],
                          std=data_config['std'], output_dtype=np.uint8, auto_augment=auto_augment)
    random.seed(0)
    np.random.seed(0)
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


def _in_epoch_rate(steps, per_epoch):
    """Images a second over the in-epoch steps from update 3 on, and the
    medians of their two parts: ``steps`` holds (wait_ms, step_ms) of each
    update, the host time before its train_step (the loader's wait, loop
    work) and the train_step itself, which ends in the guard's read-back.
    A step that fetches an epoch's first batch (pipeline restart, and in
    the train driver the epoch's evaluation and checkpoint) is left out;
    input_train and drivers take their in-epoch rates through this."""
    kept = [steps[i] for i in range(TRAIN_WARMUP_STEPS, len(steps)) if i % per_epoch]
    return {'img_per_s_in_epoch': TRAIN_BATCH * len(kept) / (sum(w + s for w, s in kept) / 1e3),
            'in_epoch_wait_ms_median': float(np.median([w for w, _ in kept])),
            'in_epoch_train_step_ms_median': float(np.median([s for _, s in kept]))}


def phase_input_train(train_step_ms: float):
    """The input path of training: ClassificationTask trains ViT-B/16 (bf16
    compute, fp32 params, SoftTargetCrossEntropy, the task's normalize off
    since the stage normalises) for 20 steps at batch 64 from a folder of
    seeded PNGs through create_dataset -> create_loader (threaded decode and
    transforms, DevicePrefetcher(size=2), DeviceAugmentStage with Mixup /
    CutMix and RandomErasing sampled on the host, the augment program with
    the augment-epilogue kernel); the train step and the augment program
    are graphs from step 2 on. The wrappers' launch counts are read around
    this run only. Then: a profiler breakdown over 3
    steps, which counts the kernels they ran, the input path's own rate over 2 epochs
    without training, and a card stage and a CPU stage over the same
    deterministic loader, which must agree."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import timm_tpu_torch
    from timm_tpu_torch.data import resolve_model_data_config
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    from timm_tpu_torch.loss import SoftTargetCrossEntropy
    with contextlib.nullcontext(os.path.join(_image_data(), 'train')) as root:
        n_images, write_s = _IMAGE_DATA['train'], _IMAGE_DATA['write_s']
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
                _mark()
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
        # flash and fused AdamW run in every step; the augment epilogue in
        # the steps whose batch the stage augmented, so its count is whether
        # a profiled step ran it
        kernels, counts = _kernels_by_call(prof, reps)
        busy = sum(kernels.values())
        epilogue = sum(v for k, v in kernels.items() if 'augment_epilogue_kernel' in k)
        replayed = _per_step(counts)

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
           **_in_epoch_rate([(w, s - w) for w, s in zip(wait_ms, step_wall_ms)], len(loader)),
           'loader_only_img_per_s': loader_img_per_s,
           'loader_only_wait_ms_per_batch': loader_wait_ms,
           'host_ms_per_image_one_thread': host_ms,
           'peak_memory_gb': peak_gb,
           # the wrappers' counts: at the warm-up and capture of the train
           # step's and the augment program's graphs only
           'wrapper_launches_per_step': per_step, 'launches': launches,
           'profiled_steps': reps, 'wall_ms_per_step_profiled': prof_wall_ms,
           'kernels_per_profiled_step': replayed if kernels else 'not measured',
           'device_ms_per_step': busy if kernels else 'not measured',
           'idle_share': 1.0 - busy / prof_wall_ms if kernels else 'not measured',
           'augment_epilogue_ms_per_step': epilogue if kernels else 'not measured',
           'augment_epilogue_share': epilogue / busy if kernels else 'not measured',
           'card_vs_cpu_stage_max_abs_err': stage_err, 'card_vs_cpu_stage_tol': AUGMENT_TOL,
           'nonfinite_total': int(metrics[-1]['nonfinite_total'])}
    emit(row)
    check(all(np.isfinite(losses)), f'input_train: non-finite loss in {losses}')
    graphed = [1, 1] + [0] * (TRAIN_STEPS - 2)
    check([p[2] for p in per_step] == graphed,
          f'input_train: augment_epilogue wrapper launches per step {[p[2] for p in per_step]}')
    check([p[1] for p in per_step] == graphed,
          f'input_train: fused_adamw wrapper launches per step {[p[1] for p in per_step]}')
    check([p[0] for p in per_step] == [depth * c for c in graphed],
          f'input_train: flash wrapper launches per step {[p[0] for p in per_step]}')
    # the stage augments a batch when the step asks for it: its replayed
    # epilogue kernels fall in the profiled window
    check(bool(kernels) and replayed['flash_attention'] == depth
          and replayed['fused_adamw'] == 1 and replayed['augment_epilogue'] > 0,
          f'input_train: a profiled step ran {replayed}')
    check(stage_err <= AUGMENT_TOL, f'input_train: card vs CPU stage max abs err {stage_err}')
    del task, model, opt, loader
    torch.cuda.empty_cache()
    return launches


# phase recipe_train: ViT-B/16's timm / DeiT recipe through the port's input
# path (RandAugment, 'pixel' erasing, Mixup / CutMix on the card), then an
# AugMix arm with the JSD loss on the host path
RECIPE_AA = 'rand-m9-mstd0.5-inc1'
RECIPE_ODD_BATCH = 37
# the augment program's replay checks: (epoch, step) keys of 4 calls on a
# batch A then a batch B three times (a warm-up, a capture, 2 replays)
RECIPE_KEYS = ((0, 0), (0, 1), (1, 2), (0, 1))
RECIPE_RESUME_STEPS = (5, 6, 7, 8)   # steps of epoch 1 regenerated as --resume auto does
RECIPE_STAT_TOL = 0.05               # erased pixels after normalization: mean 0, std 1
AUGMIX_AA, AUGMIX_SPLITS, AUGMIX_BATCH, AUGMIX_STEPS = 'augmix-m3-w3', 3, 32, 10


def _augment_batch(rng, n: int, erasing, mixup, with_fill: bool):
    """A uint8 batch of n seeded 224 px images and the parameters the
    recipe's samplers draw for it, as numpy arrays."""
    batch = {'image': rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
             'target': rng.integers(0, 1000, n)}
    batch.update(erasing.sample_params(batch['image'].shape))
    if not with_fill:
        batch.pop('erase_fill', None)
    batch.update(mixup.sample_params(batch['image'].shape))
    return batch


def _augment_replays_vs_eager(data_config):
    """Per erase mode and batch size (64, 37): the augment program through
    its graphs against the program run eagerly on the same inputs, bit for
    bit, with RECIPE_KEYS as (epoch, step) keys; in 'pixel' mode the replay
    of a new key must redraw the noise and a key drawn before must give it
    again."""
    import torch
    from timm_tpu_torch.data import DeviceAugment, Mixup, RandomErasing, noise_generator_seed
    out = {}
    for mode in ('const', 'rand', 'pixel'):
        augment = DeviceAugment(data_config['mean'], data_config['std'], re_mode=mode,
                                re_mean=data_config['mean'], re_std=data_config['std'],
                                num_classes=1000, smoothing=0.1, noise_seed=0, device='cuda')
        rng = np.random.default_rng(len(mode))
        erasing = RandomErasing(probability=0.5, mode='rand' if mode == 'rand' else 'const',
                                max_count=2, mean=data_config['mean'], std=data_config['std'],
                                seed=1)
        mixup = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, num_classes=1000,
                      seed=1)
        rows = {}
        for n in (TRAIN_BATCH, RECIPE_ODD_BATCH):
            a = _augment_batch(rng, n, erasing, mixup, mode == 'rand')
            b = _augment_batch(rng, n, erasing, mixup, mode == 'rand')
            batches = [a, b, b, b]
            got = [augment(batch, epoch=e, step=s) for batch, (e, s) in zip(batches, RECIPE_KEYS)]
            equal = []
            for batch, (e, s), (x, y) in zip(batches, RECIPE_KEYS, got):
                if augment.generator is not None:
                    augment.generator.manual_seed(noise_generator_seed(0, e, s))
                want_x, want_y = augment._program(
                    {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in batch.items()}, mode)
                equal.append(_bit_equal(x, want_x) and _bit_equal(y, want_y))
            rows[str(n)] = {'replay_equals_eager': equal,
                            'same_key_same_output': _bit_equal(got[1][0], got[3][0]),
                            'new_key_new_output': not _bit_equal(got[1][0], got[2][0])}
        out[mode] = {'batches': rows, 'captures': augment.graphs.captures,
                     'replays': augment.graphs.replays, 'pool_bytes': augment.graphs.pool_bytes()}
        del augment
    return out


def _erased_pixel_stats(data_config):
    """The 'pixel' program alone (no mixup) on a seeded batch of 64 with a
    box in every row: per-channel mean and std of the erased pixels after
    normalization, (re_mean + re_std N(0, 1) - mean) / std with re_mean and
    re_std the normalization's, so N(0, 1)."""
    import torch
    from timm_tpu_torch.data import DeviceAugment, RandomErasing
    augment = DeviceAugment(data_config['mean'], data_config['std'], re_mode='pixel',
                            re_mean=data_config['mean'], re_std=data_config['std'], noise_seed=0,
                            device='cuda')
    erasing = RandomErasing(probability=1.0, mode='pixel', mean=data_config['mean'],
                            std=data_config['std'], seed=2)
    image = np.random.default_rng(3).integers(0, 256, (TRAIN_BATCH, 224, 224, 3), dtype=np.uint8)
    batch = {'image': image, 'target': np.zeros(TRAIN_BATCH, np.int64),
             **erasing.sample_params(image.shape)}
    x, _ = augment(batch, epoch=0, step=0)
    mask = np.zeros(image.shape[:3], bool)
    for i, (top, left, eh, ew) in enumerate(batch['erase_box'][:, 0]):
        mask[i, top:top + eh, left:left + ew] = True
    erased = x[torch.from_numpy(mask).cuda()].double()
    return {'erased_pixels': int(mask.sum()), 'mean': erased.mean(0).tolist(),
            'std': erased.std(0).tolist()}


def _jsd_graph_vs_eager(batches, data_config):
    """ViT-B/16 (bf16, drop_path 0.1, clip 1.0, EMA 0.9998 with warmup, the
    task normalizing) with JsdCrossEntropy(3 splits, smoothing 0.1) from one
    state: AUGMIX_STEPS eager steps of the step body against as many
    ``train_step`` calls (a warm-up, a capture, replays) on the same AugMix
    batches, every metric, buffer and the drop generator's state compared
    with torch.equal; replayed step ms (CUDA events, steps 3-10)."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.layers.drop import get_drop_generator
    from timm_tpu_torch.loss import JsdCrossEntropy
    task = _train_task(0, 'cuda', torch.bfloat16, 0.1, clip_grad=1.0, mean=data_config['mean'],
                       std=data_config['std'])
    task.train_loss_fn = JsdCrossEntropy(num_splits=AUGMIX_SPLITS, smoothing=0.1)
    task.setup_ema(decay=0.9998, warmup=True)
    gen = get_drop_generator(task.model)
    sched, _ = timm_tpu_torch.create_scheduler_v2(
        TRAIN_LR, 'cosine', num_epochs=AUGMIX_STEPS, warmup_epochs=3, warmup_lr=1e-6)
    lrs = [sched.step(i)[0] for i in range(AUGMIX_STEPS)]
    on_card = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in batches]

    def eager_step(i):
        task.optimizer.set_hyperparams(lr=lrs[i], ema_decay=task.ema.get_decay(i + 1))
        task.model.train()
        metrics = {k: v.clone() for k, v in task._train_body(on_card[i]).items()}
        task.sentinel.observe(task._sentinel_state, step=i + 1)
        return metrics

    def graph_step(i):
        return task.train_step(batches[i], lr=lrs[i], step=i + 1)

    start_state = [t.clone() for t in _train_state(task)], gen.get_state()
    runs = {}
    for mode, fn in (('eager', eager_step), ('graph', graph_step)):
        for t, v in zip(_train_state(task), start_state[0]):
            t.copy_(v)
        gen.set_state(start_state[1])
        task.sentinel.reset()
        task.sentinel.total = 0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        metrics = []
        for i in range(AUGMIX_STEPS):
            if i == TRAIN_WARMUP_STEPS:
                start.record()
            metrics.append(fn(i))
        end.record()
        torch.cuda.synchronize()
        runs[mode] = {'metrics': metrics, 'state': [t.clone() for t in _train_state(task)],
                      'gen': gen.get_state(),
                      'step_ms': start.elapsed_time(end) / (AUGMIX_STEPS - TRAIN_WARMUP_STEPS)}
    e, g = runs['eager'], runs['graph']
    names = ['params', 'count', 'lr', 'ema_decay', 'sentinel'] + list(task.optimizer.slots()) + [
        'ema'] + list(_model_buffers(task))
    differ = [n for n, a, b in zip(names, e['state'], g['state']) if not _bit_equal(a, b)]
    if not torch.equal(e['gen'], g['gen']):
        differ.append('drop_generator')
    row = {'loss': 'JsdCrossEntropy(num_splits=3, smoothing=0.1)',
           'losses': [float(m['loss']) for m in g['metrics']],
           'grad_norms': [float(m['grad_norm']) for m in g['metrics']],
           'buffers_that_differ': differ,
           'steps_whose_metrics_differ': [
               i + 1 for i, (a, b) in enumerate(zip(e['metrics'], g['metrics']))
               if a.keys() != b.keys() or not all(_bit_equal(a[k], b[k]) for k in a)],
           'eager_step_ms': e['step_ms'], 'replay_step_ms': g['step_ms'],
           'replay_img_per_s': AUGMIX_BATCH * AUGMIX_SPLITS / g['step_ms'] * 1e3,
           'captures': task.train_graphs.captures, 'replays': task.train_graphs.replays,
           'graph_pool_bytes': task.train_graphs.pool_bytes(),
           'peak_memory_gb': torch.cuda.max_memory_allocated() / 2 ** 30}
    del task
    return row


def phase_recipe_train():
    """ViT-B/16's training recipe in timm and DeiT through the port: the
    task of phase input_train (bf16 compute, fp32 params, AdamW, clip 1.0,
    EMA, SoftTargetCrossEntropy) for 20 steps at batch 64 from the folder
    of seeded PNGs through create_loader with RandAugment
    ('rand-m9-mstd0.5-inc1'), erasing 0.25 in 'pixel' mode and Mixup 0.8 /
    CutMix 1.0 on the card (the augment program's graph: the torch program,
    no augment-epilogue kernel), the train step a graph from step 2. Then:
    the loader's rate alone and host ms per image with and without
    RandAugment; the augment program's replays against its eager run for
    'const', 'rand' and 'pixel' at batch 64 and 37; the erased pixels'
    statistics; epoch 1's steps 5-8 regenerated by a fresh loader as
    ``--resume auto`` regenerates them, against this run's. Last, an AugMix
    arm on the host path: 'augmix-m3-w3' in 3 splits of 32 images (96 a
    step), JsdCrossEntropy, 10 graphed steps against the eager body."""
    import torch

    import timm_tpu_torch
    from timm_tpu_torch.data import create_loader, resolve_model_data_config
    from timm_tpu_torch.data.dataset import AugMixDataset
    from timm_tpu_torch.data.dataset_factory import create_dataset
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    from timm_tpu_torch.loss import SoftTargetCrossEntropy
    kernels = (flash_attention, fused_adamw, augment_epilogue)
    t_phase = time.perf_counter()
    with contextlib.nullcontext(os.path.join(_image_data(), 'train')) as root:
        n_images = _IMAGE_DATA['train']
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
        loader = _input_loader(root, data_config, 'cuda', auto_augment=RECIPE_AA, re_mode='pixel')
        per_epoch = len(loader)
        depth = len(model.blocks)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        batches = _batches(loader)
        for k in kernels:
            k.launches = 0
        metrics, wait_ms, step_wall_ms, per_step, kept = [], [], [], [], {}
        for step in range(TRAIN_STEPS):
            if step == TRAIN_WARMUP_STEPS:
                start.record()
            counts = [k.launches for k in kernels]
            tw = time.perf_counter()
            x, y = next(batches)
            wait_ms.append((time.perf_counter() - tw) * 1e3)
            if step - per_epoch in RECIPE_RESUME_STEPS:
                kept[step - per_epoch] = (x.clone(), y.clone())
            metrics.append(task.train_step({'input': x, 'target': y},
                                           lr=sched.step(step)[0], step=step + 1))
            step_wall_ms.append((time.perf_counter() - tw) * 1e3)
            per_step.append([k.launches - c for k, c in zip(kernels, counts)])
            del x, y
        end.record()
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        step_ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP_STEPS)
        losses = [float(m['loss']) for m in metrics]
        graphs = loader.augment.graphs
        augment_graphs = {'route': loader.augment.route, 'captures': graphs.captures,
                          'replays': graphs.replays, 'pool_bytes': graphs.pool_bytes(),
                          'static_input_bytes': graphs.static_bytes()}
        batches.close()
        train_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        del task, model, opt
        torch.cuda.empty_cache()

        # epoch 1's steps 5-8 as `--resume auto` regenerates them: a fresh
        # loader, set_epoch(1), every batch from the first augmented and the
        # consumed ones dropped (train_one_epoch's skip)
        fresh = _input_loader(root, data_config, 'cuda', auto_augment=RECIPE_AA, re_mode='pixel')
        fresh.set_epoch(1)
        resumed = {}
        it = iter(fresh)
        for step, (x, y) in enumerate(it):
            if step in RECIPE_RESUME_STEPS:
                resumed[step] = (x, y)
            if step == max(RECIPE_RESUME_STEPS):
                break
        it.close()
        resume_equal = {str(s): _bit_equal(kept[s][0], resumed[s][0])
                        and _bit_equal(kept[s][1], resumed[s][1]) for s in RECIPE_RESUME_STEPS}
        del kept, resumed, fresh

        # the input path alone, no training: 2 epochs of a fresh loader
        loader_only = _batches(_input_loader(root, data_config, 'cuda', auto_augment=RECIPE_AA,
                                             re_mode='pixel'))
        tl = time.perf_counter()
        for _ in range(2 * per_epoch):
            next(loader_only)
        torch.cuda.synchronize()
        loader_img_per_s = 2 * per_epoch * TRAIN_BATCH / (time.perf_counter() - tl)
        loader_only.close()
        host_ms = {'randaugment': _host_ms_per_image(root, data_config, auto_augment=RECIPE_AA),
                   'colour_jitter': _host_ms_per_image(root, data_config)}

        replays = _augment_replays_vs_eager(data_config)
        stats = _erased_pixel_stats(data_config)

        # the AugMix arm: host-augmented split batches, JSD loss
        t_augmix = time.perf_counter()
        augmix_ds = AugMixDataset(create_dataset('', root, split='train'), num_splits=AUGMIX_SPLITS)
        augmix_loader = create_loader(
            augmix_ds, data_config['input_size'], AUGMIX_BATCH, is_training=True,
            auto_augment=AUGMIX_AA, num_aug_splits=AUGMIX_SPLITS,
            interpolation=data_config['interpolation'], mean=data_config['mean'],
            std=data_config['std'], num_workers=INPUT_WORKERS, seed=0)
        it = iter(augmix_loader)
        augmix_batches = [dict(zip(('input', 'target'), next(it))) for _ in range(AUGMIX_STEPS)]
        it.close()
        augmix_load_s = time.perf_counter() - t_augmix
        shapes_ok = all(b['input'].shape == (AUGMIX_BATCH * AUGMIX_SPLITS, 224, 224, 3)
                        and (b['target'][:AUGMIX_BATCH] == b['target'][AUGMIX_BATCH:2 * AUGMIX_BATCH]).all()
                        for b in augmix_batches)
        torch.cuda.reset_peak_memory_stats()
        augmix = _jsd_graph_vs_eager(augmix_batches, data_config)
        augmix.update(load_s=augmix_load_s, split_major_shapes=bool(shapes_ok),
                      aa=AUGMIX_AA, splits=AUGMIX_SPLITS, batch=AUGMIX_BATCH)
        del augmix_batches
        torch.cuda.empty_cache()
    row = {'phase': 'recipe_train', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
           'batch': TRAIN_BATCH, 'steps': TRAIN_STEPS, 'images': n_images,
           'batches_per_epoch': per_epoch, 'workers': INPUT_WORKERS,
           'recipe': {'auto_augment': RECIPE_AA, 're_prob': 0.25, 're_mode': 'pixel',
                      'mixup': 0.8, 'cutmix': 1.0, 'smoothing': 0.1},
           'losses': losses, 'grad_norms': [float(m['grad_norm']) for m in metrics],
           'step_ms': step_ms, 'img_per_s': TRAIN_BATCH / step_ms * 1e3,
           'input_wait_ms_per_step': wait_ms, 'step_wall_ms_per_step': step_wall_ms,
           **_in_epoch_rate([(w, s - w) for w, s in zip(wait_ms, step_wall_ms)], per_epoch),
           'loader_only_img_per_s': loader_img_per_s,
           'host_ms_per_image_one_thread': host_ms,
           'host_ms_per_image_total': {k: sum(v.values()) for k, v in host_ms.items()},
           'train_peak_memory_gb': train_peak_gb,
           # in 'pixel' mode the augment program is the torch program: the
           # augment-epilogue kernel does not run on this path
           'wrapper_launches_per_step': per_step, 'launches': launches,
           'augment_graphs': augment_graphs, 'augment_replays_vs_eager': replays,
           'erased_pixels_normalized': stats, 'erased_stat_tol': RECIPE_STAT_TOL,
           'resumed_steps_equal': resume_equal, 'augmix_jsd': augmix,
           'phase_s': time.perf_counter() - t_phase}
    emit(row)
    check(all(np.isfinite(losses)), f'recipe_train: non-finite loss in {losses}')
    graphed = [1, 1] + [0] * (TRAIN_STEPS - 2)
    check([p[0] for p in per_step] == [depth * c for c in graphed]
          and [p[1] for p in per_step] == graphed,
          f'recipe_train: flash / fused_adamw wrapper launches per step {per_step}')
    check([p[2] for p in per_step] == [0] * TRAIN_STEPS,
          f"recipe_train: augment_epilogue launched in 'pixel' mode: {per_step}")
    check(augment_graphs['captures'] == 1 and augment_graphs['replays'] >= TRAIN_STEPS - 1,
          f'recipe_train: augment graphs {augment_graphs}')
    for mode, r in replays.items():
        for n, b in r['batches'].items():
            check(all(b['replay_equals_eager']) and b['same_key_same_output']
                  and b['new_key_new_output'] == (mode == 'pixel'),
                  f'recipe_train: augment program {mode} at batch {n}: {b}')
    check(all(abs(m) <= RECIPE_STAT_TOL for m in stats['mean'])
          and all(abs(s - 1.0) <= RECIPE_STAT_TOL for s in stats['std']),
          f'recipe_train: erased pixels after normalization {stats}')
    check(all(resume_equal.values()), f'recipe_train: resumed batches differ {resume_equal}')
    check(augmix['split_major_shapes'], 'recipe_train: AugMix batches are not split-major')
    check(all(np.isfinite(augmix['losses'])), f'recipe_train: AugMix losses {augmix["losses"]}')
    check(not augmix['buffers_that_differ'] and not augmix['steps_whose_metrics_differ'],
          f'recipe_train: JSD replays differ from eager steps: {augmix["buffers_that_differ"]}, '
          f'steps {augmix["steps_whose_metrics_differ"]}')
    check(augmix['captures'] == 1 and augmix['replays'] == AUGMIX_STEPS - 1,
          f'recipe_train: JSD graph {augmix["captures"]} captures, {augmix["replays"]} replays')
    return launches


# phase drivers: `python -m timm_tpu_torch.train` run A (uninterrupted), run B
# (SIGTERM after update DRIVER_SIGTERM_AT) and run C (`--resume auto` on B's
# directory), then validate and inference on A's checkpoint; ViT-B/16 at its
# width cut to DRIVER_DEPTH blocks (validate and inference take the same
# --model-kwargs), so that the whole script stays inside its time limit with
# the ViT-family phases
DRIVER_DEPTH = 4
DRIVER_FLAGS = [
    '--model', 'vit_base_patch16_224', '--model-kwargs', f'depth={DRIVER_DEPTH}',
    '--amp', '-b', '64', '--epochs', '2',
    '--opt', 'adamw', '--lr', '3e-4', '--weight-decay', '0.05', '--clip-grad', '1.0',
    '--sched', 'cosine', '--warmup-epochs', '1', '--drop-path', '0.1', '--smoothing', '0.1',
    '--mixup', '0.8', '--cutmix', '1.0', '--reprob', '0.25', '--remode', 'const',
    '--color-jitter', '0.4', '--mean', '0.5', '0.5', '0.5', '--std', '0.5', '0.5', '0.5',
    '--device-augment', '--device-prefetch', '2', '--workers', '6',
    '--model-ema', '--model-ema-decay', '0.9998', '--checkpoint-hist', '2', '--seed', '0']
DRIVER_SIGTERM_AT = 12
DRIVER_VALIDATION_PER_CLASS = 64   # 192 validation images
# phase drivers' Muon arm: the same flags with these after them, one epoch;
# run M uninterrupted, run N stopped by SIGTERM after this update and resumed
MUON_DRIVER_FLAGS = ['--epochs', '1', '--opt', 'muon', '--momentum', '0.95',
                     '--sched', 'step', '--decay-epochs', '1', '--warmup-epochs', '0',
                     '--layer-decay', '0.75', '--opt-caution', '--bce-loss']
MUON_DRIVER_SIGTERM_AT = 4
DRIVER_EVAL_REL_TOL = 1e-4         # validate's loss vs the train run's EMA evaluation


def _checkpoint_groups(path: str):
    """{group: {key: array}} of a checkpoint's weights, EMA, optimizer and
    persistent buffers (BatchNorm's running statistics)."""
    groups = {'state_dict': {}, 'state_dict_ema': {}, 'optimizer': {}, 'model_state': {}}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            g = k.split('.', 1)[0]
            if g in groups:
                groups[g][k] = data[k]
    return groups


def _max_diff(a, b):
    """{group: (tensors that differ, max abs difference)}."""
    out = {}
    for g in a:
        check(set(a[g]) == set(b[g]), f'drivers: the checkpoints hold different {g} keys')
        differ = [k for k in a[g] if not np.array_equal(a[g][k], b[g][k])]
        out[g] = (len(differ), max((float(np.abs(a[g][k].astype(np.float64) - b[g][k]).max())
                                    for k in differ), default=0.0))
    return out


def _trim_run_dir(path: str):
    """Keep last.npz and what resume needs; drop the 1.4 GB copies."""
    for name in os.listdir(path):
        if name.startswith(('checkpoint-', 'model_best')):
            os.remove(os.path.join(path, name))


def phase_drivers():
    """The port's drivers through their main(argv), at ViT-B/16's width
    and DRIVER_DEPTH blocks: train runs A, B (SIGTERM after update 12) and C
    (--resume auto on B),
    C's last.npz held to A's bit for bit (or, if the card is not
    deterministic, within the difference of A and a second A); validate on
    A's EMA weights held to A's final EMA evaluation; inference's top-1
    held to validate's; one `python -m timm_tpu_torch.validate` subprocess.
    The Muon arm (MUON_DRIVER_FLAGS: Muon, the step schedule, layer decay,
    caution, BCE): run M, run N stopped by SIGTERM and resumed with
    --resume auto, N's last.npz held to M's bit for bit.
    The wrappers' launch counts are read around each run (they move at a
    graph's warm-up and capture only); run C also runs under the profiler,
    which counts the kernels it ran, replays included."""
    import contextlib
    import csv
    import logging
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from timm_tpu_torch import inference, train, validate
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    from timm_tpu_torch.task.task import TrainingTask
    from timm_tpu_torch.utils import CheckpointSaver

    kernels = (flash_attention, fused_adamw, augment_epilogue)
    # (start, end) of each update, and of each evaluation and checkpoint
    # save of the train driver (time.perf_counter)
    spans = {'update': [], 'epoch_end': []}
    train_step = TrainingTask.train_step
    eval_step = TrainingTask.eval_step
    train_validate = train.validate
    save_checkpoint = CheckpointSaver.save_checkpoint
    marking = []   # non-empty while a profiled run marks off its steps

    def timed(fn, kind):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans[kind].append((t, time.perf_counter()))
                if marking and kind == 'update':
                    _mark()
        return wrapper

    def marked_eval(*a, **kw):
        try:
            return eval_step(*a, **kw)
        finally:
            if marking:
                _mark()

    def run(fn, argv, profiled=None):
        """Run a driver; with ``profiled`` (a dict), each update and eval
        step is marked off and the most of each kernel one step ran
        (``per_call``) and the whole run's profiled count (``total``,
        reported only) go into it."""
        for k in kernels:
            k.launches = 0
        for v in spans.values():
            del v[:]
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(contextlib.redirect_stdout(sys.stderr))
            prof = None if profiled is None else stack.enter_context(
                profile(activities=[ProfilerActivity.CUDA]))
            if prof is not None:
                marking.append(True)
            try:
                result = fn(argv)
                torch.cuda.synchronize()
            finally:
                del marking[:]
        wall = time.perf_counter() - t0
        if prof is not None:
            counts = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA and not getattr(e, 'is_user_annotation', False):
                    counts[e.name] = counts.get(e.name, 0) + 1
            profiled.update(per_call=_per_step(_max_per_call(prof), 1),
                            total=_per_step(counts, 1))
        counts = {k.__name__: k.launches for k in kernels}
        torch.cuda.empty_cache()
        return result, wall, counts, list(spans['update'])

    def train_rates(steps, per_epoch):
        """Train images a second from update 3 on, over all the time from
        its start to the end of the last update, as input_train's img_per_s
        counts them; the same without the epoch ends' evaluation and
        checkpoint saves; and the in-epoch rate taken as input_train's."""
        t0, t1 = steps[TRAIN_WARMUP_STEPS][0], steps[-1][1]
        images = 64 * (len(steps) - TRAIN_WARMUP_STEPS)
        side = sum(min(e, t1) - max(s, t0) for s, e in spans['epoch_end'] if e > t0 and s < t1)
        # update i's host time before its train_step, and the step itself
        parts = [((s - steps[i - 1][1]) * 1e3 if i else 0.0, (e - s) * 1e3)
                 for i, (s, e) in enumerate(steps)]
        return {'img_per_s': images / (t1 - t0),
                'img_per_s_without_eval_and_save': images / (t1 - t0 - side),
                'eval_and_save_s': side, **_in_epoch_rate(parts, per_epoch)}

    tmp = tempfile.mkdtemp(prefix='chip_smoke_drivers_')
    TrainingTask.train_step = timed(train_step, 'update')
    TrainingTask.eval_step = marked_eval
    train.validate = timed(train_validate, 'epoch_end')
    CheckpointSaver.save_checkpoint = timed(save_checkpoint, 'epoch_end')
    row = {'phase': 'drivers', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
           'flags': ' '.join(DRIVER_FLAGS), 'sigterm_at': DRIVER_SIGTERM_AT}
    try:
        data = _image_data()
        n_train, n_val, write_s = (_IMAGE_DATA[k] for k in ('train', 'validation', 'write_s'))
        out = os.path.join(tmp, 'out')
        per_epoch = n_train // 64
        updates = 2 * per_epoch
        depth = DRIVER_DEPTH

        def train_argv(experiment, *extra):
            return DRIVER_FLAGS + ['--data-dir', data, '--output', out,
                                   '--experiment', experiment, *extra]

        row.update(train_images=n_train, validation_images=n_val, updates_per_run=updates,
                   write_images_s=write_s, wall_s={}, launches={})
        rc_a, wall_a, launches_a, starts_a = run(train.main, train_argv('a'))
        row['wall_s']['a'], row['launches']['a'] = wall_a, launches_a
        row['train_from_update_3'] = {'a': train_rates(starts_a, per_epoch)}
        check(rc_a == 0, f'drivers: run A exited {rc_a}')
        # the wrappers count the warm-up and the capture of each graph: the
        # train step's, the eval step's with and without the EMA, and the
        # augment program's
        check(launches_a == {'flash_attention': depth * (2 + 2 * 2), 'fused_adamw': 2,
                             'augment_epilogue': 2},
              f'drivers: run A wrapper launches {launches_a}')
        _trim_run_dir(os.path.join(out, 'a'))
        rc_b, wall_b, launches_b, starts_b = run(
            train.main, train_argv('b', '--fault-inject', f'sigterm@{DRIVER_SIGTERM_AT}'))
        row['wall_s']['b'], row['launches']['b'] = wall_b, launches_b
        row['train_from_update_3']['b'] = train_rates(starts_b, per_epoch)
        check(rc_b == 0, f'drivers: run B exited {rc_b}')
        recovery = sorted(n for n in os.listdir(os.path.join(out, 'b'))
                          if n.startswith('recovery-1-') and n.endswith('.npz'))
        check(len(recovery) == 1, f'drivers: run B left {recovery}, want one recovery file of epoch 1')
        check(len(starts_b) == DRIVER_SIGTERM_AT + 1, f'drivers: run B took {len(starts_b)} updates')
        _trim_run_dir(os.path.join(out, 'b'))
        ran_c = {}
        rc_c, wall_c, launches_c, starts_c = run(train.main, train_argv('b', '--resume', 'auto'),
                                                 profiled=ran_c)
        row['wall_s']['c'], row['launches']['c'] = wall_c, launches_c
        check(rc_c == 0, f'drivers: run C exited {rc_c}')
        check(len(starts_c) == updates - DRIVER_SIGTERM_AT - 1,
              f'drivers: run C took {len(starts_c)} updates')
        # what run C ran on the card, replays included, under the profiler,
        # each update and eval step a marked-off call: depth flash kernels
        # a call (a train or an eval forward), one fused_adamw an update,
        # and the augment program's kernel (on the prefetch stream, which
        # runs beside the steps); the whole run's count is reported: its
        # updates, epoch 1's two evaluations, and the batches of epoch 1
        # that the resume skips (run B consumed them) augmented too
        evals_c = 2 * -(-n_val // 64)
        skipped_c = DRIVER_SIGTERM_AT + 1 - per_epoch
        row['run_c_kernels_ran'] = ran_c
        row['run_c_kernels_expected_total'] = {
            'flash_attention': depth * (len(starts_c) + evals_c), 'fused_adamw': len(starts_c),
            'augment_epilogue': len(starts_c) + skipped_c}
        check(ran_c['per_call']['flash_attention'] == depth
              and ran_c['per_call']['fused_adamw'] == 1
              and ran_c['per_call']['augment_epilogue'] >= 1,
              f'drivers: run C\'s steps ran {ran_c["per_call"]} a step')
        check(not [n for n in os.listdir(os.path.join(out, 'b')) if n.startswith('recovery-')],
              'drivers: the end of epoch 1 did not prune the recovery file')

        ckpt_a = _checkpoint_groups(os.path.join(out, 'a', 'last.npz'))
        ckpt_c = _checkpoint_groups(os.path.join(out, 'b', 'last.npz'))
        c_vs_a = _max_diff(ckpt_c, ckpt_a)
        del ckpt_c
        bit_identical = all(n == 0 for n, _ in c_vs_a.values())
        row['resumed_vs_uninterrupted'] = {g: {'tensors_differ': n, 'max_abs_diff': d}
                                           for g, (n, d) in c_vs_a.items()}
        row['bit_identical'] = bit_identical
        a_vs_a2 = None
        if not bit_identical:
            # the card is not deterministic: hold C to A within what a second
            # uninterrupted run differs by
            _, wall_a2, _, _ = run(train.main, train_argv('a2'))
            a_vs_a2 = _max_diff(_checkpoint_groups(os.path.join(out, 'a2', 'last.npz')), ckpt_a)
            shutil.rmtree(os.path.join(out, 'a2'))
            row['wall_s']['a2'] = wall_a2
            row['uninterrupted_vs_uninterrupted'] = {
                g: {'tensors_differ': n, 'max_abs_diff': d} for g, (n, d) in a_vs_a2.items()}
            for g, (_, d) in c_vs_a.items():
                check(d <= a_vs_a2[g][1],
                      f'drivers: resumed {g} differs from run A by {d}, two uninterrupted runs '
                      f'by {a_vs_a2[g][1]}')
        del ckpt_a

        with open(os.path.join(out, 'a', 'summary.csv')) as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 2, f'drivers: run A wrote {len(rows)} summary rows')
        ema_loss, ema_top1 = float(rows[-1]['eval_loss_ema']), float(rows[-1]['eval_top1_ema'])
        row['run_a_final_ema_eval'] = {'loss': ema_loss, 'top1': ema_top1}

        eval_argv = ['--model', 'vit_base_patch16_224', '--model-kwargs', f'depth={depth}',
                     '--checkpoint', os.path.join(out, 'a', 'last.npz'), '--use-ema', '--amp',
                     '-b', '64', '--workers', '6', '--data-dir', data]
        predictions = []
        val, wall_v, launches_v, _ = run(
            lambda argv: validate.validate(validate.parser.parse_args(argv), predictions), eval_argv)
        row['wall_s']['validate'], row['launches']['validate'] = wall_v, launches_v
        row['validate'] = {'loss': val['loss'], 'top1': val['top1'], 'top5': val['top5']}
        row['validate_img_per_s'] = val['img_per_s']
        # one graph for every batch (the last one padded): a warm-up and a capture
        check(launches_v['flash_attention'] == depth * min(2, -(-n_val // 64)),
              f'drivers: validate wrapper launches {launches_v}')
        check(abs(val['loss'] - ema_loss) <= DRIVER_EVAL_REL_TOL * abs(ema_loss),
              f'drivers: validate loss {val["loss"]} vs run A EMA eval {ema_loss}')
        check(abs(val['top1'] - ema_top1) <= 100.0 / n_val + 1e-9,
              f'drivers: validate top-1 {val["top1"]} vs run A EMA eval {ema_top1}')

        inference_s = []

        class Rate(logging.Handler):
            def emit(self, record):
                m = re.search(r'Inference complete: (\d+) images in ([\d.]+)s', record.getMessage())
                if m:
                    inference_s.append(float(m.group(2)))
        handler = Rate()
        logging.getLogger('inference').addHandler(handler)
        try:
            rc_i, wall_i, launches_i, _ = run(
                inference.main, eval_argv + ['--topk', '5', '--output-dir', os.path.join(tmp, 'inf')])
        finally:
            logging.getLogger('inference').removeHandler(handler)
        row['wall_s']['inference'], row['launches']['inference'] = wall_i, launches_i
        row['inference_img_per_s'] = n_val / inference_s[0] if inference_s else 'not measured'
        check(rc_i == 0, f'drivers: inference exited {rc_i}')
        with open(os.path.join(tmp, 'inf', 'vit_base_patch16_224-results.csv')) as f:
            inf_rows = list(csv.DictReader(f))
        check(len(inf_rows) == n_val, f'drivers: inference wrote {len(inf_rows)} rows')
        agree = sum(int(r['label_0']) == p[0] for r, p in zip(inf_rows, predictions))
        row['inference_top1_agrees'] = agree
        check(agree == n_val == len(predictions),
              f'drivers: inference top-1 agrees with validate on {agree} of {n_val} images')
        check(launches_i['flash_attention'] == depth * min(2, -(-n_val // 64)),
              f'drivers: inference wrapper launches {launches_i}')

        # the module entry point, as a user runs it
        results_json = os.path.join(tmp, 'validate.json')
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'timm_tpu_torch.validate', *eval_argv,
             '--results-file', results_json, '--results-format', 'json'],
            capture_output=True, text=True, cwd=HERE, timeout=600)
        wall_sub = time.perf_counter() - t0
        check(proc.returncode == 0, f'drivers: python -m timm_tpu_torch.validate exited '
                                    f'{proc.returncode}: {proc.stderr[-2000:]}')
        with open(results_json) as f:
            sub = json.load(f)[0]
        row['wall_s']['validate_subprocess'] = wall_sub
        row['validate_subprocess'] = {'loss': sub['loss'], 'top1': sub['top1']}
        check(sub['top1'] == val['top1'] and abs(sub['loss'] - val['loss']) <= 1e-6 * abs(val['loss']),
              f'drivers: the subprocess validate gave {sub}, in-process {val}')

        # the Muon arm
        def muon_argv(experiment, *extra):
            return train_argv(experiment, *MUON_DRIVER_FLAGS, *extra)
        muon = row['muon'] = {'flags': ' '.join(MUON_DRIVER_FLAGS),
                              'sigterm_at': MUON_DRIVER_SIGTERM_AT, 'updates': {}}
        for name, argv in (('m', muon_argv('m')),
                           ('n', muon_argv('n', '--fault-inject',
                                           f'sigterm@{MUON_DRIVER_SIGTERM_AT}')),
                           ('n_resumed', muon_argv('n', '--resume', 'auto'))):
            rc, wall, launches, starts = run(train.main, argv)
            row['wall_s'][f'muon_{name}'], row['launches'][f'muon_{name}'] = wall, launches
            muon['updates'][name] = len(starts)
            check(rc == 0, f'drivers: Muon run {name} exited {rc}')
            check(launches['fused_adamw'] == 0, f'drivers: Muon run {name} launched {launches}')
        check(muon['updates'] == {'m': per_epoch, 'n': MUON_DRIVER_SIGTERM_AT + 1,
                                  'n_resumed': per_epoch - MUON_DRIVER_SIGTERM_AT - 1},
              f'drivers: Muon runs took {muon["updates"]} updates')
        check(row['launches']['muon_m']['flash_attention'] == depth * (2 + 2 * 2),
              f'drivers: Muon run M wrapper launches {row["launches"]["muon_m"]}')
        with open(os.path.join(out, 'm', 'summary.csv')) as f:
            m_rows = list(csv.DictReader(f))
        muon['train_loss'] = float(m_rows[-1]['train_loss'])
        muon['eval_top1_ema'] = float(m_rows[-1]['eval_top1_ema'])
        check(np.isfinite(muon['train_loss']), f'drivers: Muon run M loss {muon["train_loss"]}')
        ckpt_m = _checkpoint_groups(os.path.join(out, 'm', 'last.npz'))
        check(any(k.startswith('optimizer.nu.') for k in ckpt_m['optimizer'])
              and int(ckpt_m['optimizer']['optimizer.count']) == per_epoch,
              'drivers: Muon run M saved no Muon state of its updates')
        n_vs_m = _max_diff(_checkpoint_groups(os.path.join(out, 'n', 'last.npz')), ckpt_m)
        muon['resumed_vs_uninterrupted'] = {g: {'tensors_differ': n, 'max_abs_diff': d}
                                            for g, (n, d) in n_vs_m.items()}
        check(all(n == 0 for n, _ in n_vs_m.values()),
              f'drivers: resumed Muon run N differs from run M: {muon["resumed_vs_uninterrupted"]}')
    finally:
        TrainingTask.train_step = train_step
        TrainingTask.eval_step = eval_step
        train.validate = train_validate
        CheckpointSaver.save_checkpoint = save_checkpoint
        shutil.rmtree(tmp, ignore_errors=True)
        emit(row)  # what was measured, also when a check failed
    launches = {k.__name__: sum(r[k.__name__] for r in row['launches'].values()) for k in kernels}
    return launches


def phase_train_vs_cpu():
    """One step's gradients of ViT-B/16 at its width and 6 blocks (the
    time limit), bf16 on the card against the same seeded weights in fp32
    on the CPU, batch 8, drop_path 0."""
    import torch
    from timm_tpu_torch.kernels import flash_attention
    batch = _train_batch(8, 5, 'cpu')
    grads = {}
    for device, dtype in (('cuda', torch.bfloat16), ('cpu', None)):
        task = _train_task(0, device, dtype, 0.0, nonfinite_guard=False,
                           model_kw={'depth': TRAIN_VS_CPU_DEPTH})
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
          'depth': TRAIN_VS_CPU_DEPTH,
          'grad_rel_l2_bf16_card_vs_fp32_cpu': err, 'tol': GRAD_REL_L2_TOL,
          'finite': bool(torch.isfinite(g_card).all()), 'flash_launches_card_step': launches,
          'cpu_fp32_step_seconds': cpu_s})
    check(bool(torch.isfinite(g_card).all()), 'train_vs_cpu: non-finite gradients on the card')
    check(err <= GRAD_REL_L2_TOL, f'train_vs_cpu: gradient rel L2 {err} > {GRAD_REL_L2_TOL}')
    check(launches == TRAIN_VS_CPU_DEPTH, f'train_vs_cpu: {launches} flash launches in one step')
    torch.cuda.empty_cache()


def phase_train_breakdown(task, batch):
    """Where the time of a train step goes: device time by kernel from
    torch.profiler over 3 eager runs of the step body (the graph replays
    the same kernels, but a replay records no named range), the device's
    idle share of the host wall time, and the shares of the flash forward,
    the attention backward (the named range around the plain recompute) and
    fused_adamw; the attention
    backward of one layer timed alone with CUDA events; and the library's
    attention backward at the same shapes (SDPA forward + backward less its
    forward), timed only: the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from timm_tpu_torch.kernels import flash_attention_backward
    from timm_tpu_torch.kernels.harness import time_ms
    from timm_tpu_torch.kernels.registry import PEAK_BYTES_PER_S, PEAK_OPS_PER_S
    reps = 3

    def eager_step(step):
        task.optimizer.set_hyperparams(lr=1e-5, ema_decay=task.ema.get_decay(step))
        task.model.train()
        task._train_body(batch)
    eager_step(TRAIN_STEPS + 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            eager_step(TRAIN_STEPS + 11 + i)
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
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_OPS_PER_S['float32'] * 1e3
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def library_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(ql, kl, vl), (ql, kl, vl), do)
    library_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl), iters=20, warmup=3)
    library_fwd_bwd_ms = time_ms(library_fwd_bwd, iters=20, warmup=3)
    library_bwd_ms = library_fwd_bwd_ms - library_fwd_ms
    emit({'phase': 'train_breakdown', 'model': 'vit_base_patch16_224', 'batch': TRAIN_BATCH,
          'profiled': 'eager step body', 'wall_ms_per_step': wall_ms,
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


# phase train_graph: step 7 of the 20 is a non-finite batch the guard skips
TRAIN_GRAPH_NAN_STEP = 7
# phase train_graph's untimed arms (accumulation 2, SGD, Muon, lookahead)
# run ViT-B/16 at this depth, so that the whole script stays inside its
# time limit with the NaFlex phases; the timed AdamW arm keeps all 12
TRAIN_GRAPH_CUT_DEPTH = 6
TRAIN_VS_CPU_DEPTH = 6
TRAIN_GRAPH_CUT_STEPS = 10   # the untimed arms' steps (the non-finite step 7 among them)
TRAIN_GRAPH_ODD_BATCH = 37


def _bit_equal(a, b) -> bool:
    """torch.equal on the bits, so that NaNs made the same way are equal."""
    import torch
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return torch.equal(a, b)


def _model_buffers(task):
    """{name: tensor} of the model's persistent buffers (BatchNorm's running
    statistics; none for ViT and ConvNeXt)."""
    from timm_tpu_torch.utils.serialization import persistent_buffers
    return persistent_buffers(task.model)


def _train_state(task):
    """Every tensor a train step updates or reads as state, the model's
    running statistics last."""
    opt = task.optimizer
    return ([opt.flat_param, opt.count, opt.lr_t, opt.ema_decay_t, task._sentinel_state]
            + list(opt.slots().values())
            + [t for tensors in opt.leaf_state().values() for t in tensors.values()]
            + ([opt.ema] if opt.ema is not None else []) + list(_model_buffers(task).values()))


def _graph_vs_eager(opt_name: str, accum: int, batches, nan_batch, timed: bool,
                    model_name: str = 'vit_base_patch16_224', steps: int = TRAIN_STEPS,
                    nan_step: int = TRAIN_GRAPH_NAN_STEP, drop_path_rate: float = 0.1,
                    opt_kw=None, model_kw=None, sched_kw=None, lr: float = TRAIN_LR,
                    weight_decay: float = 0.05, split_bn: int = 0, model=None,
                    state_device=None):
    """One task (ViT-B/16 unless ``model_name``; bf16, drop_path 0.1, clip
    1.0, EMA 0.9998 with warmup, cosine lr with 3 warmup steps, the guard
    on) from one state: ``steps`` (20) eager steps of the step body (what
    ``train_step`` stages and runs, the sentinel's poll included) and as many
    ``train_step`` calls (a warm-up, a capture, then replays), step
    ``nan_step`` non-finite, every metric and buffer and the drop
    generator's state compared with torch.equal. ``sched_kw`` replaces the
    cosine schedule, ``lr`` its base rate; ``split_bn`` converts the model to
    that many BatchNorm splits; ``model`` is used as it is in place of a
    new one. With ``timed``: step ms of steps 3-20 (CUDA events) and the
    idle share of 3 profiled steps of each; the memory the graph keeps.
    ``state_device`` ('cpu') keeps the copies of the train state that the
    comparison needs off the card, for a model whose graph pool leaves no
    room for three more copies."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.layers.drop import get_drop_generator
    task = _train_task(0, 'cuda', torch.bfloat16, drop_path_rate, opt=opt_name, clip_grad=1.0,
                       grad_accum_steps=accum, model_name=model_name, opt_kw=opt_kw,
                       model_kw=model_kw, weight_decay=weight_decay, split_bn=split_bn, lr=lr,
                       model=model)
    task.setup_ema(decay=0.9998, warmup=True)
    gen = get_drop_generator(task.model)
    sched, _ = timm_tpu_torch.create_scheduler_v2(
        lr, **(sched_kw or dict(sched='cosine', num_epochs=TRAIN_STEPS, warmup_epochs=3,
                                warmup_lr=1e-6)))
    lrs = [sched.step(i)[0] for i in range(TRAIN_STEPS)]

    def batch(i):
        return nan_batch if i + 1 == nan_step else batches[i % len(batches)]

    def eager_step(i):
        step = i + 1
        task.optimizer.set_hyperparams(lr=lrs[i % TRAIN_STEPS], ema_decay=task.ema.get_decay(step))
        task.model.train()
        metrics = {k: v.clone() for k, v in task._train_body(batch(i)).items()}
        task.sentinel.observe(task._sentinel_state, step=step)
        return metrics

    def graph_step(i):
        return task.train_step(batch(i), lr=lrs[i % TRAIN_STEPS], step=i + 1)

    def snapshot():
        return [t.detach().to(state_device, copy=True) if state_device else t.clone()
                for t in _train_state(task)]

    start_state = snapshot(), gen.get_state()
    runs = {}
    for mode, fn in (('eager', eager_step), ('graph', graph_step)):
        for t, v in zip(_train_state(task), start_state[0]):
            t.copy_(v)
        gen.set_state(start_state[1])
        task.sentinel.reset()
        task.sentinel.total = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the eager run's cached blocks, before the graph's pool
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        metrics = []
        for i in range(steps):
            if i == TRAIN_WARMUP_STEPS:
                start.record()
            metrics.append(fn(i))
        end.record()
        torch.cuda.synchronize()
        runs[mode] = {'metrics': metrics, 'state': snapshot(),
                      'gen': gen.get_state(),
                      'step_ms': start.elapsed_time(end) / (steps - TRAIN_WARMUP_STEPS)}
        if timed and mode == 'eager':
            # profiled before the graph keeps its pool: a large model's
            # eager step and its graph pool need not fit the card together
            runs['eager_profile'] = _profile_kernels(lambda: eager_step(TRAIN_STEPS), 3)
    e, g = runs['eager'], runs['graph']
    names = ['params', 'count', 'lr', 'ema_decay', 'sentinel'] + list(task.optimizer.slots()) + [
        f'{slot}.{k}' for slot, t in task.optimizer.leaf_state().items() for k in t] + (
        ['ema'] if task.optimizer.ema is not None else []) + list(_model_buffers(task))
    differ = [n for n, a, b in zip(names, e['state'], g['state']) if not _bit_equal(a, b)]
    if not torch.equal(e['gen'], g['gen']):
        differ.append('drop_generator')
    metric_steps = [i + 1 for i, (a, b) in enumerate(zip(e['metrics'], g['metrics']))
                    if a.keys() != b.keys() or not all(_bit_equal(a[k], b[k]) for k in a)]
    row = {'optimizer': opt_name, 'optimizer_kwargs': opt_kw or {}, 'grad_accum_steps': accum,
           'losses': [float(m['loss']) for m in g['metrics']],
           'grad_norms': [float(m['grad_norm']) for m in g['metrics']],
           'skipped_steps': [i + 1 for i, m in enumerate(g['metrics']) if bool(m['nonfinite'])],
           'optimizer_count': int(task.optimizer.count),
           'buffers_that_differ': differ, 'steps_whose_metrics_differ': metric_steps,
           'captures': task.train_graphs.captures, 'replays': task.train_graphs.replays}
    if timed:
        eager_k, _, eager_wall = runs['eager_profile']
        graph_k, graph_counts, graph_wall = _profile_kernels(lambda: graph_step(TRAIN_STEPS), 3)
        row.update(eager_step_ms=e['step_ms'], replay_step_ms=g['step_ms'],
                   eager_img_per_s=TRAIN_BATCH / e['step_ms'] * 1e3,
                   replay_img_per_s=TRAIN_BATCH / g['step_ms'] * 1e3,
                   eager_wall_ms_profiled=eager_wall, replay_wall_ms_profiled=graph_wall,
                   eager_device_ms=sum(eager_k.values()) if eager_k else 'not measured',
                   replay_device_ms=sum(graph_k.values()) if graph_k else 'not measured',
                   eager_idle_share=1 - sum(eager_k.values()) / eager_wall if eager_k
                   else 'not measured',
                   replay_idle_share=1 - sum(graph_k.values()) / graph_wall if graph_k
                   else 'not measured',
                   replayed_kernels_per_step=_per_step(graph_counts),
                   graph_pool_bytes=task.train_graphs.pool_bytes(),
                   graph_static_input_bytes=task.train_graphs.static_bytes())
    return row, task


def _eval_graph_vs_eager(task):
    """The eval graph against the eager forward, with and without the EMA,
    at batch 64 and at an odd last batch: 3 calls each (a warm-up, a
    capture and replay, a replay), each equal with torch.equal."""
    import torch
    out = {}
    for n in (TRAIN_BATCH, TRAIN_GRAPH_ODD_BATCH):
        x = torch.from_numpy(_images(n, seed=n)).cuda()
        for use_ema in (False, True):
            got = [task.eval_step({'input': x}, use_ema=use_ema) for _ in range(3)]
            task.model.eval()
            with torch.no_grad():
                want = (torch.func.functional_call(task.model, task.ema_params, (x,))
                        if use_ema else task.model(x))
            task.model.train()
            out[f'b{n}_{"ema" if use_ema else "weights"}'] = all(torch.equal(g, want) for g in got)
    return out


# phase train_graph's arms: (optimizer, gradient accumulation, its arguments)
TRAIN_GRAPH_ARMS = (('adamw', 1, {}), ('adamw', 2, {}), ('sgd', 1, {}),
                    ('muon', 1, {'momentum': 0.95}),
                    ('lookahead_nadamw', 1, {'caution': True, 'layer_decay': 0.75}))


def phase_train_graph():
    """The compiled train step against its eager body, bit for bit: AdamW,
    AdamW with gradient accumulation 2, SGD, Muon, and NAdamW under
    lookahead, caution and layer decay 0.75, each from one state over 20
    steps (10 for the arms cut to 6 blocks) in which lr and the EMA decay
    change every step and step 7 is
    skipped by the guard; eager and replayed step ms, idle shares and the
    graph's memory (AdamW); the eval graph against the eager forward."""
    import torch
    batches = [_train_batch(TRAIN_BATCH, 40 + i, 'cuda') for i in range(4)]
    nan_batch = dict(batches[0], input=batches[0]['input'].clone())
    nan_batch['input'][3, 100, 100, 1] = float('nan')
    rows = []
    for opt_name, accum, opt_kw in TRAIN_GRAPH_ARMS:
        timed = (opt_name, accum) == ('adamw', 1)
        # the untimed arms run ViT-B/16 cut to TRAIN_GRAPH_CUT_DEPTH blocks, over
        # TRAIN_GRAPH_CUT_STEPS steps
        row, task = _graph_vs_eager(opt_name, accum, batches, nan_batch, timed, opt_kw=opt_kw,
                                    model_kw=None if timed else {'depth': TRAIN_GRAPH_CUT_DEPTH},
                                    steps=TRAIN_STEPS if timed else TRAIN_GRAPH_CUT_STEPS)
        row['depth'] = len(task.model.blocks)
        row['steps'] = TRAIN_STEPS if timed else TRAIN_GRAPH_CUT_STEPS
        if timed:
            row['eval_graph_equals_eager'] = _eval_graph_vs_eager(task)
            row['eval_graph_captures'] = task.eval_graphs.captures
        rows.append(row)
        del task
        torch.cuda.empty_cache()
    emit({'phase': 'train_graph', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
          'batch': TRAIN_BATCH, 'steps': TRAIN_STEPS, 'nan_step': TRAIN_GRAPH_NAN_STEP,
          'runs': rows})
    for row in rows:
        what = f'train_graph {row["optimizer"]} accum {row["grad_accum_steps"]}'
        check(not row['buffers_that_differ'],
              f'{what}: replays differ from eager steps in {row["buffers_that_differ"]}')
        check(not row['steps_whose_metrics_differ'],
              f'{what}: metrics differ at steps {row["steps_whose_metrics_differ"]}')
        check(row['skipped_steps'] == [TRAIN_GRAPH_NAN_STEP],
              f'{what}: the guard skipped steps {row["skipped_steps"]}')
        check(row['captures'] == 1 and row['replays'] >= row['steps'] - 1,
              f'{what}: {row["captures"]} captures, {row["replays"]} replays')
    timed = rows[0]
    check(all(timed['eval_graph_equals_eager'].values()),
          f'train_graph: eval graph vs eager forward {timed["eval_graph_equals_eager"]}')
    check(timed['replayed_kernels_per_step']['flash_attention'] == 12
          and timed['replayed_kernels_per_step']['fused_adamw'] == 1,
          f'train_graph: a replayed step ran {timed["replayed_kernels_per_step"]}')
    return timed


# ---- Muon: phases muon_train and muon_vs_cpu ------------------------------------------------
MUON_MOMENTUM = 0.95
# one Muon update of ViT-B/16 on the card against the CPU, both fp32 from the
# same weights and gradient: the largest relative L2 of a leaf's update. The
# same update with TF32 products on the card is the control, which must lie
# above the limit: a limit it passed would pass the fault it is set to catch.
# On the H100 fp32 read 4.83e-5 and TF32 2.69e-3; the limit sits between,
# about 8x from fp32 and 7x from TF32
MUON_VS_CPU_TOL = 4e-4


def _ns_flops(opt) -> int:
    """fp32 operations of one Muon step's Newton-Schulz iterations: per
    matrix (m <= n) and step X Xᵀ (2 m² n), A A (2 m³) and B X (2 m² n)."""
    from timm_tpu_torch.optim import NS_STEPS
    total = 0
    for leaves, _ in opt._groups:
        m, n = sorted(opt._slots[leaves[0][0]][1])
        total += len(leaves) * NS_STEPS * (4 * m * m * n + 2 * m ** 3)
    return total


def phase_muon_train():
    """ViT-B/16 trained with Muon through ClassificationTask, as phase
    ``train`` trains it with AdamW (bf16 compute, fp32 parameters, drop path
    0.1, label smoothing 0.1, wd 0.05 under the mask, clip 1.0, EMA, cosine
    with 3 warmup steps, 20 steps on one fixed batch, a graph from step 2),
    momentum 0.95: losses, replayed step ms, idle share and the graph's
    memory; the profiler's kernels of 3 replayed steps (12 flash, no
    fused_adamw); the optimizer step alone as a CUDA graph of ``opt.step``,
    and its Newton-Schulz iterations alone, against their fp32 bound."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels import flash_attention, fused_adamw
    from timm_tpu_torch.kernels.harness import graph_ms
    from timm_tpu_torch.kernels.registry import PEAK_OPS_PER_S
    from timm_tpu_torch.optim import orthogonalize_via_newton_schulz
    task = _train_task(0, 'cuda', torch.bfloat16, 0.1, opt='muon',
                       opt_kw={'momentum': MUON_MOMENTUM}, clip_grad=1.0)
    task.setup_ema(decay=0.9998)
    opt = task.optimizer
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
    metrics, flash_steps, lrs = [], [], []
    for step in range(TRAIN_STEPS):
        if step == TRAIN_WARMUP_STEPS:
            start.record()
        f0 = flash_attention.launches
        lrs.append(sched.step(step)[0])
        metrics.append(task.train_step(batch, lr=lrs[-1], step=step + 1))
        flash_steps.append(flash_attention.launches - f0)
    end.record()
    torch.cuda.synchronize()
    launches = {'flash_attention': flash_attention.launches, 'fused_adamw': fused_adamw.launches}
    step_ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    reps = 3
    kernels, counts, prof_wall_ms = _profile_kernels(
        lambda: task.train_step(batch, lr=1e-5, step=TRAIN_STEPS + 1), reps)
    replayed = _per_step(counts)
    busy = sum(kernels.values())
    losses = [float(m['loss']) for m in metrics]
    last = metrics[-1]
    # the update alone: a graph of opt.step on the gradient the last step left
    scale = torch.ones((), device='cuda')
    ok = torch.ones((), dtype=torch.bool, device='cuda')
    opt_step_ms = graph_ms(lambda: opt.step(grad_scale=scale, ok=ok), per_graph=2, replays=5)
    # its Newton-Schulz iterations alone, on seeded matrices of each group's shape
    g = torch.Generator(device='cuda').manual_seed(3)
    stacks = [torch.randn(len(leaves), *sorted(opt._slots[leaves[0][0]][1]), generator=g,
                          device='cuda') for leaves, _ in opt._groups]
    ns_ms = graph_ms(lambda: [orthogonalize_via_newton_schulz(x) for x in stacks],
                     per_graph=2, replays=5)
    ns_flops = _ns_flops(opt)
    ns_bound_ms = ns_flops / PEAK_OPS_PER_S['float32'] * 1e3
    emit({'phase': 'muon_train', 'model': 'vit_base_patch16_224', 'dtype': 'bfloat16',
          'optimizer': 'muon', 'momentum': MUON_MOMENTUM, 'batch': TRAIN_BATCH,
          'steps': TRAIN_STEPS, 'drop_path_rate': 0.1,
          'muon_leaves': len(opt.muon_leaves), 'adam_leaves': len(opt.adam_leaves),
          'muon_parameters': sum(opt._slots[n][1].numel() for n in opt.muon_leaves),
          'ns_groups': [[len(leaves), *sorted(opt._slots[leaves[0][0]][1])]
                        for leaves, _ in opt._groups],
          'losses': losses, 'grad_norms': [float(m['grad_norm']) for m in metrics], 'lrs': lrs,
          'step_ms': step_ms, 'img_per_s': TRAIN_BATCH / step_ms * 1e3,
          'peak_memory_gb': peak_gb, 'graph_pool_bytes': task.train_graphs.pool_bytes(),
          'captures': task.train_graphs.captures, 'replays': task.train_graphs.replays,
          'nonfinite_total': int(last['nonfinite_total']),
          'wrapper_flash_launches_per_step': flash_steps, 'launches': launches,
          'profiled_replays': reps,
          'replayed_kernels_per_step': replayed if kernels else 'not measured',
          'replay_wall_ms_per_step': prof_wall_ms,
          'replay_device_ms_per_step': busy if kernels else 'not measured',
          'replay_idle_share': 1.0 - busy / prof_wall_ms if kernels else 'not measured',
          'optimizer_step_ms': opt_step_ms, 'newton_schulz_ms': ns_ms,
          'newton_schulz_flops': ns_flops, 'newton_schulz_bound_ms': ns_bound_ms,
          'newton_schulz_bound_share': ns_bound_ms / ns_ms})
    check(all(np.isfinite(losses)), f'muon_train: non-finite loss in {losses}')
    check(losses[-1] < losses[0], f'muon_train: last loss {losses[-1]} not below first {losses[0]}')
    check(flash_steps == [depth, depth] + [0] * (TRAIN_STEPS - 2),
          f'muon_train: flash wrapper launches per step {flash_steps}')
    check(launches['fused_adamw'] == 0, f'muon_train: {launches["fused_adamw"]} fused_adamw launches')
    check(task.train_graphs.captures == 1, 'muon_train: the step was not captured once')
    check(bool(kernels), 'muon_train: the profiler saw no kernel of the replayed steps')
    check(replayed['flash_attention'] == depth and replayed['fused_adamw'] == 0,
          f'muon_train: a replayed step ran {replayed}')
    check(int(last['nonfinite_total']) == 0, 'muon_train: the guard skipped a step')
    return launches


def phase_muon_vs_cpu():
    """One Muon update of ViT-B/16 in fp32 on the card against the CPU: the
    same seeded weights and flat gradient, lr 0.02, wd 0.05 under the mask;
    each leaf's update p_new - p within MUON_VS_CPU_TOL relative L2. The
    control runs the card's update once more with TF32 matrix products and
    must exceed the limit."""
    import torch
    import timm_tpu_torch
    grad = None
    updates = {}
    for run, device in (('cuda', 'cuda'), ('cuda_tf32', 'cuda'), ('cpu', 'cpu')):
        model = timm_tpu_torch.create_model('vit_base_patch16_224', seed=0, device=device)
        opt = timm_tpu_torch.create_optimizer_v2(model, opt='muon', lr=0.02, weight_decay=0.05,
                                                 momentum=MUON_MOMENTUM)
        if grad is None:
            grad = torch.from_numpy(np.random.default_rng(11).standard_normal(
                opt.flat_grad.numel(), dtype=np.float32) * 1e-3)
        before = opt.flat_param.detach().cpu().clone()
        opt.flat_grad.copy_(grad.to(device))
        torch.backends.cuda.matmul.allow_tf32 = run == 'cuda_tf32'
        try:
            t0 = time.perf_counter()
            opt.step()
            if device == 'cuda':
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        updates[run] = (opt.host_views(opt.flat_param.detach().cpu() - before), seconds)
        del model, opt
    cpu, cpu_s = updates['cpu']

    def rel_l2(run):
        upd = updates[run][0]
        return {n: float(np.linalg.norm(upd[n] - cpu[n]) / max(np.linalg.norm(cpu[n]), 1e-30))
                for n in cpu}
    rel, rel_tf32 = rel_l2('cuda'), rel_l2('cuda_tf32')
    worst, worst_tf32 = max(rel, key=rel.get), max(rel_tf32, key=rel_tf32.get)
    emit({'phase': 'muon_vs_cpu', 'model': 'vit_base_patch16_224', 'dtype': 'float32',
          'leaves': len(rel), 'max_rel_l2': rel[worst], 'worst_leaf': worst,
          'median_rel_l2': float(np.median(list(rel.values()))), 'tol': MUON_VS_CPU_TOL,
          'tf32_control_max_rel_l2': rel_tf32[worst_tf32], 'tf32_control_worst_leaf': worst_tf32,
          'tf32_control_median_rel_l2': float(np.median(list(rel_tf32.values()))),
          'card_step_seconds_eager_first': updates['cuda'][1], 'cpu_step_seconds': cpu_s})
    check(all(np.isfinite(list(rel.values()))), 'muon_vs_cpu: a non-finite update')
    check(rel[worst] <= MUON_VS_CPU_TOL,
          f'muon_vs_cpu: {worst} update rel L2 {rel[worst]} > {MUON_VS_CPU_TOL}')
    check(rel_tf32[worst_tf32] > MUON_VS_CPU_TOL,
          f'muon_vs_cpu: the TF32 control ({rel_tf32[worst_tf32]}) passes the limit '
          f'{MUON_VS_CPU_TOL}')
    torch.cuda.empty_cache()


# ---- ConvNeXt-B: phases convnext_depthwise, convnext_model, convnext_serve,
# convnext_train and convnext_drivers -----------------------------------------
CONVNEXT = 'convnext_base'
CONVNEXT_DROP_PATH = 0.5    # the ConvNeXt-B recipe's rate, stage-wise linear over 36 blocks
# phase convnext_train's replayed step against its eager body: 5 steps, the
# 4th non-finite
CONVNEXT_GRAPH_STEPS, CONVNEXT_NAN_STEP = 5, 4
CONVNEXT_GRAD_BATCH = 4
# ConvNeXt-B's depthwise 7x7 convolutions: (H = W, C, blocks) of each stage
CONVNEXT_DW_STAGES = ((56, 128, 3), (28, 256, 3), (14, 512, 27), (7, 1024, 3))
# the driver drills below run their model at its width and a cut depth
# (--model-kwargs, which validate and inference take too), so that the
# whole script stays inside its time limit with the ViT-family phases
CONVNEXT_DRIVER_KWARGS = 'depths=[1,1,1,1]'
CONVNEXT_DRIVER_FLAGS = [
    '--model', CONVNEXT, '--model-kwargs', CONVNEXT_DRIVER_KWARGS, '--amp', '-b', '64',
    '--epochs', '1',
    '--opt', 'adamw', '--lr', '3e-4', '--weight-decay', '0.05', '--clip-grad', '1.0',
    '--sched', 'cosine', '--warmup-epochs', '0', '--drop-path', str(CONVNEXT_DROP_PATH),
    '--smoothing', '0.1', '--mixup', '0.8', '--cutmix', '1.0', '--reprob', '0.25',
    '--remode', 'const', '--color-jitter', '0.4', '--device-augment', '--device-prefetch', '2',
    '--workers', '6', '--model-ema', '--model-ema-decay', '0.9998', '--checkpoint-hist', '1',
    '--seed', '0']


def _lift_from_init(model, seed: int = 0):
    """At init every ConvNeXt block is near the identity (layer scale
    1e-6, GRN weight and bias 0), so a comparison there would hold whatever
    the blocks compute: the layer-scale gammas get seeded values in
    [0.1, 1.0] and GRN's weight and bias values of order 0.1, drawn with
    numpy and copied in place (the same on every device)."""
    import torch
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('ls.gamma'):
                p.copy_(torch.from_numpy(rng.uniform(0.1, 1.0, p.shape).astype(np.float32)))
            elif '.grn.' in name:
                p.copy_(torch.from_numpy((0.1 * rng.standard_normal(p.shape)).astype(np.float32)))
    return model


def _convnext(device, dtype=None):
    import timm_tpu_torch
    return _lift_from_init(timm_tpu_torch.create_model(CONVNEXT, dtype=dtype, seed=0,
                                                       device=device))


# cuDNN's depthwise NHWC kernels (channel multiplier 1), as the card names
# them: the forward, and the input and weight gradients. The profiles of
# phases convnext_serve and convnext_train count the depthwise convolution
# apart by these names and check that a forward runs one per block.
DW_FWD_RE, DW_BWD_RE = r'^conv2d_c1_k1', r'^(dgrad|wgrad)2d_c1_k1'


def phase_convnext_depthwise():
    """ConvNeXt-B's depthwise 7x7 convolution (bf16, channels_last, batch 64,
    cuDNN through ``F.conv2d``; without its bias, which PyTorch adds in a
    kernel of its own) at each stage's shape: the forward's and the
    backward's (``aten.convolution_backward``: input and weight gradients,
    what autograd calls) device ms from CUDA-graph replays
    (``harness.graph_ms``), and an eager forward's ms (CUDA events, host
    time included), against their bounds (the larger of the bytes, each
    input read and each output written once, over 3.35 TB/s and the
    operations over the bf16 peak)."""
    import torch
    import torch.nn.functional as F
    from timm_tpu_torch.kernels.harness import graph_ms, time_ms
    from timm_tpu_torch.kernels.registry import PEAK_BYTES_PER_S, PEAK_OPS_PER_S
    g = torch.Generator(device='cuda').manual_seed(11)
    rows = []
    total = {'fwd_ms': 0.0, 'bwd_ms': 0.0, 'fwd_bound_ms': 0.0, 'bwd_bound_ms': 0.0}
    with torch.no_grad():
        for size, chs, blocks in CONVNEXT_DW_STAGES:
            x = torch.randn(TRAIN_BATCH, size, size, chs, generator=g, device='cuda',
                            dtype=torch.bfloat16).permute(0, 3, 1, 2)
            w = (torch.randn(chs, 1, 7, 7, generator=g, device='cuda') * 0.1).to(
                torch.bfloat16, memory_format=torch.channels_last)
            dy = torch.randn(x.shape, generator=g, device='cuda', dtype=torch.bfloat16).to(
                memory_format=torch.channels_last)

            def fwd():
                return F.conv2d(x, w, None, 1, 3, 1, chs)

            def bwd():
                return torch.ops.aten.convolution_backward(
                    dy, x, w, None, [1, 1], [3, 3], [1, 1], False, [0, 0], chs,
                    [True, True, False])
            fwd_ms, bwd_ms = graph_ms(fwd), graph_ms(bwd)
            act = x.numel() * 2
            ops = 2 * 49 * x.numel()
            fwd_bound = max((2 * act + w.numel() * 2) / PEAK_BYTES_PER_S,
                            ops / PEAK_OPS_PER_S['bfloat16']) * 1e3
            bwd_bound = max((3 * act + 2 * w.numel() * 2) / PEAK_BYTES_PER_S,
                            2 * ops / PEAK_OPS_PER_S['bfloat16']) * 1e3
            rows.append({'shape_nhwc': [TRAIN_BATCH, size, size, chs], 'blocks': blocks,
                         'fwd_ms': fwd_ms, 'bwd_ms': bwd_ms,
                         'fwd_call_ms': time_ms(fwd, iters=20, warmup=3),
                         'fwd_bound_ms': fwd_bound, 'bwd_bound_ms': bwd_bound,
                         'bound_by': 'bytes'})
            for k, v in (('fwd_ms', fwd_ms), ('bwd_ms', bwd_ms), ('fwd_bound_ms', fwd_bound),
                         ('bwd_bound_ms', bwd_bound)):
                total[k] += blocks * v
            del x, w, dy
    emit({'phase': 'convnext_depthwise', 'model': CONVNEXT, 'dtype': 'bfloat16',
          'batch': TRAIN_BATCH, 'stages': rows, 'per_step_36_blocks': total})
    check(all(r['fwd_ms'] > 0 and r['bwd_ms'] > 0 for r in rows),
          'convnext_depthwise: a convolution took no time')
    return total


def _families(kernels, counts):
    """Device ms and kernel counts per call by kernel family: the depthwise
    convolution's forward and backward (cuDNN's depthwise kernels), the
    other convolutions, GEMMs, layout transposes, copies and casts, the
    port's kernels, and the norm / elementwise / reduction chains."""
    ms, n = {}, {}
    for name, t in kernels.items():
        if re.search(DW_FWD_RE, name):
            fam = 'depthwise_conv_fwd'
        elif re.search(DW_BWD_RE, name):
            fam = 'depthwise_conv_bwd'
        elif re.search(r'fused_adamw|augment_epilogue|flash_fwd', name):
            fam = re.search(r'fused_adamw|augment_epilogue|flash_fwd', name).group(0)
        elif re.search(r'nchwToNhwc|nhwcToNchw|transpose', name, re.I):
            fam = 'layout_transpose'
        elif re.search(r'conv|fprop|dgrad|wgrad', name, re.I):
            fam = 'conv'
        elif re.search(r'gemm|cutlass|xmma|cublas|matmul|nvjet', name, re.I):
            fam = 'gemm'
        elif re.search(r'copy', name, re.I):
            fam = 'copy_or_cast'
        else:
            fam = 'norm_elementwise_reduce'
        ms[fam] = ms.get(fam, 0.0) + t
        n[fam] = n.get(fam, 0) + counts[name]
    return {'ms': ms, 'kernels': n}


def phase_convnext_model():
    """convnext_base at full width and depth (dims 128/256/512/1024, depths
    3/3/27/3, 224 px), random weights from seed 0 with layer scale and GRN
    lifted from init: bf16 on the card against the same weights in fp32 on
    the CPU, batch 8."""
    import torch
    x = _images(8)
    card = _convnext('cuda', torch.bfloat16).eval()
    plain = _convnext('cpu').eval()
    with torch.inference_mode():
        xc = torch.from_numpy(x).cuda()
        stem_dtype = str(card._stem(xc).dtype)
        logits_card = card(xc).float().cpu().numpy()
        t0 = time.perf_counter()
        logits_cpu = plain(torch.from_numpy(x)).numpy()
        cpu_s = time.perf_counter() - t0
    err = rel_l2(logits_card, logits_cpu)
    emit({'phase': 'convnext_model', 'model': CONVNEXT, 'batch': 8, 'dtype': 'bfloat16',
          'params': sum(p.numel() for p in card.parameters()),
          'leaves': len(list(card.parameters())), 'stem_output_dtype': stem_dtype,
          'rel_l2_vs_cpu_fp32': err, 'tol': MODEL_REL_L2_TOL,
          'finite': bool(np.isfinite(logits_card).all()), 'cpu_fp32_seconds': cpu_s})
    check(np.isfinite(logits_card).all(), 'convnext_model: non-finite logits on the card')
    check(logits_card.shape == (8, 1000), f'convnext_model: logits shape {logits_card.shape}')
    check(err <= MODEL_REL_L2_TOL, f'convnext_model: rel L2 {err} > {MODEL_REL_L2_TOL}')
    del card, plain
    torch.cuda.empty_cache()


def phase_convnext_serve():
    """The engine serving convnext_base in bf16 (weights lifted from init),
    one CUDA graph per bucket captured at add_model: 200 requests in the
    bursts of phase serve; served rows against their direct forward; each
    bucket's replay bit for bit against an eager forward; eager and
    replayed forward ms per bucket (CUDA events); the graphs' bytes; and
    under torch.profiler 3 replays of bucket 64, by kernel family, with the
    idle share. No kernel of the port lies on this path (its convolutions
    are cuDNN's): the wrappers' counts must not move."""
    import torch
    from timm_tpu_torch import InferenceEngine
    from timm_tpu_torch.kernels import registry
    from timm_tpu_torch.kernels.harness import time_ms
    counters = registry.launch_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    n = sum(SERVE_BURSTS)
    images = _images(n, seed=1)
    engine = InferenceEngine(buckets=SERVE_BUCKETS, max_wait_ms=5.0, device='cuda')
    engine.add_model(CONVNEXT, factory=lambda: _convnext('cuda', torch.bfloat16))
    engine.start()
    futures, submitted, wall = _serve_bursts(engine, images)
    engine.shutdown(drain=True)
    stats = engine.snapshot_stats()
    served = np.stack([f.result() for f in futures])
    lat_ms = np.array([(f.done_at - s) * 1e3 for f, s in zip(futures, submitted)])
    res = engine.pool.acquire(CONVNEXT)
    model, graphs = res.model, engine.aot_executables(CONVNEXT)
    per_bucket, replay_equal = {}, {}
    with torch.inference_mode():
        direct = np.concatenate([
            model(torch.from_numpy(images[j:j + 8]).cuda()).float().cpu().numpy()
            for j in range(0, n, 8)])
        for b in SERVE_BUCKETS:
            x = torch.from_numpy(_images(b, seed=10 + b))
            replayed = graphs[b].run(x.pin_memory())
            eager = model(x.cuda()).float()
            replay_equal[str(b)] = bool(torch.equal(replayed, eager))
            xc = x.cuda()
            graphs[b].static_in.copy_(xc)
            eager_ms = time_ms(lambda: model(xc), iters=5, warmup=1)
            replay_ms = time_ms(graphs[b].graph.replay, iters=10, warmup=2)
            per_bucket[str(b)] = {'forward_ms': eager_ms, 'replay_ms': replay_ms,
                                  'replay_img_per_s': b / replay_ms * 1e3}
        reps = 3
        graphs[64].static_in.copy_(torch.from_numpy(_images(64, seed=3)).cuda())
        kernels, counts, replay_wall_ms = _profile_kernels(graphs[64].graph.replay, reps)
    busy = sum(kernels.values())
    fams = _families(kernels, counts)
    errs = [rel_l2(served[j], direct[j]) for j in range(n)]
    prewarm = stats['prewarm'][CONVNEXT]
    moved = {k: fn.launches - before[k] for k, fn in counters.items() if fn.launches != before[k]}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    emit({'phase': 'convnext_serve', 'model': CONVNEXT, 'dtype': 'bfloat16',
          'requests': n, 'completed': stats['completed'], 'failed': stats['failed'],
          'steps_by_bucket': stats['steps_by_bucket'],
          'replays_by_bucket': stats['replays_by_bucket'],
          'p50_ms': float(np.percentile(lat_ms, 50)), 'p99_ms': float(np.percentile(lat_ms, 99)),
          'img_per_s': n / wall, 'wall_s': wall, 'per_bucket': per_bucket,
          'max_rel_l2_vs_direct': max(errs), 'tol': SERVE_REL_L2_TOL,
          'prewarm_ms': prewarm['ms'], 'graph_bytes': prewarm['graph_bytes'],
          'replay_equals_eager_bit_for_bit': replay_equal, 'wrapper_launches': moved,
          'profiled_bucket': 64, 'replay_wall_ms': replay_wall_ms,
          'replay_device_ms': busy if kernels else 'not measured',
          'replay_idle_share': 1.0 - busy / replay_wall_ms if kernels else 'not measured',
          'replay_kernels_per_forward': sum(counts.values()) if kernels
          else 'not measured',
          'replay_ms_by_family': fams['ms'], 'replay_kernels_by_family': fams['kernels'],
          'top_kernels': [{'kernel': k[:120], 'ms': v} for k, v in top]})
    check(stats['completed'] == n and stats['failed'] == 0,
          f'convnext_serve: {stats["failed"]} failed requests')
    check(set(stats['steps_by_bucket']) == set(SERVE_BUCKETS),
          f'convnext_serve: buckets dispatched {stats["steps_by_bucket"]}')
    check(stats['replays_by_bucket'] == stats['steps_by_bucket'],
          f'convnext_serve: replays {stats["replays_by_bucket"]} for steps {stats["steps_by_bucket"]}')
    check(prewarm['mode'] == 'graph' and prewarm['programs'] == len(SERVE_BUCKETS),
          f'convnext_serve: prewarm captured {prewarm["programs"]} graphs ({prewarm["mode"]})')
    check(not moved, f'convnext_serve: the port\'s kernels launched {moved}')
    check(bool(np.isfinite(served).all()), 'convnext_serve: non-finite logits')
    check(max(errs) <= SERVE_REL_L2_TOL, f'convnext_serve: max rel L2 {max(errs)} > {SERVE_REL_L2_TOL}')
    check(all(replay_equal.values()), f'convnext_serve: replay vs eager bit for bit: {replay_equal}')
    check(bool(kernels), 'convnext_serve: the profiler saw no kernel of the replays')
    check(fams['kernels'].get('depthwise_conv_fwd') == 36,
          f'convnext_serve: {fams["kernels"].get("depthwise_conv_fwd")} depthwise kernels a '
          'forward, want one a block (36)')
    del engine, res, model, graphs
    gc.collect()
    torch.cuda.empty_cache()


def phase_convnext_train():
    """ClassificationTask on convnext_base (bf16 compute, fp32 parameters,
    layer scale lifted from init) with drop path 0.5, label smoothing 0.1,
    AdamW (wd 0.05 with the mask), clip 1.0, EMA 0.9998, cosine with 3
    warmup steps: 20 steps at batch 64 on one fixed batch, steps 3-20
    replays of one graph; the wrappers' counts per step; under the
    profiler 3 more replayed steps by kernel family (the depthwise
    convolution's forward and backward apart) with the idle share. Then one
    step's gradients, bf16 on the card against fp32 on the CPU at batch 4
    (drop path 0), and the replayed step against its eager body bit for bit
    over 5 steps from one state (drop path 0.5, the 4th step non-finite)."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels import flash_attention, fused_adamw
    task = _train_task(0, 'cuda', torch.bfloat16, CONVNEXT_DROP_PATH, clip_grad=1.0,
                       model_name=CONVNEXT)
    task.setup_ema(decay=0.9998)
    sched, _ = timm_tpu_torch.create_scheduler_v2(
        TRAIN_LR, 'cosine', num_epochs=TRAIN_STEPS, warmup_epochs=3, warmup_lr=1e-6)
    batch = _train_batch(TRAIN_BATCH, 4, 'cuda')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flash_attention.launches = fused_adamw.launches = 0
    metrics, adamw_steps, flash_steps = [], [], []
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        if step == TRAIN_WARMUP_STEPS:
            start.record()
        f0, a0 = flash_attention.launches, fused_adamw.launches
        metrics.append(task.train_step(batch, lr=sched.step(step)[0], step=step + 1))
        flash_steps.append(flash_attention.launches - f0)
        adamw_steps.append(fused_adamw.launches - a0)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'flash_attention': flash_attention.launches, 'fused_adamw': fused_adamw.launches}
    step_ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    reps = 3
    kernels, counts, prof_wall_ms = _profile_kernels(
        lambda: task.train_step(batch, lr=1e-5, step=TRAIN_STEPS + 1), reps)
    replayed = _per_step(counts)
    busy = sum(kernels.values())
    fams = _families(kernels, counts)
    losses = [float(m['loss']) for m in metrics]
    row = {'phase': 'convnext_train', 'model': CONVNEXT, 'dtype': 'bfloat16',
           'batch': TRAIN_BATCH, 'steps': TRAIN_STEPS, 'drop_path_rate': CONVNEXT_DROP_PATH,
           'losses': losses, 'grad_norms': [float(m['grad_norm']) for m in metrics],
           'step_ms': step_ms, 'img_per_s': TRAIN_BATCH / step_ms * 1e3, 'wall_s': wall,
           'peak_memory_gb': peak_gb, 'graph_pool_bytes': task.train_graphs.pool_bytes(),
           'graph_static_input_bytes': task.train_graphs.static_bytes(),
           'captures': task.train_graphs.captures, 'replays': task.train_graphs.replays,
           'wrapper_fused_adamw_launches_per_step': adamw_steps,
           'wrapper_flash_launches_per_step': flash_steps, 'launches': launches,
           'profiled_replays': reps, 'replayed_kernels_per_step': replayed if kernels else
           'not measured', 'replay_wall_ms_per_step': prof_wall_ms,
           'replay_device_ms_per_step': busy if kernels else 'not measured',
           'replay_idle_share': 1.0 - busy / prof_wall_ms if kernels else 'not measured',
           'replay_ms_by_family': fams['ms'], 'replay_kernels_by_family': fams['kernels'],
           'top_kernels': [{'kernel': k[:120], 'ms': v}
                           for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]]}
    del task
    torch.cuda.empty_cache()

    # one step's gradients, bf16 on the card against fp32 on the CPU
    grad_batch = _train_batch(CONVNEXT_GRAD_BATCH, 5, 'cpu')
    grads = {}
    for device, dtype in (('cuda', torch.bfloat16), ('cpu', None)):
        t = _train_task(0, device, dtype, 0.0, nonfinite_guard=False, model_name=CONVNEXT)
        t.train_step(grad_batch, lr=0.0, step=1)
        grads[device] = t.optimizer.flat_grad.float().cpu()
        del t
    torch.cuda.empty_cache()
    g_card, g_cpu = grads['cuda'], grads['cpu']
    grad_err = float((g_card - g_cpu).norm() / g_cpu.norm())
    row.update(grad_batch=CONVNEXT_GRAD_BATCH, grad_rel_l2_bf16_card_vs_fp32_cpu=grad_err,
               grad_tol=GRAD_REL_L2_TOL, grads_finite=bool(torch.isfinite(g_card).all()))

    # the replayed step against its eager body, from one state
    batches = [_train_batch(TRAIN_BATCH, 60 + i, 'cuda') for i in range(2)]
    nan_batch = dict(batches[0], input=batches[0]['input'].clone())
    nan_batch['input'][5, 50, 50, 2] = float('nan')
    graph_row, task = _graph_vs_eager('adamw', 1, batches, nan_batch, False, model_name=CONVNEXT,
                                      steps=CONVNEXT_GRAPH_STEPS, nan_step=CONVNEXT_NAN_STEP,
                                      drop_path_rate=CONVNEXT_DROP_PATH)
    del task
    gc.collect()
    torch.cuda.empty_cache()
    row['graph_vs_eager'] = graph_row
    emit(row)
    check(all(np.isfinite(losses)), f'convnext_train: non-finite loss in {losses}')
    check(losses[-1] < losses[0], f'convnext_train: last loss {losses[-1]} not below {losses[0]}')
    check(adamw_steps == [1, 1] + [0] * (TRAIN_STEPS - 2),
          f'convnext_train: fused_adamw wrapper launches per step {adamw_steps}')
    check(flash_steps == [0] * TRAIN_STEPS, f'convnext_train: flash launches per step {flash_steps}')
    check(row['captures'] == 1, 'convnext_train: the step was not captured once')
    check(bool(kernels) and replayed['fused_adamw'] == 1 and replayed['flash_attention'] == 0,
          f'convnext_train: a replayed step ran {replayed}')
    check(fams['kernels'].get('depthwise_conv_fwd') == 36
          and fams['kernels'].get('depthwise_conv_bwd', 0) >= 72,
          f'convnext_train: depthwise kernels a step {fams["kernels"]}, want 36 forward and '
          'an input and a weight gradient a block')
    check(bool(torch.isfinite(g_card).all()), 'convnext_train: non-finite gradients on the card')
    check(grad_err <= GRAD_REL_L2_TOL, f'convnext_train: gradient rel L2 {grad_err} > {GRAD_REL_L2_TOL}')
    check(not graph_row['buffers_that_differ'],
          f'convnext_train: replays differ from eager steps in {graph_row["buffers_that_differ"]}')
    check(not graph_row['steps_whose_metrics_differ'],
          f'convnext_train: metrics differ at steps {graph_row["steps_whose_metrics_differ"]}')
    check(graph_row['skipped_steps'] == [CONVNEXT_NAN_STEP],
          f'convnext_train: the guard skipped steps {graph_row["skipped_steps"]}')
    check(graph_row['captures'] == 1 and graph_row['replays'] >= CONVNEXT_GRAPH_STEPS - 1,
          f'convnext_train: {graph_row["captures"]} captures, {graph_row["replays"]} replays')
    return launches


# the train driver under torch.profiler, in a process of its own: after a
# profiled driver run, the profiler of that process misses kernels of later
# sessions (seen on the card), so phase drivers' profiled run C stays last in
# this process and this run gets a fresh one. Its last stdout line is JSON.
_PROFILED_TRAIN = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke
from timm_tpu_torch import train
from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
from timm_tpu_torch.task.task import TrainingTask

def marked(fn):
    def step(*a, **kw):
        try:
            return fn(*a, **kw)
        finally:
            chip_smoke._mark()
    return step
TrainingTask.train_step = marked(TrainingTask.train_step)
TrainingTask.eval_step = marked(TrainingTask.eval_step)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    rc = train.main(sys.argv[1:])
    torch.cuda.synchronize()
counts = {}
for e in prof.events():
    if e.device_type == DeviceType.CUDA and not getattr(e, 'is_user_annotation', False):
        counts[e.name] = counts.get(e.name, 0) + 1
print(json.dumps({'rc': rc, 'counts': counts, 'per_call': chip_smoke._max_per_call(prof),
                  'launches': {k.__name__: k.launches
                               for k in (flash_attention, fused_adamw, augment_epilogue)}}))
"""


def phase_convnext_drivers():
    """``python -m timm_tpu_torch.train --model convnext_base``'s ``main(argv)``
    (one block a stage) under torch.profiler in a subprocess, from the seeded PNGs of
    ``_image_data`` (576 train, 192 validation): --device-augment with 'const' erasing and Mixup / CutMix,
    one epoch of 9 updates, EMA; each update and eval step marked off, the
    profiler must see one fused AdamW kernel an update and the
    augment-epilogue kernel beside the steps, and no flash kernel (the
    whole run's counts are reported and decide nothing). Then ``validate`` on its
    EMA weights in this process, whose loss must be within
    DRIVER_EVAL_REL_TOL of the run's last EMA evaluation."""
    import contextlib
    import csv
    import shutil
    import tempfile

    import torch

    from timm_tpu_torch import validate
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    kernels = (flash_attention, fused_adamw, augment_epilogue)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_convnext_')
    row = {'phase': 'convnext_drivers', 'model': CONVNEXT, 'dtype': 'bfloat16',
           'flags': ' '.join(CONVNEXT_DRIVER_FLAGS), 'wall_s': {}, 'launches': {}}
    try:
        data, out = _image_data(), os.path.join(tmp, 'out')
        n_train, n_val = _IMAGE_DATA['train'], _IMAGE_DATA['validation']
        updates = n_train // TRAIN_BATCH
        row.update(train_images=n_train, validation_images=n_val, updates=updates)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-c', _PROFILED_TRAIN, *CONVNEXT_DRIVER_FLAGS, '--data-dir', data,
             '--output', out, '--experiment', 'cnx'],
            capture_output=True, text=True, cwd=HERE, timeout=900)
        row['wall_s']['train_subprocess'] = time.perf_counter() - t0
        check(proc.returncode == 0, f'convnext_drivers: the train subprocess exited '
                                    f'{proc.returncode}: {proc.stderr[-2000:]}')
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        ran = _per_step(result['per_call'], 1)
        row['launches']['train'] = result['launches']
        row['train_kernels_per_call'] = ran
        row['train_kernels_ran_total'] = _per_step(result['counts'], 1)
        check(result['rc'] == 0, f'convnext_drivers: train exited {result["rc"]}')
        with open(os.path.join(out, 'cnx', 'summary.csv')) as f:
            rows = list(csv.DictReader(f))
        ema_loss = float(rows[-1]['eval_loss_ema'])
        row['final_ema_eval'] = {'loss': ema_loss, 'top1': float(rows[-1]['eval_top1_ema'])}
        row['train_loss'] = float(rows[-1]['train_loss'])
        eval_argv = ['--model', CONVNEXT, '--model-kwargs', CONVNEXT_DRIVER_KWARGS,
                     '--checkpoint', os.path.join(out, 'cnx', 'last.npz'),
                     '--use-ema', '--amp', '-b', '64', '--workers', '6', '--data-dir', data]
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            val = validate.validate(validate.parser.parse_args(eval_argv))
        row['wall_s']['validate'] = time.perf_counter() - t0
        row['launches']['validate'] = {k.__name__: k.launches for k in kernels}
        row['validate'] = {'loss': val['loss'], 'top1': val['top1'], 'img_per_s': val['img_per_s']}
        check(ran['fused_adamw'] == 1 and ran['augment_epilogue'] >= 1
              and ran['flash_attention'] == 0,
              f'convnext_drivers: the profiler saw {ran} in a step')
        check(abs(val['loss'] - ema_loss) <= DRIVER_EVAL_REL_TOL * abs(ema_loss),
              f'convnext_drivers: validate loss {val["loss"]} vs the EMA eval {ema_loss}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        emit(row)  # what was measured, also when a check failed
    torch.cuda.empty_cache()
    return {k.__name__: sum(r[k.__name__] for r in row['launches'].values()) for k in kernels}


# ---- EfficientNetV2-S: phases effnet_model, effnet_serve, effnet_train and
# effnet_drivers ----------------------------------------------------------------
EFFNET = 'efficientnetv2_s'
EFFNET_SIZE = 300                         # its cfg's input size
EFFNET_DROP_PATH, EFFNET_DROP_RATE = 0.2, 0.2
EFFNET_CALIB_BATCH = 8
# the scale of the last BatchNorm of every residual branch (see
# _damp_residual_branches)
EFFNET_BRANCH_SCALE = 0.1
# eval mode runs BatchNorm's whole chain in bf16, as JAX does: against the
# CPU in fp32 that lands further off than the train mode's fp32 chain
EFFNET_EVAL_FP32_TOL = 5e-2
EFFNET_FP32_TOL = 1e-4     # the card in fp32 (TF32 off) vs the CPU in fp32
EFFNET_BATCHNORMS = 110                   # the stem's, the blocks', the head's
# phase effnet_train's replayed step against its eager body: 5 steps, the
# 4th non-finite; these arms (accumulation 1 and 2, rmsproptf) run the
# model at its width and depth multiplier EFFNET_ARM_DEPTH, so that the
# whole script stays inside its time limit with the ViT-family phases
EFFNET_GRAPH_STEPS, EFFNET_NAN_STEP = 5, 4
EFFNET_ARM_DEPTH = 0.25
EFFNET_GRAD_BATCH = 4
EFFNET_DRIVER_KWARGS = 'depth_multiplier=0.25'
EFFNET_DRIVER_FLAGS = [
    '--model', EFFNET, '--model-kwargs', EFFNET_DRIVER_KWARGS, '--amp', '-b', '64', '--epochs', '1',
    '--opt', 'adamw', '--lr', '3e-4', '--weight-decay', '0.05', '--clip-grad', '1.0',
    '--sched', 'cosine', '--warmup-epochs', '0', '--drop-path', str(EFFNET_DROP_PATH),
    '--drop', str(EFFNET_DROP_RATE), '--smoothing', '0.1', '--mixup', '0.8', '--cutmix', '1.0',
    '--reprob', '0.25', '--remode', 'const', '--color-jitter', '0.4', '--device-augment',
    '--device-prefetch', '2', '--workers', '6', '--model-ema', '--model-ema-decay', '0.9998',
    '--checkpoint-hist', '1', '--seed', '0']
EFFNET_DRIVER_SIGTERM_AT = 4


def _running_stats(name: str, **kw) -> int:
    """Running-statistics tensors (means and variances) of model ``name``
    built with ``kw``, on the meta device."""
    import timm_tpu_torch
    model = timm_tpu_torch.create_model(name, device='meta', **kw)
    return sum(1 for n, _ in model.named_buffers() if n.endswith(('running_mean', 'running_var')))


def _calibrate_bn(model, x):
    """Running statistics set to one batch's: every BatchNorm's momentum 1
    for one train-mode forward of ``x`` without gradients, then restored.
    At init they are 0 and 1, which leave a random-weight network's
    activations unnormalised in eval mode, so an eval comparison would hold
    numbers far from any a trained model computes."""
    import torch
    from timm_tpu_torch.layers import BatchNorm2d
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    saved = [m.momentum for m in bns]
    was_training = model.training
    model.train()
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model(x)
    for m, momentum in zip(bns, saved):
        m.momentum = momentum
    return model.train(was_training)


def _damp_residual_branches(model, scale: float = EFFNET_BRANCH_SCALE):
    """The scale of the last BatchNorm of every residual branch set to
    ``scale``. At random init, with scale 1, a deep BatchNorm network is
    chaotic: rounding grows with depth, so bf16 lands far from fp32 on any
    device (phase effnet_model measures this on undamped weights: the
    ``undamped`` readings of its row), which a trained network's does not;
    zero-initialising these scales is the usual practice for residual
    BatchNorm networks. Copied in place, the same on every device."""
    import torch
    from timm_tpu_torch.models._efficientnet_blocks import ConvBnAct, EdgeResidual, InvertedResidual
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (ConvBnAct, EdgeResidual, InvertedResidual)) and m.has_skip:
                last = {ConvBnAct: 'bn1', EdgeResidual: 'bn2'}.get(type(m), 'bn3')
                getattr(m, last).weight.fill_(scale)
    return model


def _effnet(device, dtype=None, calibrate: bool = True, damp: bool = True, **kw):
    """efficientnetv2_s, seed-0 weights, with ``damp`` the residual
    branches damped; with ``calibrate``, its running statistics from a
    seeded batch of EFFNET_CALIB_BATCH images."""
    import torch
    import timm_tpu_torch
    model = timm_tpu_torch.create_model(EFFNET, dtype=dtype, seed=0, device=device, **kw)
    if damp:
        _damp_residual_branches(model)
    if calibrate:
        x = torch.from_numpy(_images(EFFNET_CALIB_BATCH, size=EFFNET_SIZE, seed=5)).to(device)
        _calibrate_bn(model, x)
    return model


def _batch_stats(model, before):
    """{key: the batch statistic that one train-mode forward blended into
    each running statistic}: (after - (1 - momentum) before) / momentum, in
    fp64 on the host, from the running statistics ``before`` that forward
    ({key: tensor}) and the model's after it."""
    from timm_tpu_torch.layers import BatchNorm2d
    after = model.state_dict()
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            for leaf in ('running_mean', 'running_var'):
                k = f'{name}.{leaf}'
                new = after[k].double().cpu()
                out[k] = ((new - (1.0 - m.momentum) * before[k].double().cpu())
                          / m.momentum).numpy()
    return out


def _stats_rel(a, b):
    """Relative L2 of the means and of the variances of ``a`` against
    ``b`` ({key: array}), each over all layers at once, and the layer with
    the largest absolute difference."""
    out = {}
    for leaf in ('running_mean', 'running_var'):
        keys = [k for k in b if k.endswith(leaf)]
        diff = {k: float(np.abs(a[k] - b[k]).max()) for k in keys}
        x = np.concatenate([a[k].ravel() for k in keys])
        y = np.concatenate([b[k].ravel() for k in keys])
        worst = max(diff, key=diff.get)
        out[leaf] = {'rel_l2': rel_l2(x, y), 'max_abs_diff_layer': worst,
                     'max_abs_diff': diff[worst]}
    return out


def _undamped_eval(x):
    """The witness for _damp_residual_branches: efficientnetv2_s with
    seed-0 weights as created (not damped), statistics calibrated on the
    CPU in fp32, in eval mode on ``x``; relative L2 of the logits of bf16
    on the card, bf16 on the CPU and fp32 on the CPU, pairwise."""
    import torch
    cpu = _effnet('cpu', damp=False)
    card = _effnet('cuda', torch.bfloat16, calibrate=False, damp=False)
    cpu_bf16 = _effnet('cpu', torch.bfloat16, calibrate=False, damp=False)
    for m in (card, cpu_bf16):
        m.load_state_dict(cpu.state_dict())
    logits = {}
    with torch.no_grad():
        for k, m in (('card_bf16', card), ('cpu_bf16', cpu_bf16), ('cpu_fp32', cpu)):
            xd = torch.from_numpy(x).to(next(m.parameters()).device)
            logits[k] = m.eval()(xd).float().cpu().numpy()
    del card, cpu, cpu_bf16
    return {'card_bf16_vs_cpu_bf16': rel_l2(logits['card_bf16'], logits['cpu_bf16']),
            'card_bf16_vs_cpu_fp32': rel_l2(logits['card_bf16'], logits['cpu_fp32']),
            'cpu_bf16_vs_cpu_fp32': rel_l2(logits['cpu_bf16'], logits['cpu_fp32']),
            'finite': all(bool(np.isfinite(v).all()) for v in logits.values())}


def phase_effnet_model():
    """efficientnetv2_s at full width and depth (stem 24, stages
    r2/r4/r4/r6/r9/r15, head 1280, 300 px), seed-0 weights with the
    residual branches damped, running statistics calibrated on the CPU, at
    batch 8. Eval mode (running statistics): bf16 on the card against bf16
    on the CPU within 2e-2 and against fp32 on the CPU within
    EFFNET_EVAL_FP32_TOL (eval runs BatchNorm's whole chain in bf16, as
    JAX), and the card in fp32 against the CPU in fp32 within
    EFFNET_FP32_TOL. Train mode (batch statistics): bf16 on the card
    against fp32 on the CPU within 2e-2, and the batch statistics that
    forward blended into the running ones (recovered from the running
    statistics before and after it) within 2e-2. Last, the same eval
    comparisons on undamped weights, recorded as the damping's witness."""
    import torch
    x = _images(8, size=EFFNET_SIZE)
    cpu = _effnet('cpu')
    models = {'card_bf16': ('cuda', torch.bfloat16), 'cpu_bf16': ('cpu', torch.bfloat16),
              'card_fp32': ('cuda', None)}
    models = {k: _effnet(d, t, calibrate=False) for k, (d, t) in models.items()}
    for m in models.values():
        m.load_state_dict(cpu.state_dict())
    models['cpu_fp32'] = cpu
    card = models['card_bf16']
    before = {k: v.clone() for k, v in cpu.state_dict().items() if k.endswith(('_mean', '_var'))}
    row = {'phase': 'effnet_model', 'model': EFFNET, 'batch': 8, 'size': EFFNET_SIZE,
           'dtype': 'bfloat16', 'params': sum(p.numel() for p in card.parameters()),
           'leaves': len(list(card.parameters())),
           'batchnorms': sum(1 for n in card.state_dict() if n.endswith('running_mean')),
           'branch_scale': EFFNET_BRANCH_SCALE, 'tol': MODEL_REL_L2_TOL,
           'eval_fp32_tol': EFFNET_EVAL_FP32_TOL, 'fp32_tol': EFFNET_FP32_TOL}
    logits = {}
    with torch.no_grad():
        for mode in ('eval', 'train'):
            for k, m in models.items():
                if mode == 'train' and k in ('cpu_bf16', 'card_fp32'):
                    continue
                m.train(mode == 'train')
                xd = torch.from_numpy(x).to(next(m.parameters()).device)
                t0 = time.perf_counter()
                logits[mode, k] = m(xd).float().cpu().numpy()
                row[f'{mode}_{k}_seconds'] = time.perf_counter() - t0
    for (mode, k), v in logits.items():
        check(v.shape == (8, 1000), f'effnet_model: {mode} {k} logits shape {v.shape}')
    row.update(
        eval_rel_l2_card_bf16_vs_cpu_bf16=rel_l2(logits['eval', 'card_bf16'],
                                                 logits['eval', 'cpu_bf16']),
        eval_rel_l2_vs_cpu_fp32=rel_l2(logits['eval', 'card_bf16'], logits['eval', 'cpu_fp32']),
        eval_rel_l2_cpu_bf16_vs_cpu_fp32=rel_l2(logits['eval', 'cpu_bf16'],
                                                logits['eval', 'cpu_fp32']),
        eval_rel_l2_card_fp32_vs_cpu_fp32=rel_l2(logits['eval', 'card_fp32'],
                                                 logits['eval', 'cpu_fp32']),
        train_rel_l2_vs_cpu_fp32=rel_l2(logits['train', 'card_bf16'], logits['train', 'cpu_fp32']),
        finite=all(bool(np.isfinite(v).all()) for v in logits.values()))
    stats = _stats_rel(_batch_stats(card, before), _batch_stats(cpu, before))
    row['batch_stats_of_train_forward'] = stats
    del card, cpu, models
    t0 = time.perf_counter()
    row['undamped_eval_rel_l2'] = _undamped_eval(x)
    row['undamped_seconds'] = time.perf_counter() - t0
    emit(row)
    check(row['finite'], 'effnet_model: non-finite logits')
    for key, tol in (('eval_rel_l2_card_bf16_vs_cpu_bf16', MODEL_REL_L2_TOL),
                     ('eval_rel_l2_vs_cpu_fp32', EFFNET_EVAL_FP32_TOL),
                     ('eval_rel_l2_card_fp32_vs_cpu_fp32', EFFNET_FP32_TOL),
                     ('train_rel_l2_vs_cpu_fp32', MODEL_REL_L2_TOL)):
        check(row[key] <= tol, f'effnet_model: {key} {row[key]} > {tol}')
    for leaf, r in stats.items():
        check(r['rel_l2'] <= MODEL_REL_L2_TOL,
              f'effnet_model: batch {leaf} of a train forward rel L2 {r["rel_l2"]} > '
              f'{MODEL_REL_L2_TOL}')
    check(row['undamped_eval_rel_l2']['finite'], 'effnet_model: non-finite undamped logits')
    torch.cuda.empty_cache()


def phase_effnet_serve():
    """The engine serving efficientnetv2_s in bf16 (running statistics
    calibrated on the card): ``_graph_serve``."""
    import torch
    _graph_serve('effnet_serve', EFFNET, lambda: _effnet('cuda', torch.bfloat16), EFFNET_SIZE)


def _graph_serve(phase: str, name: str, factory, size: int, flash_per_forward: int = 0):
    """The engine serving model ``name`` (``factory`` builds it on the
    card), one CUDA graph per bucket captured at add_model, in eval mode:
    200 requests of ``size`` px images in the bursts of phase serve; served
    rows against their direct forward; each bucket's replay bit for bit
    against an eager forward; eager and replayed forward ms per bucket;
    under torch.profiler 3 replays of bucket 64 by kernel family, with the
    idle share. With ``flash_per_forward`` 0 no kernel of the port lies on
    the path and the wrappers' counts must not move; else each bucket graph
    captured that many flash launches, only the flash wrapper moved (at the
    prewarm) and a profiled replay runs that many flash kernels."""
    import torch
    from timm_tpu_torch import InferenceEngine
    from timm_tpu_torch.kernels import registry
    from timm_tpu_torch.kernels.harness import time_ms
    counters = registry.launch_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    n = sum(SERVE_BURSTS)
    images = _images(n, size=size, seed=1)
    engine = InferenceEngine(buckets=SERVE_BUCKETS, max_wait_ms=5.0, device='cuda')
    engine.add_model(name, factory=factory)
    engine.start()
    futures, submitted, wall = _serve_bursts(engine, images)
    engine.shutdown(drain=True)
    stats = engine.snapshot_stats()
    served = np.stack([f.result() for f in futures])
    lat_ms = np.array([(f.done_at - s) * 1e3 for f, s in zip(futures, submitted)])
    res = engine.pool.acquire(name)
    model, graphs = res.model, engine.aot_executables(name)
    per_bucket, replay_equal = {}, {}
    with torch.inference_mode():
        direct = np.concatenate([
            model(torch.from_numpy(images[j:j + 8]).cuda()).float().cpu().numpy()
            for j in range(0, n, 8)])
        for b in SERVE_BUCKETS:
            x = torch.from_numpy(_images(b, size=size, seed=10 + b))
            replayed = graphs[b].run(x.pin_memory())
            eager = model(x.cuda()).float()
            replay_equal[str(b)] = bool(torch.equal(replayed, eager))
            xc = x.cuda()
            graphs[b].static_in.copy_(xc)
            eager_ms = time_ms(lambda: model(xc), iters=5, warmup=1)
            replay_ms = time_ms(graphs[b].graph.replay, iters=10, warmup=2)
            per_bucket[str(b)] = {'forward_ms': eager_ms, 'replay_ms': replay_ms,
                                  'replay_img_per_s': b / replay_ms * 1e3}
        reps = 3
        graphs[64].static_in.copy_(torch.from_numpy(_images(64, size=size, seed=3)).cuda())
        kernels, counts, replay_wall_ms = _profile_kernels(graphs[64].graph.replay, reps)
    busy = sum(kernels.values())
    fams = _families(kernels, counts)
    errs = [rel_l2(served[j], direct[j]) for j in range(n)]
    prewarm = stats['prewarm'][name]
    moved = {k: fn.launches - before[k] for k, fn in counters.items() if fn.launches != before[k]}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    emit({'phase': phase, 'model': name, 'size': size, 'dtype': 'bfloat16',
          'requests': n, 'completed': stats['completed'], 'failed': stats['failed'],
          'training_mode': model.training,
          'steps_by_bucket': stats['steps_by_bucket'],
          'replays_by_bucket': stats['replays_by_bucket'],
          'p50_ms': float(np.percentile(lat_ms, 50)), 'p99_ms': float(np.percentile(lat_ms, 99)),
          'img_per_s': n / wall, 'wall_s': wall, 'per_bucket': per_bucket,
          'max_rel_l2_vs_direct': max(errs), 'tol': SERVE_REL_L2_TOL,
          'prewarm_ms': prewarm['ms'], 'graph_bytes': prewarm['graph_bytes'],
          'replay_equals_eager_bit_for_bit': replay_equal, 'wrapper_launches': moved,
          'profiled_bucket': 64, 'replay_wall_ms': replay_wall_ms,
          'replay_device_ms': busy if kernels else 'not measured',
          'replay_idle_share': 1.0 - busy / replay_wall_ms if kernels else 'not measured',
          'replay_kernels_per_forward': sum(counts.values()) if kernels
          else 'not measured',
          'replay_ms_by_family': fams['ms'], 'replay_kernels_by_family': fams['kernels'],
          'top_kernels': [{'kernel': k[:120], 'ms': v} for k, v in top]})
    check(not model.training, f'{phase}: the served model is in training mode')
    check(stats['completed'] == n and stats['failed'] == 0,
          f'{phase}: {stats["failed"]} failed requests')
    check(set(stats['steps_by_bucket']) == set(SERVE_BUCKETS),
          f'{phase}: buckets dispatched {stats["steps_by_bucket"]}')
    check(stats['replays_by_bucket'] == stats['steps_by_bucket'],
          f'{phase}: replays {stats["replays_by_bucket"]} for steps {stats["steps_by_bucket"]}')
    check(prewarm['mode'] == 'graph' and prewarm['programs'] == len(SERVE_BUCKETS),
          f'{phase}: prewarm captured {prewarm["programs"]} graphs ({prewarm["mode"]})')
    if flash_per_forward:
        captured = [g.launches for g in graphs.values()]
        replayed_flash = sum(c for k, c in counts.items() if 'flash_fwd_kernel' in k)
        check(all(c == {'flash_attention': flash_per_forward} for c in captured),
              f'{phase}: the bucket graphs captured {captured}')
        check(set(moved) == {'flash_attention'}
              and moved['flash_attention'] >= flash_per_forward * len(SERVE_BUCKETS),
              f'{phase}: wrapper launches {moved} at the prewarm')
        check(replayed_flash == flash_per_forward,
              f'{phase}: a profiled replay ran {replayed_flash} flash kernels')
    else:
        check(not moved, f'{phase}: the port\'s kernels launched {moved}')
    check(bool(np.isfinite(served).all()), f'{phase}: non-finite logits')
    check(max(errs) <= SERVE_REL_L2_TOL, f'{phase}: max rel L2 {max(errs)} > {SERVE_REL_L2_TOL}')
    check(all(replay_equal.values()), f'{phase}: replay vs eager bit for bit: {replay_equal}')
    check(bool(kernels), f'{phase}: the profiler saw no kernel of the replays')
    del engine, res, model, graphs
    gc.collect()
    torch.cuda.empty_cache()
    return moved


def _effnet_module_families(x):
    """efficientnetv2_s's module families alone at a train step's shapes:
    ``_module_families``, with its SE modules a family of their own."""
    import torch
    return _module_families(_effnet('cuda', torch.bfloat16, calibrate=False), x,
                            ('batchnorm_act', 'depthwise_conv', 'other_conv', 'squeeze_excite'))


def _module_families(model, x, names):
    """Device ms of a model's module families alone at a train step's
    shapes (bf16, train mode, batch of ``x``): every BatchNormAct2d (batch
    statistics, running-statistics update, normalisation and activation),
    the depthwise convolutions, the other convolutions and the SE modules
    (those of ``names``), each family's modules run on the inputs one
    forward gave them, forward alone and forward + backward (input and
    parameter gradients against a seeded upstream gradient), from
    CUDA-graph replays (``harness.graph_ms``), with each family's bound
    (bytes: every input read and output written once, forward and backward;
    operations for the convolutions: 2 k^2 C_in/g a output element forward,
    twice that backward)."""
    import torch
    from timm_tpu_torch.kernels.harness import graph_ms
    from timm_tpu_torch.kernels.registry import PEAK_BYTES_PER_S, PEAK_OPS_PER_S
    from timm_tpu_torch.layers import BatchNormAct2d, Conv2d, SEModule
    model = model.train()
    pairs = {f: [] for f in names}

    def family(m):
        if isinstance(m, BatchNormAct2d):
            f = 'batchnorm_act'
        elif isinstance(m, Conv2d):
            f = 'depthwise_conv' if m.groups == m.in_channels > 1 else 'other_conv'
        else:
            f = 'squeeze_excite' if isinstance(m, SEModule) else None
        return f if f in pairs else None

    hooks = []
    for m in model.modules():
        f = family(m)
        if f is not None:
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, f=f: pairs[f].append((mod, inp[0].detach().clone()))))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    g = torch.Generator(device='cuda').manual_seed(3)
    rows = {}
    for f, mods in pairs.items():
        xs = [x_.requires_grad_(True) for _, x_ in mods]
        with torch.no_grad():
            outs = [m(x_) for (m, _), x_ in zip(mods, xs)]
        dys = [torch.randn(o.shape, generator=g, device='cuda').to(o.dtype) for o in outs]
        params = [p for m, _ in mods for p in m.parameters()]
        bound = 0.0
        for (m, _), x_, o in zip(mods, xs, outs):
            act = (x_.numel() + o.numel()) * x_.element_size()
            if isinstance(m, Conv2d):
                ops = 2 * o.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
                wbytes = m.weight.numel() * 2
                bound += max((act + wbytes) / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S['bfloat16'])
                bound += max((act + x_.numel() * 2 + 2 * wbytes) / PEAK_BYTES_PER_S,
                             2 * ops / PEAK_OPS_PER_S['bfloat16'])
            else:
                bound += (act + act + x_.numel() * x_.element_size()) / PEAK_BYTES_PER_S
        del outs

        def forward():
            with torch.no_grad():
                for (m, _), x_ in zip(mods, xs):
                    m(x_)

        def forward_backward():
            ys = [m(x_) for (m, _), x_ in zip(mods, xs)]
            torch.autograd.grad(ys, xs + params, dys)
        rows[f] = {'modules': len(mods), 'input_elements': sum(x_.numel() for x_ in xs),
                   'fwd_ms': graph_ms(forward, per_graph=1, replays=5),
                   'fwd_bwd_ms': graph_ms(forward_backward, per_graph=1, replays=5),
                   'fwd_bwd_bound_ms': bound * 1e3}
        del xs, dys, params
        torch.cuda.empty_cache()
    del model, pairs
    torch.cuda.empty_cache()
    return rows


def phase_effnet_train():
    """ClassificationTask on efficientnetv2_s (bf16 compute, fp32
    parameters) with drop path 0.2 and dropout 0.2, label smoothing 0.1,
    AdamW (wd 0.05 with the mask), clip 1.0, EMA 0.9998, cosine with 3
    warmup steps: 20 steps at batch 64 of 300 px images on one fixed batch,
    steps 3-20 replays of one graph; the wrappers' counts per step; under
    the profiler 3 more replayed steps by kernel family with the idle
    share; the module families alone at the step's shapes. Then one step's
    gradients, bf16 on the card against fp32 on the CPU at batch 4 (drop
    path and dropout 0), and the replayed step against its eager body bit
    for bit, running statistics included, over 5 steps from one state (the
    4th non-finite), without and with gradient accumulation 2."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels import flash_attention, fused_adamw
    drops = {'drop_rate': EFFNET_DROP_RATE}
    task = _train_task(0, 'cuda', torch.bfloat16, EFFNET_DROP_PATH, clip_grad=1.0,
                       model_name=EFFNET, model_kw=drops)
    task.setup_ema(decay=0.9998)
    sched, _ = timm_tpu_torch.create_scheduler_v2(
        TRAIN_LR, 'cosine', num_epochs=TRAIN_STEPS, warmup_epochs=3, warmup_lr=1e-6)
    batch = _train_batch(TRAIN_BATCH, 4, 'cuda', size=EFFNET_SIZE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flash_attention.launches = fused_adamw.launches = 0
    metrics, adamw_steps, flash_steps = [], [], []
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        if step == TRAIN_WARMUP_STEPS:
            start.record()
        f0, a0 = flash_attention.launches, fused_adamw.launches
        metrics.append(task.train_step(batch, lr=sched.step(step)[0], step=step + 1))
        flash_steps.append(flash_attention.launches - f0)
        adamw_steps.append(fused_adamw.launches - a0)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'flash_attention': flash_attention.launches, 'fused_adamw': fused_adamw.launches}
    step_ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    stats_finite = all(bool(torch.isfinite(b).all()) for b in _model_buffers(task).values())
    reps = 3
    kernels, counts, prof_wall_ms = _profile_kernels(
        lambda: task.train_step(batch, lr=1e-5, step=TRAIN_STEPS + 1), reps)
    replayed = _per_step(counts)
    busy = sum(kernels.values())
    fams = _families(kernels, counts)
    adamw_ms = sum(v for k, v in kernels.items() if 'fused_adamw' in k)
    losses = [float(m['loss']) for m in metrics]
    row = {'phase': 'effnet_train', 'model': EFFNET, 'size': EFFNET_SIZE, 'dtype': 'bfloat16',
           'batch': TRAIN_BATCH, 'steps': TRAIN_STEPS, 'drop_path_rate': EFFNET_DROP_PATH,
           'drop_rate': EFFNET_DROP_RATE,
           'losses': losses, 'grad_norms': [float(m['grad_norm']) for m in metrics],
           'running_stats_finite': stats_finite,
           'step_ms': step_ms, 'img_per_s': TRAIN_BATCH / step_ms * 1e3, 'wall_s': wall,
           'peak_memory_gb': peak_gb, 'graph_pool_bytes': task.train_graphs.pool_bytes(),
           'graph_static_input_bytes': task.train_graphs.static_bytes(),
           'captures': task.train_graphs.captures, 'replays': task.train_graphs.replays,
           'wrapper_fused_adamw_launches_per_step': adamw_steps,
           'wrapper_flash_launches_per_step': flash_steps, 'launches': launches,
           'profiled_replays': reps, 'replayed_kernels_per_step': replayed if kernels else
           'not measured', 'replay_wall_ms_per_step': prof_wall_ms,
           'replay_device_ms_per_step': busy if kernels else 'not measured',
           'replay_idle_share': 1.0 - busy / prof_wall_ms if kernels else 'not measured',
           'replay_ms_by_family': fams['ms'], 'replay_kernels_by_family': fams['kernels'],
           'top_kernels': [{'kernel': k[:120], 'ms': v}
                           for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]]}
    del task
    gc.collect()
    torch.cuda.empty_cache()

    # the module families alone, at the step's shapes
    # (alone, a family also computes what the step skips, such as the
    # stem's input gradient, so the shares are each an upper bound)
    modules = _effnet_module_families(batch['input'])
    row['module_families_alone'] = modules
    row['family_alone_share_of_step_device_ms'] = (
        {f: r['fwd_bwd_ms'] / busy for f, r in modules.items()} if kernels else 'not measured')
    row['fused_adamw_replayed_ms'] = adamw_ms

    # one step's gradients, bf16 on the card against fp32 on the CPU
    grad_batch = _train_batch(EFFNET_GRAD_BATCH, 5, 'cpu', size=EFFNET_SIZE)
    grads = {}
    for device, dtype in (('cuda', torch.bfloat16), ('cpu', None)):
        t = _train_task(0, device, dtype, 0.0, nonfinite_guard=False, model_name=EFFNET)
        t.train_step(grad_batch, lr=0.0, step=1)
        grads[device] = t.optimizer.flat_grad.float().cpu()
        del t
    torch.cuda.empty_cache()
    g_card, g_cpu = grads['cuda'], grads['cpu']
    grad_err = float((g_card - g_cpu).norm() / g_cpu.norm())
    row.update(grad_batch=EFFNET_GRAD_BATCH, grad_rel_l2_bf16_card_vs_fp32_cpu=grad_err,
               grad_tol=GRAD_REL_L2_TOL, grads_finite=bool(torch.isfinite(g_card).all()))

    # the replayed step against its eager body, from one state
    batches = [_train_batch(TRAIN_BATCH, 60 + i, 'cuda', size=EFFNET_SIZE) for i in range(2)]
    nan_batch = dict(batches[0], input=batches[0]['input'].clone())
    nan_batch['input'][5, 50, 50, 2] = float('nan')
    row['graph_vs_eager'] = []
    arm_kw = dict(drops, depth_multiplier=EFFNET_ARM_DEPTH)
    for accum in (1, 2):
        graph_row, task = _graph_vs_eager(
            'adamw', accum, batches, nan_batch, False, model_name=EFFNET,
            steps=EFFNET_GRAPH_STEPS, nan_step=EFFNET_NAN_STEP, drop_path_rate=EFFNET_DROP_PATH,
            model_kw=arm_kw)
        graph_row['running_stats_compared'] = len(_model_buffers(task))
        del task
        gc.collect()
        torch.cuda.empty_cache()
        row['graph_vs_eager'].append(graph_row)
    # timm's EfficientNet recipe: rmsproptf (eps 1e-3, momentum 0.9, weight
    # decay 1e-5) on the step schedule, 20 replayed steps against the eager body
    rms_row, task = _graph_vs_eager(
        'rmsproptf', 1, batches, nan_batch, False, model_name=EFFNET, steps=TRAIN_STEPS,
        nan_step=EFFNET_NAN_STEP, drop_path_rate=EFFNET_DROP_PATH, model_kw=arm_kw,
        **EFFNET_RMSPROP)
    rms_row['running_stats_compared'] = len(_model_buffers(task))
    del task
    gc.collect()
    torch.cuda.empty_cache()
    row['rmsproptf_graph_vs_eager'] = rms_row
    emit(row)
    check(all(np.isfinite(losses)), f'effnet_train: non-finite loss in {losses}')
    check(losses[-1] < losses[0], f'effnet_train: last loss {losses[-1]} not below {losses[0]}')
    check(stats_finite, 'effnet_train: non-finite running statistics')
    check(adamw_steps == [1, 1] + [0] * (TRAIN_STEPS - 2),
          f'effnet_train: fused_adamw wrapper launches per step {adamw_steps}')
    check(flash_steps == [0] * TRAIN_STEPS, f'effnet_train: flash launches per step {flash_steps}')
    check(row['captures'] == 1, 'effnet_train: the step was not captured once')
    check(bool(kernels) and replayed['fused_adamw'] == 1 and replayed['flash_attention'] == 0,
          f'effnet_train: a replayed step ran {replayed}')
    check(bool(torch.isfinite(g_card).all()), 'effnet_train: non-finite gradients on the card')
    check(grad_err <= GRAD_REL_L2_TOL, f'effnet_train: gradient rel L2 {grad_err} > {GRAD_REL_L2_TOL}')
    for graph_row in row['graph_vs_eager'] + [rms_row]:
        arm = (f'effnet_train ({graph_row["optimizer"]}, accumulation '
               f'{graph_row["grad_accum_steps"]})')
        want_stats = _running_stats(EFFNET, depth_multiplier=EFFNET_ARM_DEPTH)
        check(graph_row['running_stats_compared'] == want_stats,
              f'{arm}: {graph_row["running_stats_compared"]} statistics compared, want {want_stats}')
        check(not graph_row['buffers_that_differ'],
              f'{arm}: replays differ from eager steps in {graph_row["buffers_that_differ"]}')
        check(not graph_row['steps_whose_metrics_differ'],
              f'{arm}: metrics differ at steps {graph_row["steps_whose_metrics_differ"]}')
        check(graph_row['skipped_steps'] == [EFFNET_NAN_STEP],
              f'{arm}: the guard skipped steps {graph_row["skipped_steps"]}')
        check(graph_row['captures'] == 1 and graph_row['replays'] >= EFFNET_GRAPH_STEPS - 1,
              f'{arm}: {graph_row["captures"]} captures, {graph_row["replays"]} replays')
    check(rms_row['replays'] >= TRAIN_STEPS - 2 and np.isfinite(rms_row['losses'][-1]),
          f'effnet_train (rmsproptf): {rms_row["replays"]} replays, losses {rms_row["losses"]}')
    return launches


def phase_effnet_drivers():
    """``python -m timm_tpu_torch.train --model efficientnetv2_s``'s
    ``main(argv)`` (depth multiplier 0.25) from the seeded PNGs of ``_image_data`` (576 train, 192
    validation): --device-augment
    with 'const' erasing (the augment-epilogue kernel) and Mixup / CutMix,
    drop path and dropout 0.2, EMA, one epoch of 9 updates: run A
    uninterrupted, run B stopped by SIGTERM after update 4 and run C
    resumed from it with --resume auto; C's last.npz held to A's bit for bit
    (weights, EMA, optimizer state and running statistics). Then
    ``validate`` on A's EMA weights and statistics, whose loss must be
    within DRIVER_EVAL_REL_TOL of A's last EMA evaluation. The wrappers'
    counts are read around each run."""
    import csv
    import shutil
    import tempfile

    import torch

    from timm_tpu_torch import train, validate
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    kernels = (flash_attention, fused_adamw, augment_epilogue)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_effnet_')
    row = {'phase': 'effnet_drivers', 'model': EFFNET, 'dtype': 'bfloat16',
           'flags': ' '.join(EFFNET_DRIVER_FLAGS), 'sigterm_at': EFFNET_DRIVER_SIGTERM_AT,
           'wall_s': {}, 'launches': {}}

    try:
        data, out = _image_data(), os.path.join(tmp, 'out')
        n_train, n_val = _IMAGE_DATA['train'], _IMAGE_DATA['validation']
        updates = n_train // TRAIN_BATCH
        row.update(train_images=n_train, validation_images=n_val, updates=updates)

        def train_argv(experiment, *extra):
            return EFFNET_DRIVER_FLAGS + ['--data-dir', data, '--output', out,
                                          '--experiment', experiment, *extra]
        for name, argv in (('a', train_argv('a')),
                           ('b', train_argv('b', '--fault-inject',
                                            f'sigterm@{EFFNET_DRIVER_SIGTERM_AT}')),
                           ('c', train_argv('b', '--resume', 'auto'))):
            rc, wall, launches = _run_driver(train.main, argv, kernels)
            row['wall_s'][name], row['launches'][name] = wall, launches
            check(rc == 0, f'effnet_drivers: run {name.upper()} exited {rc}')
            check(launches['fused_adamw'] >= 1 and launches['augment_epilogue'] >= 1
                  and launches['flash_attention'] == 0,
                  f'effnet_drivers: run {name.upper()} wrapper launches {launches}')
        with open(os.path.join(out, 'a', 'summary.csv')) as f:
            rows = list(csv.DictReader(f))
        ema_loss = float(rows[-1]['eval_loss_ema'])
        row['final_ema_eval'] = {'loss': ema_loss, 'top1': float(rows[-1]['eval_top1_ema'])}
        ckpt_a = _checkpoint_groups(os.path.join(out, 'a', 'last.npz'))
        ckpt_c = _checkpoint_groups(os.path.join(out, 'b', 'last.npz'))
        c_vs_a = _max_diff(ckpt_c, ckpt_a)
        row['running_statistics_in_checkpoint'] = len(ckpt_a['model_state'])
        row['resumed_vs_uninterrupted'] = {g: {'tensors_differ': n, 'max_abs_diff': d}
                                           for g, (n, d) in c_vs_a.items()}
        del ckpt_a, ckpt_c
        eval_argv = ['--model', EFFNET, '--model-kwargs', EFFNET_DRIVER_KWARGS,
                     '--checkpoint', os.path.join(out, 'a', 'last.npz'),
                     '--use-ema', '--amp', '-b', '64', '--workers', '6', '--data-dir', data]
        val, wall, launches = _run_driver(
            lambda argv: validate.validate(validate.parser.parse_args(argv)), eval_argv, kernels)
        row['wall_s']['validate'], row['launches']['validate'] = wall, launches
        row['validate'] = {'loss': val['loss'], 'top1': val['top1'], 'img_per_s': val['img_per_s']}
        want_stats = _running_stats(EFFNET, depth_multiplier=0.25)
        check(row['running_statistics_in_checkpoint'] == want_stats,
              f'effnet_drivers: {row["running_statistics_in_checkpoint"]} statistics in last.npz, '
              f'want {want_stats}')
        check(all(n == 0 for n, _ in c_vs_a.values()),
              f'effnet_drivers: the resumed last.npz differs from the uninterrupted one: {c_vs_a}')
        check(abs(val['loss'] - ema_loss) <= DRIVER_EVAL_REL_TOL * abs(ema_loss),
              f'effnet_drivers: validate loss {val["loss"]} vs the EMA eval {ema_loss}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        emit(row)  # what was measured, also when a check failed
    torch.cuda.empty_cache()
    return {k.__name__: sum(r[k.__name__] for r in row['launches'].values()) for k in kernels}


# ---- ResNet-50: phases resnet_model, resnet_serve, resnet_train and
# resnet_drivers --------------------------------------------------------------------
RESNET = 'resnet50'
RESNET_SIZE = 224                         # its cfg's input size
RESNET_POOL_SIZE = 288                    # validate --test-pool: above the default
RESNET_BATCHNORMS = 53                    # the stem's, the blocks', the downsamples'
# zero_init_last zeroes every block's last BatchNorm scale, so each block
# starts as its shortcut; these phases set those scales to this value so the
# residual branches are exercised, as EFFNET_BRANCH_SCALE does for
# EfficientNetV2-S
RESNET_BRANCH_SCALE = 0.1
RESNET_CALIB_BATCH = 8
# phase resnet_train: timm's ResNet SGD recipe (Nesterov momentum 0.9,
# weight decay 1e-4 as the JAX factory's masked coupled L2, lr 0.05 cosine)
RESNET_LR, RESNET_WD = 0.05, 1e-4
RESNET_SPLITS, RESNET_SPLIT_BATCH = 3, 32  # split BN: 3 splits of 32
RESNET_GRAPH_STEPS, RESNET_NAN_STEP = 5, 4
RESNET_GRAD_BATCH = 4
# one step's gradients at batch 4 of a random ResNet-50 are ill-conditioned:
# train-mode BatchNorm over 4 images amplifies rounding (on a narrow
# ResNet-50 on the CPU, fp32 lands 1.8e-3 from fp64, bf16 0.30, and JAX's
# own bf16 0.28 from its fp32). So the card is held in fp32 to the CPU's
# fp32 within RESNET_GRAD_TOL, and in bf16 no farther from the CPU's fp32
# than RESNET_GRAD_BF16_SLACK times the CPU's own bf16 flow (or
# GRAD_REL_L2_TOL)
RESNET_GRAD_TOL = 1e-2
RESNET_GRAD_BF16_SLACK = 1.25
# every optimizer name this slice adds: 5 steps in the captured step (batch
# RESNET_OPT_BATCH) against the eager body, and one update on the card
# against the CPU in fp32 (TF32 off), each leaf within RESNET_OPT_TOL
# relative L2
RESNET_NEW_OPTIMIZERS = (
    'rmsprop', 'rmsproptf', 'adam', 'nadam', 'radam', 'adamax', 'adabelief', 'lion', 'lars',
    'adopt', 'adan', 'adafactor', 'adafactorbv', 'novograd', 'nvnovograd', 'yogi', 'sm3',
    'adadelta', 'adagrad', 'sgdw', 'sgdp', 'momentum', 'adamp', 'lookahead')
RESNET_OPT_BATCH, RESNET_OPT_STEPS = 8, 5
# the optimizer arms' resnet50 cut to one bottleneck a stage (the widths and
# every kind of leaf kept), so that the whole script stays inside its time
# limit with the NaFlex phases
RESNET_OPT_LAYERS = (1, 1, 1, 1)
RESNET_OPT_TOL = 1e-5
# timm's ResNet-50 JSD + RandAugment recipe (without --resplit and
# --dist-bn, which the JAX script lacks), with EMA for the validate check
RESNET_DRIVER_KWARGS = 'layers=[1,1,1,1]'
RESNET_DRIVER_FLAGS = [
    '--model', RESNET, '--model-kwargs', RESNET_DRIVER_KWARGS, '-b', '64', '--epochs', '1',
    '--aug-splits', '3', '--jsd-loss',
    '--split-bn', '--aa', 'rand-m9-mstd0.5-inc1', '--remode', 'pixel', '--reprob', '0.6',
    '--sched', 'cosine', '--lr', '0.05', '--amp', '--workers', '6',
    '--model-ema', '--model-ema-decay', '0.9998', '--checkpoint-hist', '1', '--seed', '0']
RESNET_DRIVER_SIGTERM_AT = 4
# phase effnet_train's rmsproptf arm: timm's EfficientNet recipe
EFFNET_RMSPROP = dict(opt_kw={'eps': 1e-3, 'momentum': 0.9}, weight_decay=1e-5, lr=0.016,
                      sched_kw=dict(sched='step', num_epochs=TRAIN_STEPS, decay_epochs=2.4,
                                    decay_rate=0.97, warmup_epochs=3, warmup_lr=1e-6))


def _damp_resnet(model, scale: float = RESNET_BRANCH_SCALE):
    """The last BatchNorm scale of every block (bn2 of a BasicBlock, bn3 of
    a Bottleneck) set to ``scale`` in place (see RESNET_BRANCH_SCALE)."""
    import torch
    from timm_tpu_torch.models.resnet import BasicBlock, Bottleneck
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BasicBlock, Bottleneck)):
                (m.bn2 if isinstance(m, BasicBlock) else m.bn3).weight.fill_(scale)
    return model


def _resnet(device, dtype=None, calibrate: bool = True, **kw):
    """resnet50, seed-0 weights, the residual branches damped; with
    ``calibrate``, its running statistics from a seeded batch."""
    import torch
    import timm_tpu_torch
    model = _damp_resnet(timm_tpu_torch.create_model(RESNET, dtype=dtype, seed=0, device=device,
                                                     **kw))
    if calibrate:
        x = torch.from_numpy(_images(RESNET_CALIB_BATCH, size=RESNET_SIZE, seed=5)).to(device)
        _calibrate_bn(model, x)
    return model


def phase_resnet_model():
    """resnet50 at full width and depth (224 px, 25,557,032 parameters in
    161 leaves, 53 BatchNorms), the residual branches damped, running
    statistics calibrated on the CPU, batch 8. Eval mode: bf16 on the card
    against fp32 on the CPU within EFFNET_EVAL_FP32_TOL, and the card in
    fp32 against the CPU in fp32 within EFFNET_FP32_TOL; train mode (batch
    statistics): bf16 on the card against fp32 on the CPU within 2e-2, and
    the batch statistics that forward blended in within 2e-2."""
    import torch
    x = _images(8, size=RESNET_SIZE)
    cpu = _resnet('cpu')
    models = {'card_bf16': ('cuda', torch.bfloat16), 'card_fp32': ('cuda', None)}
    models = {k: _resnet(d, t, calibrate=False) for k, (d, t) in models.items()}
    for m in models.values():
        m.load_state_dict(cpu.state_dict())
    models['cpu_fp32'] = cpu
    card = models['card_bf16']
    before = {k: v.clone() for k, v in cpu.state_dict().items() if k.endswith(('_mean', '_var'))}
    row = {'phase': 'resnet_model', 'model': RESNET, 'batch': 8, 'size': RESNET_SIZE,
           'dtype': 'bfloat16', 'params': sum(p.numel() for p in card.parameters()),
           'leaves': len(list(card.parameters())),
           'batchnorms': sum(1 for n in card.state_dict() if n.endswith('running_mean')),
           'branch_scale': RESNET_BRANCH_SCALE, 'tol': MODEL_REL_L2_TOL,
           'eval_fp32_tol': EFFNET_EVAL_FP32_TOL, 'fp32_tol': EFFNET_FP32_TOL}
    logits = {}
    with torch.no_grad():
        for mode in ('eval', 'train'):
            for k, m in models.items():
                if mode == 'train' and k == 'card_fp32':
                    continue
                m.train(mode == 'train')
                xd = torch.from_numpy(x).to(next(m.parameters()).device)
                t0 = time.perf_counter()
                logits[mode, k] = m(xd).float().cpu().numpy()
                row[f'{mode}_{k}_seconds'] = time.perf_counter() - t0
    for (mode, k), v in logits.items():
        check(v.shape == (8, 1000), f'resnet_model: {mode} {k} logits shape {v.shape}')
    row.update(
        eval_rel_l2_vs_cpu_fp32=rel_l2(logits['eval', 'card_bf16'], logits['eval', 'cpu_fp32']),
        eval_rel_l2_card_fp32_vs_cpu_fp32=rel_l2(logits['eval', 'card_fp32'],
                                                 logits['eval', 'cpu_fp32']),
        train_rel_l2_vs_cpu_fp32=rel_l2(logits['train', 'card_bf16'], logits['train', 'cpu_fp32']),
        finite=all(bool(np.isfinite(v).all()) for v in logits.values()))
    stats = _stats_rel(_batch_stats(card, before), _batch_stats(cpu, before))
    row['batch_stats_of_train_forward'] = stats
    del card, cpu, models
    emit(row)
    check(row['finite'], 'resnet_model: non-finite logits')
    check((row['params'], row['leaves'], row['batchnorms']) == (25_557_032, 161, RESNET_BATCHNORMS),
          f'resnet_model: {row["params"]} parameters, {row["leaves"]} leaves, '
          f'{row["batchnorms"]} BatchNorms')
    for key, tol in (('eval_rel_l2_vs_cpu_fp32', EFFNET_EVAL_FP32_TOL),
                     ('eval_rel_l2_card_fp32_vs_cpu_fp32', EFFNET_FP32_TOL),
                     ('train_rel_l2_vs_cpu_fp32', MODEL_REL_L2_TOL)):
        check(row[key] <= tol, f'resnet_model: {key} {row[key]} > {tol}')
    for leaf, r in stats.items():
        check(r['rel_l2'] <= MODEL_REL_L2_TOL,
              f'resnet_model: batch {leaf} of a train forward rel L2 {r["rel_l2"]} > '
              f'{MODEL_REL_L2_TOL}')
    torch.cuda.empty_cache()


def phase_resnet_serve():
    """The engine serving resnet50 in bf16 (running statistics calibrated
    on the card): ``_graph_serve``."""
    import torch
    _graph_serve('resnet_serve', RESNET, lambda: _resnet('cuda', torch.bfloat16), RESNET_SIZE)


def _optimizer_arm(opt_name: str, models, batches, nan_batch):
    """One optimizer name on resnet50 at RESNET_OPT_LAYERS (``models``: the card's bf16 model for
    the train step, and fp32 copies on the CPU and the card): RESNET_OPT_STEPS
    steps in the captured step against its eager body (``_graph_vs_eager``,
    the 4th non-finite); one update on the card against the CPU in fp32
    (TF32 off): from the same weights, one step on a seeded gradient (ADOPT's
    first update is zero), then the update each computes for a second one
    (the optimizer's ``_update`` and wrappers, before it is added to the
    parameters, whose rounding would hide a small update), the largest
    relative L2 of a leaf's; and the optimizer step alone replayed as a CUDA
    graph (``harness.graph_ms``)."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels.harness import graph_ms
    row, task = _graph_vs_eager(opt_name, 1, batches, nan_batch, False, model_name=RESNET,
                                steps=RESNET_OPT_STEPS, nan_step=RESNET_NAN_STEP,
                                drop_path_rate=0.0, lr=RESNET_LR, weight_decay=RESNET_WD,
                                model=models['train'])
    del task
    models['cuda'].load_state_dict(models['cpu'].state_dict())  # one start on both
    opts = {d: timm_tpu_torch.create_optimizer_v2(models[d], opt=opt_name, lr=RESNET_LR,
                                                  weight_decay=RESNET_WD) for d in ('cpu', 'cuda')}
    rng = np.random.default_rng(7)
    grads = [torch.from_numpy(rng.standard_normal(opts['cpu'].flat_grad.numel(),
                                                  dtype=np.float32) * 0.01) for _ in range(2)]
    updates = {}
    for d, o in opts.items():
        o.flat_grad.copy_(grads[0].to(o.device))
        o.step(lr=RESNET_LR, grad_scale=torch.tensor(0.5, device=o.device),
               ok=torch.tensor(True, device=o.device))
        with torch.no_grad():
            g = grads[1].to(o.device) * 0.5
            u, new = o._update(g, o.flat_param)
            updates[d] = o.views(o._wrap(u, g, o.flat_param, new))
    worst = 0.0
    for name, a in updates['cpu'].items():
        b = updates['cuda'][name].cpu()
        worst = max(worst, float((b - a).norm()) / max(float(a.norm()), 1e-30))
    card = opts['cuda']
    scale, ok = torch.tensor(0.5, device='cuda'), torch.tensor(True, device='cuda')
    row['optimizer_step_ms'] = graph_ms(lambda: card.step(grad_scale=scale, ok=ok), per_graph=1,
                                        replays=5)
    row['card_vs_cpu_update_rel_l2'] = worst
    del opts, card, updates
    torch.cuda.empty_cache()
    return row


def phase_resnet_train():
    """ClassificationTask on resnet50 (bf16 compute, fp32 parameters, the
    residual branches damped) with timm's SGD recipe (Nesterov momentum 0.9,
    weight decay 1e-4 as masked coupled L2, lr 0.05 on a cosine schedule),
    label smoothing 0.1: 20 steps at batch 64 on one fixed batch, steps 3-20
    replays of one graph; under the profiler 3 more replayed steps by kernel
    family with the idle share; the 53 BatchNorm + ReLU and the
    convolutions alone at the step's shapes. Then one step's gradients,
    bf16 on the card against fp32 on the CPU at batch 4; the replayed step
    against its eager body bit for bit with split BN over 3 splits of 32
    (parameters, momentum, every primary and aux statistic); an AdamW arm
    through fused_adamw (its wrapper once at the warm-up and capture, once a
    replayed step under the profiler); and every optimizer name this slice
    adds (``_optimizer_arm``)."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels import flash_attention, fused_adamw
    t_phase = time.perf_counter()
    task = _train_task(0, 'cuda', torch.bfloat16, 0.0, opt='sgd', model_name=RESNET,
                       weight_decay=RESNET_WD, lr=RESNET_LR)
    sched, _ = timm_tpu_torch.create_scheduler_v2(RESNET_LR, 'cosine', num_epochs=TRAIN_STEPS,
                                                  warmup_epochs=3, warmup_lr=1e-6)
    batch = _train_batch(TRAIN_BATCH, 4, 'cuda', size=RESNET_SIZE)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flash_attention.launches = fused_adamw.launches = 0
    metrics = []
    for step in range(TRAIN_STEPS):
        if step == TRAIN_WARMUP_STEPS:
            start.record()
        metrics.append(task.train_step(batch, lr=sched.step(step)[0], step=step + 1))
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP_STEPS)
    reps = 3
    kernels, counts, prof_wall_ms = _profile_kernels(
        lambda: task.train_step(batch, lr=1e-5, step=TRAIN_STEPS + 1), reps)
    busy = sum(kernels.values())
    fams = _families(kernels, counts)
    losses = [float(m['loss']) for m in metrics]
    row = {'phase': 'resnet_train', 'model': RESNET, 'size': RESNET_SIZE, 'dtype': 'bfloat16',
           'batch': TRAIN_BATCH, 'steps': TRAIN_STEPS, 'optimizer': 'sgd (nesterov 0.9)',
           'lr': RESNET_LR, 'weight_decay': RESNET_WD, 'losses': losses,
           'grad_norms': [float(m['grad_norm']) for m in metrics],
           'step_ms': step_ms, 'img_per_s': TRAIN_BATCH / step_ms * 1e3,
           'graph_pool_bytes': task.train_graphs.pool_bytes(),
           'captures': task.train_graphs.captures, 'replays': task.train_graphs.replays,
           'sgd_launches': {'flash_attention': flash_attention.launches,
                            'fused_adamw': fused_adamw.launches},
           'replay_wall_ms_per_step': prof_wall_ms,
           'replay_device_ms_per_step': busy if kernels else 'not measured',
           'replay_idle_share': 1.0 - busy / prof_wall_ms if kernels else 'not measured',
           'replay_ms_by_family': fams['ms'], 'replay_kernels_by_family': fams['kernels'],
           'top_kernels': [{'kernel': k[:120], 'ms': v}
                           for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]]}
    sgd_launches = dict(row['sgd_launches'])
    del task
    gc.collect()
    torch.cuda.empty_cache()

    # the 53 BatchNorm + ReLU and the convolutions alone, at the step's shapes
    modules = _module_families(_resnet('cuda', torch.bfloat16, calibrate=False),
                               batch['input'], ('batchnorm_act', 'other_conv'))
    row['module_families_alone'] = modules
    row['batchnorm_elements_per_image'] = modules['batchnorm_act']['input_elements'] / TRAIN_BATCH
    row['family_alone_share_of_step_device_ms'] = (
        {f: r['fwd_bwd_ms'] / busy for f, r in modules.items()} if kernels else 'not measured')

    # one step's gradients on the card against the CPU: fp32 against fp32,
    # and bf16 against fp32 beside the CPU's own bf16 (see RESNET_GRAD_TOL)
    grad_batch = _train_batch(RESNET_GRAD_BATCH, 5, 'cpu', size=RESNET_SIZE)
    grads = {}
    for device, dtype in (('cuda', torch.bfloat16), ('cuda', None), ('cpu', None),
                          ('cpu', torch.bfloat16)):
        t = _train_task(0, device, dtype, 0.0, opt='sgd', nonfinite_guard=False,
                        model_name=RESNET, weight_decay=RESNET_WD, lr=RESNET_LR)
        t.train_step(grad_batch, lr=0.0, step=1)
        grads[device, dtype] = t.optimizer.flat_grad.float().cpu()
        del t
    torch.cuda.empty_cache()

    def grad_rel(a, b):
        return float((grads[a] - grads[b]).norm() / grads[b].norm())
    fp32 = ('cpu', None)
    grad_errs = {'card_fp32_vs_cpu_fp32': grad_rel(('cuda', None), fp32),
                 'card_bf16_vs_cpu_fp32': grad_rel(('cuda', torch.bfloat16), fp32),
                 'cpu_bf16_vs_cpu_fp32': grad_rel(('cpu', torch.bfloat16), fp32),
                 'card_bf16_vs_cpu_bf16': grad_rel(('cuda', torch.bfloat16),
                                                   ('cpu', torch.bfloat16))}
    grad_finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    del grads
    row.update(grad_batch=RESNET_GRAD_BATCH, grad_rel_l2=grad_errs, grad_tol=RESNET_GRAD_TOL)

    # the replayed step against its eager body with split BN (3 x 32)
    n_split = RESNET_SPLITS * RESNET_SPLIT_BATCH
    batches = [_train_batch(n_split, 60 + i, 'cuda', size=RESNET_SIZE) for i in range(2)]
    nan_batch = dict(batches[0], input=batches[0]['input'].clone())
    nan_batch['input'][5, 50, 50, 2] = float('nan')
    split_row, task = _graph_vs_eager(
        'sgd', 1, batches, nan_batch, False, model_name=RESNET, steps=RESNET_GRAPH_STEPS,
        nan_step=RESNET_NAN_STEP, drop_path_rate=0.0, lr=RESNET_LR, weight_decay=RESNET_WD,
        split_bn=RESNET_SPLITS)
    split_row['running_stats_compared'] = len(_model_buffers(task))
    split_row['aux_stats_compared'] = sum('.aux_bn.' in k for k in _model_buffers(task))
    row['split_bn_graph_vs_eager'] = split_row
    del task
    gc.collect()
    torch.cuda.empty_cache()

    # the AdamW arm, through fused_adamw
    fused_adamw.launches = 0
    task = _train_task(0, 'cuda', torch.bfloat16, 0.0, opt='adamw', model_name=RESNET)
    adamw_steps = []
    for step in range(5):
        a0 = fused_adamw.launches
        task.train_step(batch, lr=TRAIN_LR, step=step + 1)
        adamw_steps.append(fused_adamw.launches - a0)
    a_kernels, a_counts, _ = _profile_kernels(lambda: task.train_step(batch, lr=1e-5, step=6), 2)
    row['adamw_arm'] = {'wrapper_fused_adamw_launches_per_step': adamw_steps,
                        'replayed_kernels_per_step': _per_step(a_counts) if a_kernels
                        else 'not measured',
                        'fused_adamw_replayed_ms': sum(v for k, v in a_kernels.items()
                                                       if 'fused_adamw' in k)}
    adamw_launches = fused_adamw.launches
    del task
    gc.collect()
    torch.cuda.empty_cache()

    # every optimizer name this slice adds
    cut = dict(seed=0, layers=RESNET_OPT_LAYERS)
    models = {'cpu': _damp_resnet(timm_tpu_torch.create_model(RESNET, device='cpu', **cut)),
              'train': _damp_resnet(timm_tpu_torch.create_model(
                  RESNET, device='cuda', dtype=torch.bfloat16, **cut))}
    models['cuda'] = timm_tpu_torch.create_model(RESNET, device='cuda', **cut)
    models['cuda'].load_state_dict(models['cpu'].state_dict())
    opt_batches = [_train_batch(RESNET_OPT_BATCH, 70 + i, 'cuda', size=RESNET_SIZE)
                   for i in range(2)]
    opt_nan = dict(opt_batches[0], input=opt_batches[0]['input'].clone())
    opt_nan['input'][1, 50, 50, 2] = float('nan')
    row['optimizer_arms'] = {}
    for name in RESNET_NEW_OPTIMIZERS:
        t_arm = time.perf_counter()
        row['optimizer_arms'][name] = _optimizer_arm(name, models, opt_batches, opt_nan)
        row['optimizer_arms'][name]['seconds'] = time.perf_counter() - t_arm
    del models
    gc.collect()
    torch.cuda.empty_cache()
    row['seconds'] = time.perf_counter() - t_phase
    emit(row)
    check(all(np.isfinite(losses)), f'resnet_train: non-finite loss in {losses}')
    check(losses[-1] < losses[0], f'resnet_train: last loss {losses[-1]} not below {losses[0]}')
    check(row['captures'] == 1, 'resnet_train: the step was not captured once')
    check(sgd_launches == {'flash_attention': 0, 'fused_adamw': 0},
          f'resnet_train: the SGD step launched {sgd_launches}')
    check(grad_finite, 'resnet_train: non-finite gradients')
    check(grad_errs['card_fp32_vs_cpu_fp32'] <= RESNET_GRAD_TOL,
          f'resnet_train: fp32 gradient rel L2 {grad_errs["card_fp32_vs_cpu_fp32"]} > '
          f'{RESNET_GRAD_TOL}')
    check(grad_errs['card_bf16_vs_cpu_fp32'] <= max(
        GRAD_REL_L2_TOL, RESNET_GRAD_BF16_SLACK * grad_errs['cpu_bf16_vs_cpu_fp32']),
          f'resnet_train: bf16 gradients {grad_errs}')
    check(split_row['running_stats_compared'] == 2 * RESNET_BATCHNORMS * RESNET_SPLITS
          and split_row['aux_stats_compared'] == 2 * RESNET_BATCHNORMS * (RESNET_SPLITS - 1),
          f'resnet_train: {split_row["running_stats_compared"]} statistics compared')
    arms = [('split_bn', split_row)] + list(row['optimizer_arms'].items())
    for arm, r in arms:
        check(not r['buffers_that_differ'],
              f'resnet_train ({arm}): replays differ from eager steps in {r["buffers_that_differ"]}')
        check(not r['steps_whose_metrics_differ'],
              f'resnet_train ({arm}): metrics differ at steps {r["steps_whose_metrics_differ"]}')
        check(r['skipped_steps'] == [RESNET_NAN_STEP],
              f'resnet_train ({arm}): the guard skipped steps {r["skipped_steps"]}')
        check(r['captures'] == 1, f'resnet_train ({arm}): {r["captures"]} captures')
    for name, r in row['optimizer_arms'].items():
        check(r['card_vs_cpu_update_rel_l2'] <= RESNET_OPT_TOL,
              f'resnet_train ({name}): card vs CPU update rel L2 '
              f'{r["card_vs_cpu_update_rel_l2"]} > {RESNET_OPT_TOL}')
    check(adamw_steps == [1, 1, 0, 0, 0],
          f'resnet_train: fused_adamw wrapper launches per step {adamw_steps}')
    check(bool(a_kernels) and row['adamw_arm']['replayed_kernels_per_step']['fused_adamw'] == 1,
          f'resnet_train: a replayed AdamW step ran {row["adamw_arm"]["replayed_kernels_per_step"]}')
    return {'fused_adamw': adamw_launches, 'flash_attention': 0}


def phase_resnet_drivers():
    """The train driver's main(argv) with timm's ResNet-50 JSD + RandAugment
    recipe on resnet50 at one bottleneck a stage (RESNET_DRIVER_FLAGS: 3 AugMix splits, the JSD loss, split BN,
    'pixel' erasing 0.6 on the host, cosine, lr 0.05, bf16) over the folder
    of the seeded PNGs of ``_image_data`` (576 train, 192 validation): 9
    updates of 3 x 64 images; run A uninterrupted, run B stopped by SIGTERM
    after update 4, run C resumed from it with --resume auto, C's last.npz
    held to A's bit for bit (weights, EMA, momentum, primary and aux
    statistics). Then ``validate`` on A's EMA weights (the plain model, the
    aux statistics left out) within DRIVER_EVAL_REL_TOL of A's last EMA
    evaluation; ``validate --test-pool --img-size 288``, which must report
    the test-time pool head at crop 1.0; and ``inference`` at that size,
    whose top-1 must agree with validate's at that size without the head.
    The wrappers' counts are read around each run."""
    import csv
    import shutil
    import tempfile

    import torch

    from timm_tpu_torch import inference, train, validate
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    kernels = (flash_attention, fused_adamw, augment_epilogue)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_resnet_')
    row = {'phase': 'resnet_drivers', 'model': RESNET, 'dtype': 'bfloat16',
           'flags': ' '.join(RESNET_DRIVER_FLAGS), 'sigterm_at': RESNET_DRIVER_SIGTERM_AT,
           'wall_s': {}, 'launches': {}}

    try:
        data, out = _image_data(), os.path.join(tmp, 'out')
        n_train, n_val = _IMAGE_DATA['train'], _IMAGE_DATA['validation']
        row.update(train_images=n_train, validation_images=n_val, updates=n_train // 64)

        def train_argv(experiment, *extra):
            return RESNET_DRIVER_FLAGS + ['--data-dir', data, '--output', out,
                                          '--experiment', experiment, *extra]
        for name, argv in (('a', train_argv('a')),
                           ('b', train_argv('b', '--fault-inject',
                                            f'sigterm@{RESNET_DRIVER_SIGTERM_AT}')),
                           ('c', train_argv('b', '--resume', 'auto'))):
            rc, wall, launches = _run_driver(train.main, argv, kernels)
            row['wall_s'][name], row['launches'][name] = wall, launches
            check(rc == 0, f'resnet_drivers: run {name.upper()} exited {rc}')
            check(not any(launches.values()),
                  f'resnet_drivers: run {name.upper()} wrapper launches {launches}')
        with open(os.path.join(out, 'a', 'summary.csv')) as f:
            rows = list(csv.DictReader(f))
        ema_loss = float(rows[-1]['eval_loss_ema'])
        row['final_ema_eval'] = {'loss': ema_loss, 'top1': float(rows[-1]['eval_top1_ema'])}
        ckpt_a = _checkpoint_groups(os.path.join(out, 'a', 'last.npz'))
        ckpt_c = _checkpoint_groups(os.path.join(out, 'b', 'last.npz'))
        c_vs_a = _max_diff(ckpt_c, ckpt_a)
        row['running_statistics_in_checkpoint'] = len(ckpt_a['model_state'])
        row['optimizer_count'] = int(ckpt_a['optimizer']['optimizer.count'])
        row['resumed_vs_uninterrupted'] = {g: {'tensors_differ': n, 'max_abs_diff': d}
                                           for g, (n, d) in c_vs_a.items()}
        del ckpt_a, ckpt_c
        eval_argv = ['--model', RESNET, '--model-kwargs', RESNET_DRIVER_KWARGS,
                     '--checkpoint', os.path.join(out, 'a', 'last.npz'),
                     '--use-ema', '--amp', '-b', '64', '--workers', '6', '--data-dir', data]
        val, wall, launches = _run_driver(
            lambda argv: validate.validate(validate.parser.parse_args(argv)), eval_argv, kernels)
        row['wall_s']['validate'], row['launches']['validate'] = wall, launches
        row['validate'] = {'loss': val['loss'], 'top1': val['top1'], 'img_per_s': val['img_per_s'],
                           'test_time_pool': val['test_time_pool']}
        at_288 = eval_argv + ['--img-size', str(RESNET_POOL_SIZE)]
        predictions = []
        plain, wall, _ = _run_driver(
            lambda argv: validate.validate(validate.parser.parse_args(argv), predictions), at_288,
            kernels)
        pooled, wall_p, _ = _run_driver(
            lambda argv: validate.validate(validate.parser.parse_args(argv)),
            at_288 + ['--test-pool'], kernels)
        row['wall_s']['validate_test_pool'] = wall_p
        row['validate_288'] = {'loss': plain['loss'], 'top1': plain['top1']}
        row['validate_test_pool'] = {k: pooled[k] for k in ('loss', 'top1', 'crop_pct',
                                                             'test_time_pool', 'img_size')}
        rc_i, wall_i, _ = _run_driver(inference.main, at_288 + [
            '--topk', '5', '--output-dir', os.path.join(tmp, 'inf')], kernels)
        row['wall_s']['inference'] = wall_i
        with open(os.path.join(tmp, 'inf', f'{RESNET}-results.csv')) as f:
            inf_rows = list(csv.DictReader(f))
        agree = sum(int(r['label_0']) == p[0] for r, p in zip(inf_rows, predictions))
        row['inference_top1_agrees_with_validate_288'] = agree
        check(row['optimizer_count'] == n_train // 64,
              f'resnet_drivers: {row["optimizer_count"]} updates in run A')
        want_stats = _running_stats(RESNET, layers=[1, 1, 1, 1]) * 3
        check(row['running_statistics_in_checkpoint'] == want_stats,
              f'resnet_drivers: {row["running_statistics_in_checkpoint"]} statistics in last.npz, '
              f'want {want_stats}')
        check(all(n == 0 for n, _ in c_vs_a.values()),
              f'resnet_drivers: the resumed last.npz differs from the uninterrupted one: {c_vs_a}')
        check(abs(val['loss'] - ema_loss) <= DRIVER_EVAL_REL_TOL * abs(ema_loss),
              f'resnet_drivers: validate loss {val["loss"]} vs the EMA eval {ema_loss}')
        check(not val['test_time_pool'] and pooled['test_time_pool'] and pooled['crop_pct'] == 1.0
              and pooled['img_size'] == RESNET_POOL_SIZE,
              f'resnet_drivers: --test-pool gave {row["validate_test_pool"]}')
        check(rc_i == 0 and len(inf_rows) == n_val and agree == n_val == len(predictions),
              f'resnet_drivers: inference exited {rc_i}, top-1 agrees on {agree} of {n_val}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        emit(row)  # what was measured, also when a check failed
    torch.cuda.empty_cache()
    return {k.__name__: sum(r[k.__name__] for r in row['launches'].values()) for k in kernels}


# ---- NaFlex and differential attention: naflexvit_base_patch16_gap and
# vit_dlittle_patch16_reg1_gap_256 ---------------------------------------------

NAFLEX = 'naflexvit_base_patch16_gap'
NAFLEX_SERVE_SIZE = 384                   # its cfg's input size: N 576, every token valid
NAFLEX_SEQ_LENS = (128, 256, 576, 784, 1024)
NAFLEX_MAX_SEQ_LEN = 576
NAFLEX_BATCH = 64                         # at max_seq_len: a budget of 36,864 tokens
NAFLEX_MODEL_VALID = (576, 401, 200, 64)  # valid tokens of the 4 rows at L 576
NAFLEX_IMAGES_PER_CLASS = 192             # 576 training PNGs, 96-640 px a side
NAFLEX_VAL_PER_CLASS = 21                 # 63 validation PNGs: one eval batch, wrapped to 64
NAFLEX_SIDES = (96, 640)
NAFLEX_FP32_TOL = 1e-4                    # the card's fp32 vs the CPU's fp32
NAFLEX_MAX_EPOCHS = 16                    # naflex_train stops once every bucket is checked
# naflex_train's loader seed: its schedule replays every bucket after another
# one by its 11th update, in epoch 2 (1,222 images; seed 0 takes 27 updates
# over 5 epochs)
NAFLEX_LOADER_SEED = 388
NAFLEX_LR = 1e-3
# the drivers' budget: 32 images at 576 (18,432 tokens), over 384 of the
# train images (128 a class). At naflex_train's
# 36,864 the five bucket graphs' shared pool holds about 50 GB, and a new
# bucket's eager warm-up beside it left the train driver, with its eval
# graphs and EMA, short of the card's 80 GB
NAFLEX_DRIVER_BATCH = 32
# one epoch of the drivers' seed-3 schedule (7 updates) visits all five
# buckets: 1024, 576, 1024, 128, 784, 256, 784
NAFLEX_DRIVER_EPOCHS = 1
NAFLEX_DRIVER_PER_CLASS = 128
NAFLEX_DRIVER_DEPTH = 4   # the drill at ViT-B/16's width and 4 blocks (the time limit)
NAFLEX_DRIVER_FLAGS = [
    '--model', NAFLEX, '--model-kwargs', f'depth={NAFLEX_DRIVER_DEPTH}', '--naflex-loader',
    '--naflex-train-seq-lens',
    *(str(n) for n in NAFLEX_SEQ_LENS), '--naflex-max-seq-len', str(NAFLEX_MAX_SEQ_LEN),
    '-b', str(NAFLEX_DRIVER_BATCH), '--amp', '--epochs', str(NAFLEX_DRIVER_EPOCHS), '--opt', 'adamw',
    '--lr', '1e-3', '--weight-decay', '0.05', '--sched', 'cosine', '--warmup-epochs', '0',
    '--clip-grad', '1.0',
    '--mixup', '0.8', '--cutmix', '1.0', '--smoothing', '0.1', '--reprob', '0.25',
    '--remode', 'pixel', '--device-augment', '--device-prefetch', '2', '--drop-path', '0.1',
    '--seed', '3', '--log-interval', '1', '--checkpoint-hist', '1']
NAFLEX_DRIVER_SIGTERM_AT = 3              # in epoch 0: C regenerates the batches B consumed
DLITTLE = 'vit_dlittle_patch16_reg1_gap_256'
DLITTLE_SIZE = 256
DLITTLE_GRAD_BATCH = 4
DLITTLE_TRAIN_STEPS = 20
DLITTLE_DRIVER_FLAGS = [
    '--model', DLITTLE, '--model-kwargs', 'depth=4', '--amp', '-b', '64', '--epochs', '1',
    '--opt', 'adamw', '--lr', '1e-3',
    '--weight-decay', '0.05', '--sched', 'cosine', '--warmup-epochs', '0', '--mixup', '0.8',
    '--cutmix', '1.0', '--smoothing', '0.1', '--reprob', '0.25', '--remode', 'const',
    '--device-augment', '--device-prefetch', '2', '--workers', '6', '--drop-path', '0.1',
    '--seed', '0', '--log-interval', '1', '--checkpoint-hist', '1']

_NAFLEX_DATA = {}


def _naflex_data() -> str:
    """The NaFlex phases' folder of seeded PNGs of mixed sizes and aspect
    ratios, 96-640 px a side: train/ (576) and validation/ (129), written
    once into a temp dir that main removes."""
    import tempfile
    if 'root' not in _NAFLEX_DATA:
        root = tempfile.mkdtemp(prefix='chip_smoke_naflex_')
        _NAFLEX_DATA['root'] = root
        t0 = time.perf_counter()
        _NAFLEX_DATA['train'] = _write_image_folder(
            os.path.join(root, 'train'), NAFLEX_IMAGES_PER_CLASS, seed=2, sides=NAFLEX_SIDES)
        _NAFLEX_DATA['validation'] = _write_image_folder(
            os.path.join(root, 'validation'), NAFLEX_VAL_PER_CLASS, seed=3, sides=NAFLEX_SIDES)
        _NAFLEX_DATA['write_s'] = time.perf_counter() - t0
    return _NAFLEX_DATA['root']


def _naflex_batch(valid_rows, seq_len: int, seed: int, num_classes: int = 1000):
    """A NaFlex dict batch (numpy): seeded patches of N(0, 0.5), row i's
    first valid_rows[i] tokens valid on a grid ceil(sqrt(n)) wide, the rest
    zero padding; integer targets."""
    rng = np.random.default_rng(seed)
    B = len(valid_rows)
    patches = (0.5 * rng.standard_normal((B, seq_len, 768))).astype(np.float32)
    coord = np.zeros((B, seq_len, 2), np.int32)
    valid = np.zeros((B, seq_len), bool)
    for i, n in enumerate(valid_rows):
        gw = int(np.ceil(np.sqrt(n)))
        j = np.arange(n)
        coord[i, :n, 0], coord[i, :n, 1] = j // gw, j % gw
        valid[i, :n] = True
        patches[i, n:] = 0.0
    return {'patches': patches, 'patch_coord': coord, 'patch_valid': valid,
            'target': rng.integers(0, num_classes, B)}


def _to_device(batch, device):
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _naflex_model(device, dtype=None, **kw):
    import timm_tpu_torch
    return timm_tpu_torch.create_model(NAFLEX, dtype=dtype, seed=0, device=device, **kw)


def _attn_inputs(model, run):
    """[(attention module, its input, its mask)] of every block of
    ``model`` as ``run()`` calls them."""
    got = []

    def hook(mod, args, kwargs):
        got.append((mod, args[0].detach().clone(), kwargs.get('attn_mask')))
    hooks = [blk.attn.register_forward_pre_hook(hook, with_kwargs=True) for blk in model.blocks]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return got


def phase_naflex_model():
    """naflexvit_base_patch16_gap uncut (embed 768, 12 heads, 12 blocks, D
    64), seed-0 weights, 4 rows at L 576 with 576 / 401 / 200 / 64 valid
    tokens: bf16 on the card against fp32 on the CPU (logits, valid
    tokens), fp32 on the card against the CPU, 12 flash kernels a forward;
    and in both mask modes every block's attention on the card (the flash
    kernel, with JAX's value in the padded query rows in 'symmetric' mode)
    against the plain version (``_sdpa`` with the dense mask JAX builds),
    valid and padded query rows apart."""
    import torch
    from timm_tpu_torch.kernels import flash_attention, registry
    from timm_tpu_torch.layers.attention import _sdpa, scaled_dot_product_attention
    batch = _naflex_batch(NAFLEX_MODEL_VALID, NAFLEX_MAX_SEQ_LEN, seed=0)
    inputs = {k: batch[k] for k in ('patches', 'patch_coord', 'patch_valid')}
    valid = batch['patch_valid']

    def features_and_logits(model, device):
        b = _to_device(inputs, device)
        with torch.inference_mode():
            f = model.forward_features(b['patches'], b['patch_coord'], b['patch_valid'])
            return f.float().cpu().numpy(), model(b).float().cpu().numpy()

    t0 = time.perf_counter()
    f_cpu, l_cpu = features_and_logits(_naflex_model('cpu').eval(), 'cpu')
    row = {'phase': 'naflex_model', 'model': NAFLEX, 'batch': len(NAFLEX_MODEL_VALID),
           'seq_len': NAFLEX_MAX_SEQ_LEN, 'valid_tokens': list(NAFLEX_MODEL_VALID),
           'cpu_fp32_seconds': time.perf_counter() - t0}
    tol = registry.get('flash_attention').parity_tol
    try:
        for dtype, limit in ((torch.bfloat16, MODEL_REL_L2_TOL), (torch.float32, NAFLEX_FP32_TOL)):
            name = str(dtype).replace('torch.', '')
            card = _naflex_model('cuda', dtype).eval()
            features_and_logits(card, 'cuda')  # first call: kernel and library set-up
            flash_attention.launches = 0
            f_card, l_card = features_and_logits(card, 'cuda')
            launches = flash_attention.launches
            err_logits = rel_l2(l_card, l_cpu)
            err_tokens = rel_l2(f_card[valid], f_cpu[valid])
            finite = bool(np.isfinite(l_card).all() and np.isfinite(f_card).all())
            row[name] = {'rel_l2_logits_vs_cpu_fp32': err_logits,
                         'rel_l2_valid_tokens_vs_cpu_fp32': err_tokens, 'tol': limit,
                         'flash_launches_two_forwards': launches, 'finite': finite}
            check(finite, f'naflex_model: non-finite {name} output on the card')
            check(l_card.shape == (4, 1000), f'naflex_model: logits shape {l_card.shape}')
            check(err_logits <= limit and err_tokens <= limit,
                  f'naflex_model: {name} rel L2 logits {err_logits}, valid tokens {err_tokens} '
                  f'> {limit}')
            check(launches == 2 * len(card.blocks),
                  f'naflex_model: {launches} flash launches in two {name} forwards')
            if dtype != torch.bfloat16:
                continue
            b = _to_device(inputs, 'cuda')
            for mode in ('symmetric', 'key'):
                card.mask_mode = mode
                flash_attention.launches = 0
                worst = {'valid_rows': 0.0, 'padded_rows': 0.0}
                with torch.inference_mode():
                    got = _attn_inputs(card, lambda: card(b))
                    fwd_launches = flash_attention.launches
                    for attn, x, mask in got:
                        B, N, C = x.shape
                        q, k, v = attn.qkv(x).reshape(B, N, 3, attn.num_heads, attn.head_dim) \
                            .permute(2, 0, 3, 1, 4).unbind(0)
                        out = scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=attn.scale)
                        plain = _sdpa(q, k, v, mask.dense(), scale=attn.scale)
                        diff = (out.float() - plain.float()).abs().amax(dim=(1, 3))  # (B, N)
                        worst['valid_rows'] = max(worst['valid_rows'], float(diff[mask.valid].max()))
                        worst['padded_rows'] = max(worst['padded_rows'],
                                                   float(diff[~mask.valid].max()))
                row[f'{mode}_attention_vs_plain'] = dict(worst, tol=tol,
                                                         flash_launches_one_forward=fwd_launches)
                check(fwd_launches == len(card.blocks),
                      f'naflex_model: {fwd_launches} flash launches in a {mode} forward')
                check(max(worst.values()) <= tol,
                      f'naflex_model: {mode} attention vs plain {worst} > {tol}')
            del card, b, got
            torch.cuda.empty_cache()
    finally:
        emit(row)


def phase_naflex_serve():
    """The engine serving naflexvit_base_patch16_gap in bf16 at 384 px NHWC
    (N 576, every token valid: the flash kernel with no mask), one CUDA
    graph per bucket: ``_graph_serve``."""
    import torch
    moved = _graph_serve('naflex_serve', NAFLEX, lambda: _naflex_model('cuda', torch.bfloat16),
                         NAFLEX_SERVE_SIZE, flash_per_forward=12)
    return moved['flash_attention']


def _naflex_task(device, dtype, drop_path_rate: float = 0.1, **task_kw):
    """NaFlexClassificationTask on naflexvit_base_patch16_gap: AdamW (wd
    0.05, mask), soft targets with smoothing 0.1 after the loader's mixup."""
    import timm_tpu_torch
    from timm_tpu_torch.loss import SoftTargetCrossEntropy
    from timm_tpu_torch.task import NaFlexClassificationTask
    model = _naflex_model(device, dtype, drop_path_rate=drop_path_rate)
    opt = timm_tpu_torch.create_optimizer_v2(model, opt='adamw', lr=NAFLEX_LR, weight_decay=0.05)
    return NaFlexClassificationTask(model, optimizer=opt, train_loss_fn=SoftTargetCrossEntropy(),
                                    mixup_label_smoothing=0.1, seed=0, **task_kw)


def _naflex_host_loader(root):
    """The NaFlex loader's host part as phase naflex_train runs it."""
    from timm_tpu_torch.data.dataset_factory import create_dataset
    from timm_tpu_torch.data.naflex_loader import NaFlexLoader
    return NaFlexLoader(
        create_dataset('', root, split='train'), tokens_per_batch=NAFLEX_BATCH * NAFLEX_MAX_SEQ_LEN,
        seq_lens=NAFLEX_SEQ_LENS, patch_size=16, is_training=True, mean=(0.5,) * 3,
        std=(0.5,) * 3, mixup_alpha=0.8, cutmix_alpha=1.0, re_prob=0.25, re_mode='pixel',
        seed=NAFLEX_LOADER_SEED, device_augment=True)


def _grads_vs_cpu(make_task, batch):
    """One step's flat gradients, bf16 on the card against fp32 on the CPU
    from the same seeded weights: (rel L2, finite on the card, CPU s)."""
    import torch
    grads = {}
    for device, dtype in (('cuda', torch.bfloat16), ('cpu', None)):
        task = make_task(device, dtype)
        t0 = time.perf_counter()
        task.train_step(batch, lr=0.0, step=1)
        grads[device] = (task.optimizer.flat_grad.float().cpu(), time.perf_counter() - t0)
        del task
        torch.cuda.empty_cache()
    g_card, g_cpu = grads['cuda'][0], grads['cpu'][0]
    return (float((g_card - g_cpu).norm() / g_cpu.norm()), bool(torch.isfinite(g_card).all()),
            grads['cpu'][1])


def phase_naflex_train():
    """NaFlexClassificationTask trains naflexvit_base_patch16_gap (bf16,
    drop path 0.1, AdamW with EMA 0.9998, clip 1.0, cosine lr) from 576
    seeded PNGs of mixed sizes through the NaFlex loader in budget mode
    (sequence lengths 128 / 256 / 576 / 784 / 1024 under 36,864 tokens: B
    288 at 128, 64 at 576, 36 at 1024), with the loader's mixup 0.8 /
    cutmix 1.0 and 'pixel' erasing 0.25 filled on the card (the augment
    program, one graph per bucket), the buckets in the loader's random
    order, until (mid-epoch) every bucket has had a replayed step after
    another bucket ran (its second step, the capture's replay, or a later one) whose state
    before and after (and batch, lr, drop generator) were saved to the
    host; after the run, with its graphs freed (the shared
    pool and an eager step do not fit in the card together), a fresh task
    is put in each saved state and runs the eager step body on the same
    batch, held to the replay bit for bit (metrics, parameters, optimizer
    state, EMA, sentinel, drop generator). Per bucket: two more replayed
    steps and the eager one timed with CUDA events, img/s and tokens/s,
    the host's wait for the batch, a profiled replay (12 flash and 1
    fused_adamw kernels; idle share), the flash forward and the plain fp32
    attention backward alone at its shapes, the loader's key-valid
    fraction; the shared pool; the host loader's img/s alone; then one
    step's gradients at batch 4 (L 576), bf16 card vs fp32 CPU."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.kernels import flash_attention, fused_adamw
    from timm_tpu_torch.kernels.flash_attention import flash_attention_backward
    from timm_tpu_torch.kernels.harness import graph_ms
    from timm_tpu_torch.layers.drop import get_drop_generator
    root = _naflex_data()
    gc.collect()
    torch.cuda.empty_cache()
    row = {'phase': 'naflex_train', 'model': NAFLEX, 'dtype': 'bfloat16',
           'device_bytes_in_use_at_start': torch.cuda.memory_allocated(),
           'seq_lens': list(NAFLEX_SEQ_LENS), 'tokens_per_batch': NAFLEX_BATCH * NAFLEX_MAX_SEQ_LEN,
           'train_images': _NAFLEX_DATA['train'], 'write_images_s': _NAFLEX_DATA['write_s']}
    try:
        # the host loader alone over epoch 0's first batch (144 images at N
        # 256): decode, flip, resize, mixup, patchify, erase masks, collate
        # (one thread, as the loader runs)
        host = iter(_naflex_host_loader(root))
        t0 = time.perf_counter()
        host_batches = [next(host)]
        row['loader_img_per_s_alone'] = sum(b['patches'].shape[0] for b in host_batches) / (
            time.perf_counter() - t0)
        row['loader_alone_batches'] = [[b['seq_len'], b['patches'].shape[0]] for b in host_batches]
        del host, host_batches

        task = _naflex_task('cuda', torch.bfloat16, clip_grad=1.0)
        task.setup_ema(decay=0.9998)
        gen = get_drop_generator(task.model)
        from timm_tpu_torch.data.dataset_factory import create_dataset
        from timm_tpu_torch.data.naflex_loader import create_naflex_loader
        loader = create_naflex_loader(
            create_dataset('', root, split='train'), patch_size=16,
            train_seq_lens=NAFLEX_SEQ_LENS, max_seq_len=NAFLEX_MAX_SEQ_LEN,
            batch_size=NAFLEX_BATCH, is_training=True, mean=(0.5,) * 3, std=(0.5,) * 3,
            mixup_alpha=0.8, cutmix_alpha=1.0, re_prob=0.25, re_mode='pixel',
            seed=NAFLEX_LOADER_SEED, device_augment=True, device_prefetch=2, device='cuda')
        depth = len(task.model.blocks)
        # the cosine schedule stepped by update, 5 warm-up updates
        sched, _ = timm_tpu_torch.create_scheduler_v2(
            NAFLEX_LR, 'cosine', num_epochs=200, warmup_epochs=5, warmup_lr=1e-6)
        flash_attention.launches = 0
        fused_adamw.launches = 0
        torch.cuda.reset_peak_memory_stats()
        buckets, order, losses = {}, [], []
        step, prev = 0, None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_run = time.perf_counter()
        for epoch in range(NAFLEX_MAX_EPOCHS):
            loader.set_epoch(epoch)
            t_wait = time.perf_counter()
            for batch in loader:
                L, B = int(batch['seq_len']), int(batch['patches'].shape[0])
                wait_ms = (time.perf_counter() - t_wait) * 1e3
                b = {k: v for k, v in batch.items() if k not in ('seq_len', 'patch_size')}
                rec = buckets.setdefault(L, {'batch': B, 'updates': 0, 'wait_ms': [],
                                             'valid': [], 'step_ms': []})
                rec['wait_ms'].append(wait_ms)
                rec['valid'].append(float(b['patch_valid'].float().mean()))
                lr = sched.step(step)[0]
                step += 1
                checked = rec['updates'] >= 1 and prev not in (None, L) and 'check' not in rec
                if checked:
                    before = [t.cpu() for t in _train_state(task)], gen.get_state()
                torch.cuda.synchronize()
                start.record()
                metrics = task.train_step(b, lr=lr, step=step)
                end.record()
                torch.cuda.synchronize()
                rec['step_ms'].append(start.elapsed_time(end))
                rec['updates'] += 1
                losses.append(float(metrics['loss']))
                order.append(L)
                rec['last'] = (b, lr, step)
                if checked:
                    rec['check'] = {'before': before, 'lr': lr, 'step': step,
                                    'batch': {k: v.cpu() for k, v in b.items()},
                                    'after': ([t.cpu() for t in _train_state(task)], gen.get_state()),
                                    'metrics': {k: v.cpu() for k, v in metrics.items()}}
                    del before
                prev = L
                if len(buckets) == len(NAFLEX_SEQ_LENS) and all('check' in r
                                                                 for r in buckets.values()):
                    break
                t_wait = time.perf_counter()
            else:
                continue
            break
        row.update(epochs=epoch + 1, updates=step, bucket_order=order, losses=losses,
                   wall_s=time.perf_counter() - t_run, captures=task.train_graphs.captures,
                   replays=task.train_graphs.replays,
                   train_graph_pool_bytes=task.train_graphs.pool_bytes(),
                   train_graph_static_input_bytes=task.train_graphs.static_bytes(),
                   augment_graph_pool_bytes=loader.graphs.pool_bytes(),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
        launches = {'flash_attention': flash_attention.launches,
                    'fused_adamw': fused_adamw.launches}
        row['wrapper_launches'] = launches
        check(set(buckets) == set(NAFLEX_SEQ_LENS) and all('check' in r for r in buckets.values()),
              f'naflex_train: buckets seen {sorted(buckets)}, checked '
              f'{sorted(L for L, r in buckets.items() if "check" in r)}')
        check(all(np.isfinite(losses)), 'naflex_train: non-finite loss')
        check(task.train_graphs.captures == len(buckets),
              f'naflex_train: {task.train_graphs.captures} captures for {len(buckets)} buckets')
        # the wrappers count a bucket's warm-up and capture, nothing more: a
        # replay runs no Python
        check(launches == {'flash_attention': 2 * depth * len(buckets),
                           'fused_adamw': 2 * len(buckets)},
              f'naflex_train: wrapper launches {launches} for {len(buckets)} buckets')
        per_bucket = {}
        for L, rec in sorted(buckets.items()):
            B = rec['batch']
            b, lr, s = rec.pop('last')
            replay = []
            for _ in range(2):
                start.record()
                task.train_step(b, lr=lr, step=s)
                end.record()
                torch.cuda.synchronize()
                replay.append(start.elapsed_time(end))
            replay_ms = float(np.mean(replay))
            kernels, counts, wall_ms = _profile_kernels(
                lambda: task.train_step(b, lr=lr, step=s), 2)
            ran = _per_step(counts)
            busy = sum(kernels.values())
            valid = float(np.mean(rec['valid']))
            # the attention alone at the bucket's shapes: the flash forward
            # and the plain fp32 backward, seeded q, k, v and upstream grad
            g = torch.Generator(device='cuda').manual_seed(L)
            q, k, v, dy = [(0.5 * torch.randn(B, 12, L, 64, generator=g, device='cuda'))
                           .to(torch.bfloat16) for _ in range(4)]
            mask = (torch.arange(L, device='cuda') < round(valid * L)).expand(B, L).contiguous()
            with torch.no_grad():
                fwd = graph_ms(lambda: flash_attention(q, k, v, mask=mask[:, None, None, :]),
                               per_graph=5, replays=5)
                bwd = graph_ms(lambda: flash_attention_backward(q, k, v, mask, 0.125, dy),
                               per_graph=1, replays=3)
            del q, k, v, dy, mask
            torch.cuda.empty_cache()
            per_bucket[str(L)] = {
                'batch': B, 'updates': rec['updates'], 'key_valid_fraction': valid,
                'replay_step_ms': replay_ms, 'run_step_ms': rec['step_ms'],
                'img_per_s': B / replay_ms * 1e3,
                'tokens_per_s': B * L / replay_ms * 1e3,
                'host_wait_ms_median': float(np.median(rec['wait_ms'])),
                'profiled_kernels_per_step': ran if kernels else 'not measured',
                'profiled_wall_ms': wall_ms,
                'profiled_device_ms': busy if kernels else 'not measured',
                'idle_share': 1.0 - busy / wall_ms if kernels else 'not measured',
                'flash_fwd_ms_per_layer': fwd, 'attention_bwd_plain_ms_per_layer': bwd,
                'attention_fwd_bwd_share_of_step': depth * (fwd + bwd) / replay_ms}
            check(bool(kernels), f'naflex_train: the profiler saw no kernel at bucket {L}')
            check(ran['flash_attention'] == depth and ran['fused_adamw'] == 1,
                  f'naflex_train: a replayed step at bucket {L} ran {ran}')
        row['per_bucket'] = per_bucket
        row['loader_img_per_s_in_run'] = sum(len(r['wait_ms']) * r['batch']
                                             for r in buckets.values()) / row['wall_s']
        del task, loader, gen, b, metrics
        gc.collect()
        torch.cuda.empty_cache()
        # each saved replay against the eager body from the same state, on a
        # fresh task (no graph pool)
        task = _naflex_task('cuda', torch.bfloat16, clip_grad=1.0)
        task.setup_ema(decay=0.9998)
        gen = get_drop_generator(task.model)
        for L, rec in sorted(buckets.items()):
            c = rec.pop('check')
            for t, v in zip(_train_state(task), c['before'][0]):
                t.copy_(v)
            gen.set_state(c['before'][1])
            task.optimizer.set_hyperparams(lr=c['lr'], ema_decay=task.ema.get_decay(c['step']))
            task.model.train()
            b = {k: v.cuda() for k, v in c['batch'].items()}
            torch.cuda.synchronize()
            start.record()
            eager = {k: v.clone() for k, v in task._train_body(b).items()}
            end.record()
            torch.cuda.synchronize()
            differ = [i for i, (x, y) in enumerate(zip(_train_state(task), c['after'][0]))
                      if not _bit_equal(x.cpu(), y)]
            same = (not differ and torch.equal(gen.get_state(), c['after'][1])
                    and eager.keys() == c['metrics'].keys()
                    and all(_bit_equal(eager[k].cpu(), c['metrics'][k]) for k in eager))
            per_bucket[str(L)].update(eager_step_ms=start.elapsed_time(end),
                                      replay_equals_eager_bit_for_bit=same,
                                      state_tensors_that_differ=differ)
            del c, b, eager
        check(all(r['replay_equals_eager_bit_for_bit'] for r in per_bucket.values()),
              f'naflex_train: replay vs eager by bucket '
              f'{[(L, r["replay_equals_eager_bit_for_bit"]) for L, r in per_bucket.items()]}')
        del task, gen
        gc.collect()
        torch.cuda.empty_cache()
        grad_batch = _naflex_batch(NAFLEX_MODEL_VALID, NAFLEX_MAX_SEQ_LEN, seed=5)
        err, finite, cpu_s = _grads_vs_cpu(
            lambda device, dtype: _naflex_task(device, dtype, drop_path_rate=0.0,
                                               nonfinite_guard=False), grad_batch)
        row['grads_batch4'] = {'rel_l2_bf16_card_vs_fp32_cpu': err, 'tol': GRAD_REL_L2_TOL,
                               'finite': finite, 'cpu_fp32_step_seconds': cpu_s}
        check(finite and err <= GRAD_REL_L2_TOL,
              f'naflex_train: gradients rel L2 {err} > {GRAD_REL_L2_TOL} (finite {finite})')
    finally:
        emit(row)
    return launches


def _run_driver(fn, argv, kernels, updates=None):
    """Run a driver's ``fn(argv)`` (its main, or validate) with its output on
    stderr, the wrappers' counts zeroed before: (what it returned, wall s,
    the counts). ``updates``, a list, collects each update's batch shape
    (patches or input) through TrainingTask.train_step."""
    import contextlib

    import torch
    from timm_tpu_torch.task.task import TrainingTask
    for k in kernels:
        k.launches = 0
    train_step = TrainingTask.train_step

    def counted(self, batch, *a, **kw):
        x = batch['patches'] if 'patches' in batch else batch['input']
        updates.append(tuple(x.shape[:2]))
        return train_step(self, batch, *a, **kw)
    if updates is not None:
        TrainingTask.train_step = counted
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result = fn(argv)
        torch.cuda.synchronize()
    finally:
        TrainingTask.train_step = train_step
    torch.cuda.empty_cache()
    return result, time.perf_counter() - t0, {k.__name__: k.launches for k in kernels}


def phase_naflex_drivers():
    """``python -m timm_tpu_torch.train --naflex-loader`` through its
    main(argv) on 384 of the NaFlex PNGs: naflexvit_base_patch16_gap at 4
    blocks, bf16, an epoch over the five buckets at 18,432 tokens a batch,
    mixup / cutmix,
    'pixel' erasing on the card, no EMA (phase drivers resumes one): run A;
    run B stopped by SIGTERM after update 3; run C with --resume auto. C's
    last.npz bit for bit with A's. The wrappers count each bucket graph's
    warm-up and capture and the eval graph's."""
    import shutil
    import tempfile
    from timm_tpu_torch import train
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    kernels = (flash_attention, fused_adamw, augment_epilogue)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_naflex_drivers_')
    # NAFLEX_DRIVER_PER_CLASS of each class's training images, and the
    # validation split, linked from the NaFlex folder
    data = _naflex_data()
    root = os.path.join(tmp, 'data')
    for c in sorted(os.listdir(os.path.join(data, 'train'))):
        os.makedirs(os.path.join(root, 'train', c))
        for name in sorted(os.listdir(os.path.join(data, 'train', c)))[:NAFLEX_DRIVER_PER_CLASS]:
            os.symlink(os.path.join(data, 'train', c, name), os.path.join(root, 'train', c, name))
    os.symlink(os.path.join(data, 'validation'), os.path.join(root, 'validation'))
    row = {'phase': 'naflex_drivers', 'model': NAFLEX, 'flags': ' '.join(NAFLEX_DRIVER_FLAGS),
           'sigterm_at': NAFLEX_DRIVER_SIGTERM_AT, 'wall_s': {}, 'launches': {}, 'updates': {}}
    depth = NAFLEX_DRIVER_DEPTH
    try:
        out = os.path.join(tmp, 'out')

        def argv(experiment, *extra):
            return NAFLEX_DRIVER_FLAGS + ['--data-dir', root, '--output', out,
                                          '--experiment', experiment, *extra]
        runs = {}
        for name, args in (('a', argv('a')),
                           ('b', argv('b', '--fault-inject', f'sigterm@{NAFLEX_DRIVER_SIGTERM_AT}')),
                           ('c', argv('b', '--resume', 'auto'))):
            shapes = []
            rc, wall, launches = _run_driver(train.main, args, kernels, updates=shapes)
            runs[name] = shapes
            row['wall_s'][name], row['launches'][name] = wall, launches
            row['updates'][name] = [list(s) for s in shapes]
            check(rc == 0, f'naflex_drivers: run {name} exited {rc}')
            _trim_run_dir(os.path.join(out, 'a' if name == 'a' else 'b'))
        a, b, c = runs['a'], runs['b'], runs['c']
        n_val = _NAFLEX_DATA['validation']
        evals = -(-n_val // NAFLEX_DRIVER_BATCH)
        # a bucket's graph: a warm-up and a capture; the eval graph at the
        # max length: the same, once for the run
        keys = {s: a.count(s) for s in set(a)}
        want_a = {'flash_attention': depth * (sum(min(n, 2) for n in keys.values())
                                              + min(2, NAFLEX_DRIVER_EPOCHS * evals)),
                  'fused_adamw': sum(min(n, 2) for n in keys.values()), 'augment_epilogue': 0}
        row['buckets_a'] = {f'{L}x{B}': n for (B, L), n in sorted(keys.items())}
        check(row['launches']['a'] == want_a,
              f'naflex_drivers: run A wrapper launches {row["launches"]["a"]}, want {want_a}')
        check(len(b) == NAFLEX_DRIVER_SIGTERM_AT + 1, f'naflex_drivers: run B took {len(b)} updates')
        check({L for _, L in a} == set(NAFLEX_SEQ_LENS), f'naflex_drivers: run A visited {sorted(keys)}')
        check(b + c == a, 'naflex_drivers: runs B and C did not take run A\'s updates in order')
        check(row['launches']['a']['augment_epilogue'] == 0,
              "naflex_drivers: 'pixel' erasing launched the augment-epilogue kernel")
        c_vs_a = _max_diff(_checkpoint_groups(os.path.join(out, 'b', 'last.npz')),
                           _checkpoint_groups(os.path.join(out, 'a', 'last.npz')))
        row['resumed_vs_uninterrupted'] = {g: {'tensors_differ': n, 'max_abs_diff': d}
                                           for g, (n, d) in c_vs_a.items()}
        check(all(n == 0 for n, _ in c_vs_a.values()),
              f'naflex_drivers: resumed run differs from run A: {row["resumed_vs_uninterrupted"]}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        emit(row)
    return {k.__name__: sum(r[k.__name__] for r in row['launches'].values()) for k in kernels}


def _dlittle(device, dtype=None, **kw):
    """vit_dlittle_patch16_reg1_gap_256 uncut (embed 320, 14 blocks, 5
    heads of 2 x 32, one register token, MLP 5.6), seed-0 weights, its
    layer scale (1e-5 at init: the blocks near the identity) lifted to
    seeded values in [0.1, 1.0]."""
    import torch
    import timm_tpu_torch
    model = timm_tpu_torch.create_model(DLITTLE, dtype=dtype, seed=0, device=device, **kw)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('.gamma'):
                p.copy_(torch.from_numpy(rng.uniform(0.1, 1.0, p.shape).astype(np.float32)))
    return model


def phase_dlittle_model():
    """vit_dlittle_patch16_reg1_gap_256 at 256 px, batch 8: bf16 on the card
    against fp32 on the CPU; no kernel of the port runs (DiffAttention is
    plain PyTorch, as it is plain XLA in JAX)."""
    import torch
    from timm_tpu_torch.kernels import registry
    counters = registry.launch_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    x = _images(8, size=DLITTLE_SIZE, seed=6)
    with torch.inference_mode():
        card = _dlittle('cuda', torch.bfloat16).eval()
        xc = torch.from_numpy(x).cuda()
        card(xc)
        logits_card = card(xc).float().cpu().numpy()
        t0 = time.perf_counter()
        logits_cpu = _dlittle('cpu').eval()(torch.from_numpy(x)).numpy()
        cpu_s = time.perf_counter() - t0
    err = rel_l2(logits_card, logits_cpu)
    moved = {k: fn.launches - before[k] for k, fn in counters.items() if fn.launches != before[k]}
    emit({'phase': 'dlittle_model', 'model': DLITTLE, 'batch': 8, 'size': DLITTLE_SIZE,
          'dtype': 'bfloat16', 'rel_l2_vs_cpu_fp32': err, 'tol': MODEL_REL_L2_TOL,
          'finite': bool(np.isfinite(logits_card).all()), 'wrapper_launches': moved,
          'cpu_fp32_seconds': cpu_s})
    check(np.isfinite(logits_card).all(), 'dlittle_model: non-finite logits on the card')
    check(logits_card.shape == (8, 1000), f'dlittle_model: logits shape {logits_card.shape}')
    check(err <= MODEL_REL_L2_TOL, f'dlittle_model: rel L2 {err} > {MODEL_REL_L2_TOL}')
    check(not moved, f'dlittle_model: the port\'s kernels launched {moved}')
    del card
    torch.cuda.empty_cache()


def phase_dlittle_serve():
    """The engine serving vit_dlittle_patch16_reg1_gap_256 in bf16 at 256 px,
    one CUDA graph per bucket: ``_graph_serve``."""
    import torch
    _graph_serve('dlittle_serve', DLITTLE, lambda: _dlittle('cuda', torch.bfloat16), DLITTLE_SIZE)


def _diff_attention_alone(model, x):
    """Device ms of the 14 DiffAttention modules alone at a train step's
    shapes (bf16, train mode, their inputs from one forward of ``x``):
    forward, and forward + backward against a seeded upstream gradient,
    from CUDA-graph replays; and the softmax over the 2H heads alone
    (forward + backward), the fp32 part of the einsums' chain."""
    import torch
    from timm_tpu_torch.kernels.harness import graph_ms
    with torch.no_grad():
        got = _attn_inputs(model, lambda: model(x))
    mods = [m for m, _, _ in got]
    xs = [a.requires_grad_(True) for _, a, _ in got]
    g = torch.Generator(device='cuda').manual_seed(4)
    with torch.no_grad():
        dys = [torch.randn(a.shape, generator=g, device='cuda').to(a.dtype) for a in xs]
    params = [p for m in mods for p in m.parameters()]

    def forward():
        with torch.no_grad():
            for m, a in zip(mods, xs):
                m(a)

    def forward_backward():
        ys = [m(a) for m, a in zip(mods, xs)]
        torch.autograd.grad(ys, xs + params, dys)
    B, N, _ = xs[0].shape
    heads = 2 * mods[0].num_heads
    s = torch.randn(B, heads, N, N, generator=g, device='cuda').requires_grad_(True)
    ds = torch.randn(B, heads, N, N, generator=g, device='cuda')

    def softmax_fwd_bwd():
        torch.autograd.grad(torch.softmax(s, dim=-1), s, ds)
    out = {'modules': len(mods), 'fwd_ms': graph_ms(forward, per_graph=1, replays=5),
           'fwd_bwd_ms': graph_ms(forward_backward, per_graph=1, replays=5),
           'softmax_fwd_bwd_ms_per_layer': graph_ms(softmax_fwd_bwd, per_graph=1, replays=5),
           'scores_shape': [B, heads, N, N]}
    del got, mods, xs, dys, params, s, ds
    torch.cuda.empty_cache()
    return out


def phase_dlittle_train():
    """ClassificationTask trains vit_dlittle_patch16_reg1_gap_256 (bf16, drop
    path 0.1, AdamW through fused_adamw, clip 1.0, EMA, the guard on) on
    256 px batches of 64: the replayed step against its eager body over 20
    steps from one state (step 7 non-finite), bit for bit, with eager and
    replayed step ms and idle share (``_graph_vs_eager``); a profiled
    replay by kernel family, with the DiffAttention modules (their einsums
    and fp32 softmax) alone at the step's shapes; one fused_adamw and no
    flash kernel a replayed step; one step's gradients at batch 4, bf16
    card vs fp32 CPU."""
    import torch
    from timm_tpu_torch.kernels import flash_attention, fused_adamw
    batches = [_train_batch(TRAIN_BATCH, 20 + i, 'cuda', size=DLITTLE_SIZE) for i in range(4)]
    nan_batch = _train_batch(TRAIN_BATCH, 30, 'cuda', size=DLITTLE_SIZE)
    nan_batch['input'][3, 10, 10, 0] = float('nan')
    flash_attention.launches = 0
    fused_adamw.launches = 0
    model = _dlittle('cuda', torch.bfloat16, drop_path_rate=0.1)
    row, task = _graph_vs_eager('adamw', 1, batches, nan_batch, timed=True, model_name=DLITTLE,
                                model=model, steps=DLITTLE_TRAIN_STEPS)
    launches = {'flash_attention': flash_attention.launches, 'fused_adamw': fused_adamw.launches}
    reps = 3
    kernels, counts, wall_ms = _profile_kernels(
        lambda: task.train_step(batches[0], lr=1e-5, step=DLITTLE_TRAIN_STEPS + 5), reps)
    fams = _families(kernels, counts)
    alone = _diff_attention_alone(task.model.train(), batches[0]['input'])
    row.update(phase='dlittle_train', model=DLITTLE, dtype='bfloat16', batch=TRAIN_BATCH,
               size=DLITTLE_SIZE, wrapper_launches=launches,
               replay_ms_by_family=fams['ms'], replay_kernels_by_family=fams['kernels'],
               diff_attention_alone=alone,
               diff_attention_fwd_bwd_share_of_replay=(alone['fwd_bwd_ms'] / row['replay_step_ms']))
    del task, batches, nan_batch
    torch.cuda.empty_cache()
    err, finite, cpu_s = _grads_vs_cpu(
        lambda device, dtype: _train_task(0, device, dtype, 0.0, model=_dlittle(device, dtype),
                                          nonfinite_guard=False),
        _train_batch(DLITTLE_GRAD_BATCH, 7, 'cpu', size=DLITTLE_SIZE))
    row['grads_batch4'] = {'rel_l2_bf16_card_vs_fp32_cpu': err, 'tol': GRAD_REL_L2_TOL,
                           'finite': finite, 'cpu_fp32_step_seconds': cpu_s}
    emit(row)
    check(not row['buffers_that_differ'] and not row['steps_whose_metrics_differ'],
          f'dlittle_train: replays vs eager: buffers {row["buffers_that_differ"]}, steps '
          f'{row["steps_whose_metrics_differ"]}')
    check(row['skipped_steps'] == [TRAIN_GRAPH_NAN_STEP],
          f'dlittle_train: skipped steps {row["skipped_steps"]}')
    check(row['replayed_kernels_per_step']['fused_adamw'] == 1
          and row['replayed_kernels_per_step']['flash_attention'] == 0,
          f'dlittle_train: a replayed step ran {row["replayed_kernels_per_step"]}')
    # the eager body's steps, the graph's warm-up and capture, 3 profiled eager steps
    check(launches == {'flash_attention': 0, 'fused_adamw': DLITTLE_TRAIN_STEPS + 2 + 3},
          f'dlittle_train: wrapper launches {launches}')
    check(all(np.isfinite(row['losses'][i]) for i in range(len(row['losses']))
              if i + 1 != TRAIN_GRAPH_NAN_STEP), 'dlittle_train: non-finite loss')
    check(finite and err <= GRAD_REL_L2_TOL,
          f'dlittle_train: gradients rel L2 {err} > {GRAD_REL_L2_TOL} (finite {finite})')
    return launches


def phase_dlittle_drivers():
    """A short run of the train driver on vit_dlittle_patch16_reg1_gap_256
    (4 blocks) from 256-320 px PNGs with --device-augment and 'const' erasing: the
    augment program runs the augment-epilogue kernel at 256^2 (its warm-up
    and capture), the step fused_adamw, no flash kernel."""
    import shutil
    import tempfile
    from timm_tpu_torch import train
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    kernels = (flash_attention, fused_adamw, augment_epilogue)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_dlittle_drivers_')
    row = {'phase': 'dlittle_drivers', 'model': DLITTLE, 'flags': ' '.join(DLITTLE_DRIVER_FLAGS)}
    try:
        data = _image_data()
        n_train, n_val = _IMAGE_DATA['train'], _IMAGE_DATA['validation']
        shapes = []
        rc, wall, launches = _run_driver(
            train.main, DLITTLE_DRIVER_FLAGS + ['--data-dir', data, '--output', os.path.join(tmp, 'out'),
                                                '--experiment', 'd'], kernels, updates=shapes)
        row.update(train_images=n_train, validation_images=n_val, wall_s=wall, launches=launches,
                   updates=len(shapes))
        check(rc == 0, f'dlittle_drivers: the run exited {rc}')
        check(len(shapes) == n_train // 64, f'dlittle_drivers: {len(shapes)} updates')
        check(launches == {'flash_attention': 0, 'fused_adamw': 2, 'augment_epilogue': 2},
              f'dlittle_drivers: wrapper launches {launches}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        emit(row)
    return launches


# ---- vit_so400m_patch14_siglip_224: phases so400m_* --------------------------------
SO400M = 'vit_so400m_patch14_siglip_224'
SO400M_SIZE = 224
SO400M_DEPTH = 27
SO400M_FLASH_PER_FORWARD = SO400M_DEPTH + 1   # the blocks' self-attention + the 'map' pool
SO400M_MODEL_BATCH = 8
SO400M_INTERMEDIATES = (0, 8, 17, 26)
SO400M_FP32_REL_TOL = 1e-4                    # the card's fp32 vs the CPU's
SO400M_TRAIN_STEPS = 5                        # per arm: eager body steps, then as many graphed
SO400M_ARM_STEPS = 3                          # plain vs checkpointed, from one state
SO400M_ARM_REL_TOL = 1e-6
SO400M_NAN_STEP = 4
SO400M_GRAD_BATCH = 4
SO400M_DRIVER_DEPTH = 4
SO400M_DRIVER_FLAGS = [
    '--model', SO400M, '--grad-checkpointing', '--model-kwargs', f'depth={SO400M_DRIVER_DEPTH}',
    '--amp', '-b', '64', '--epochs', '1', '--opt', 'adamw', '--lr', '1e-4',
    '--weight-decay', '0.05', '--sched', 'cosine', '--warmup-epochs', '0', '--smoothing', '0.1',
    '--drop-path', '0.1', '--clip-grad', '1.0', '--mean', '0.5', '0.5', '0.5', '--std', '0.5',
    '0.5', '0.5', '--workers', '6', '--model-ema', '--model-ema-decay', '0.99', '--seed', '0',
    '--log-interval', '1', '--checkpoint-hist', '1']


_SO400M_WEIGHTS = {}


def _so400m(device, dtype=None, **kw):
    """vit_so400m_patch14_siglip_224 uncut (width 1152, 27 blocks, 16 heads
    of 72, MLP 4304, no class token, 'map' pool), seed-0 weights: what
    ``create_model(..., seed=0, device=device)`` builds. Its 428.8 M seeded
    draws take seconds on the host, and the weights do not depend on the
    compute dtype or the drop rates, so they are drawn once per process
    and each model is built on the meta device and given them."""
    import torch
    import timm_tpu_torch
    from timm_tpu_torch.layers import set_drop_generator
    model = timm_tpu_torch.create_model(SO400M, dtype=dtype, device='meta', **kw)
    model = model.to_empty(device=device)
    model.load_state_dict(_so400m_weights())
    return set_drop_generator(model, torch.Generator(device=device).manual_seed(0))


def _so400m_weights():
    """The seed-0 state dict of vit_so400m_patch14_siglip_224 on the host,
    drawn once per process."""
    import timm_tpu_torch
    if 'state' not in _SO400M_WEIGHTS:
        _SO400M_WEIGHTS['state'] = timm_tpu_torch.create_model(
            SO400M, seed=0, device='cpu').state_dict()
    return _SO400M_WEIGHTS['state']


def phase_so400m_model():
    """vit_so400m_patch14_siglip_224 at 224 px, batch 8: bf16 on the card
    against fp32 on the CPU (rel L2 2e-2), fp32 on the card against the CPU
    (1e-4, TF32 off), forward_intermediates at 4 indices equal to the
    blocks' own outputs, and 28 flash launches an eager forward (27 blocks
    and the latent pool's 1 query over 256 keys, D 72)."""
    import torch
    from timm_tpu_torch.kernels import flash_attention
    x = _images(SO400M_MODEL_BATCH, size=SO400M_SIZE, seed=7)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu = _so400m('cpu').eval()
        logits_cpu = cpu(torch.from_numpy(x)).numpy()
    cpu_s = time.perf_counter() - t0
    del cpu
    xc = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        card32 = _so400m('cuda').eval()
        logits_fp32 = card32(xc).float().cpu().numpy()
        del card32
        torch.cuda.empty_cache()
        card = _so400m('cuda', torch.bfloat16).eval()
        card(xc)
        flash_attention.launches = 0
        logits_card = card(xc).float().cpu().numpy()
        launches = flash_attention.launches
        # the blocks' outputs by hand, against forward_intermediates
        h = card._embed(xc, pad_tokens_to=0)[0]
        outs = []
        for blk in card.blocks:
            h = blk(h)
            outs.append(h)
        inter = card.forward_intermediates(xc, indices=list(SO400M_INTERMEDIATES),
                                           output_fmt='NLC', intermediates_only=True)
        inter_equal = [bool(torch.equal(a, outs[i])) for a, i in zip(inter, SO400M_INTERMEDIATES)]
        grid = card.forward_intermediates(xc, indices=list(SO400M_INTERMEDIATES),
                                          intermediates_only=True)
        grid_shapes = [list(g.shape) for g in grid]
    err = rel_l2(logits_card, logits_cpu)
    err32 = rel_l2(logits_fp32, logits_cpu)
    emit({'phase': 'so400m_model', 'model': SO400M, 'batch': SO400M_MODEL_BATCH,
          'size': SO400M_SIZE, 'params': sum(p.numel() for p in card.parameters()),
          'head_dim': card.blocks[0].attn.head_dim, 'dtype': 'bfloat16',
          'rel_l2_vs_cpu_fp32': err, 'tol': MODEL_REL_L2_TOL,
          'fp32_rel_l2_vs_cpu_fp32': err32, 'fp32_tol': SO400M_FP32_REL_TOL,
          'flash_launches_per_forward': launches, 'intermediates': list(SO400M_INTERMEDIATES),
          'intermediates_equal_blocks': inter_equal, 'intermediate_grid_shapes': grid_shapes,
          'finite': bool(np.isfinite(logits_card).all()), 'cpu_fp32_seconds': cpu_s})
    check(np.isfinite(logits_card).all(), 'so400m_model: non-finite logits on the card')
    check(logits_card.shape == (SO400M_MODEL_BATCH, 1000),
          f'so400m_model: logits shape {logits_card.shape}')
    check(err <= MODEL_REL_L2_TOL, f'so400m_model: rel L2 {err} > {MODEL_REL_L2_TOL}')
    check(err32 <= SO400M_FP32_REL_TOL, f'so400m_model: fp32 rel L2 {err32} > {SO400M_FP32_REL_TOL}')
    check(launches == SO400M_FLASH_PER_FORWARD,
          f'so400m_model: {launches} flash launches a forward')
    check(all(inter_equal), f'so400m_model: intermediates vs blocks {inter_equal}')
    check(grid_shapes == [[SO400M_MODEL_BATCH, 16, 16, 1152]] * len(SO400M_INTERMEDIATES),
          f'so400m_model: NHWC intermediates {grid_shapes}')
    del card
    torch.cuda.empty_cache()


def phase_so400m_serve():
    """The engine serving vit_so400m_patch14_siglip_224 in bf16 at 224 px,
    one CUDA graph per bucket (1, 4, 16, 64), each replay bit for bit with
    its eager forward, the 200 requests of phase serve's bursts within 2e-2
    of the direct forward, and 28 flash kernels in each profiled replay
    (counted per call): ``_graph_serve``."""
    import torch
    return _graph_serve('so400m_serve', SO400M, lambda: _so400m('cuda', torch.bfloat16),
                        SO400M_SIZE, flash_per_forward=SO400M_FLASH_PER_FORWARD)


def _arm_steps(task, batches, checkpointing: bool):
    """SO400M_ARM_STEPS eager body steps from the task's current state with
    gradient checkpointing on or off: each step's loss and flat gradients."""
    import torch
    task.model.set_grad_checkpointing(checkpointing)
    losses, grads = [], []
    for i in range(SO400M_ARM_STEPS):
        task.optimizer.set_hyperparams(lr=TRAIN_LR, ema_decay=task.ema.get_decay(i + 1))
        task.model.train()
        losses.append(task._train_body(batches[i % len(batches)])['loss'].float().cpu())
        grads.append(task.optimizer.flat_grad.float().cpu())  # off the card: a plain step's
    return losses, grads                                       # activations need the room


def phase_so400m_train():
    """ClassificationTask trains vit_so400m_patch14_siglip_224 uncut (bf16,
    batch 64, AdamW through fused_adamw, clip 1.0, EMA, drop path 0.1, patch
    dropout 0 as in its cfg) in two arms, plain and with
    set_grad_checkpointing(): in each, 5 replayed steps against 5 eager
    body steps from one state (step 4 non-finite), bit for bit in metrics,
    parameters, optimizer state, EMA and the drop generator's state, with
    step ms, img/s, idle share, graph pool and peak memory; the kernels of
    a replayed step (28 flash in the plain arm, 55 with the recompute, 1
    fused_adamw, counted per call); the two arms' losses and gradients over
    3 steps from one state within 1e-6 relative; one step's gradients at
    batch 4, bf16 card vs fp32 CPU (the CPU's step runs in a thread beside
    the arms, which leave the host idle while the card works)."""
    import threading

    import torch
    from timm_tpu_torch.kernels import flash_attention, fused_adamw, harness, registry
    from timm_tpu_torch.layers.drop import get_drop_generator
    grad_batch = _train_batch(SO400M_GRAD_BATCH, 7, 'cpu')
    _so400m_weights()  # drawn once, before the thread shares them
    cpu = {}

    def cpu_step():
        try:
            t0 = time.perf_counter()
            task = _train_task(0, 'cpu', None, 0.0, model=_so400m('cpu'), nonfinite_guard=False)
            task.train_step(grad_batch, lr=0.0, step=1)
            cpu['grad'] = task.optimizer.flat_grad.float().clone()
            cpu['seconds'] = time.perf_counter() - t0
        except BaseException as e:  # handed to the phase, which raises it
            cpu['error'] = e
    cpu_thread = threading.Thread(target=cpu_step, name='so400m-cpu-grads', daemon=True)
    cpu_thread.start()
    batches = [_train_batch(TRAIN_BATCH, 60 + i, 'cuda') for i in range(4)]
    nan_batch = _train_batch(TRAIN_BATCH, 70, 'cuda')
    nan_batch['input'][5, 50, 50, 2] = float('nan')
    arms, launches, compare, seconds = {}, {}, None, {}
    for arm in ('plain', 'checkpointed'):
        t_arm = time.perf_counter()
        flash_attention.launches = 0
        fused_adamw.launches = 0
        torch.cuda.reset_peak_memory_stats()
        model = _so400m('cuda', torch.bfloat16, drop_path_rate=0.1)
        model.set_grad_checkpointing(arm == 'checkpointed')
        # the plain arm's graph pool is about 51 GB: its state copies wait on the host
        row, task = _graph_vs_eager('adamw', 1, batches, nan_batch, timed=True, model_name=SO400M,
                                    model=model, steps=SO400M_TRAIN_STEPS,
                                    nan_step=SO400M_NAN_STEP,
                                    state_device='cpu' if arm == 'plain' else None)
        row['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
        row['grad_checkpointing'] = arm == 'checkpointed'
        launches[arm] = {'flash_attention': flash_attention.launches,
                         'fused_adamw': fused_adamw.launches}
        if arm == 'plain':
            # the fused AdamW + EMA kernel at so400m's own leaf set (n =
            # 428.8 M, its decay mask), on the task's flat buffers after the
            # arm: kernel, eager call, plain version and library call, bound
            opt = task.optimizer
            spec = registry.get('fused_adamw')
            case = next(c for c in spec.cases if c.name == 'vit_b16')  # its statics
            row['fused_adamw_so400m'] = harness.ab_case(spec, case, inputs=dict(
                p=opt.flat_param, g=opt.flat_grad, m=opt.m, v=opt.v, ema=opt.ema,
                count=opt.count, lr=opt.lr_t, ema_decay=opt.ema_decay_t, n_decay=opt.n_decay))
            row['fused_adamw_so400m']['n'] = opt.flat_param.numel()
        if arm == 'checkpointed':
            # plain against checkpointed from one state, eager, on this task
            gen = get_drop_generator(task.model)
            start = [t.detach().cpu() for t in _train_state(task)], gen.get_state()
            results = {}
            for ck in (False, True):
                for t, v in zip(_train_state(task), start[0]):
                    t.copy_(v)
                gen.set_state(start[1])
                results[ck] = _arm_steps(task, batches, ck)
            (loss_p, grad_p), (loss_c, grad_c) = results[False], results[True]
            compare = {
                'losses_plain': [float(v) for v in loss_p],
                'losses_checkpointed': [float(v) for v in loss_c],
                'max_loss_rel_diff': max(float((a - b).abs() / b.abs())
                                         for a, b in zip(loss_c, loss_p)),
                'max_grad_rel_l2': max(float((a - b).norm() / b.norm())
                                       for a, b in zip(grad_c, grad_p)),
                'grads_bit_equal': all(torch.equal(a, b) for a, b in zip(grad_c, grad_p)),
                'tol': SO400M_ARM_REL_TOL}
            del results, loss_p, grad_p, loss_c, grad_c, start
            torch.cuda.empty_cache()
        arms[arm] = row
        del task, model
        gc.collect()
        torch.cuda.empty_cache()
        seconds[arm] = time.perf_counter() - t_arm
    t_cpu = time.perf_counter()
    task = _train_task(0, 'cuda', torch.bfloat16, 0.0, model=_so400m('cuda', torch.bfloat16),
                       nonfinite_guard=False)
    task.train_step(grad_batch, lr=0.0, step=1)
    g_card = task.optimizer.flat_grad.float().cpu()
    del task
    torch.cuda.empty_cache()
    cpu_thread.join()
    if 'error' in cpu:
        raise cpu['error']
    err = float((g_card - cpu['grad']).norm() / cpu['grad'].norm())
    finite, cpu_s = bool(torch.isfinite(g_card).all()), cpu['seconds']
    out = {'phase': 'so400m_train', 'model': SO400M, 'dtype': 'bfloat16', 'batch': TRAIN_BATCH,
           'size': SO400M_SIZE, 'steps': SO400M_TRAIN_STEPS, 'nan_step': SO400M_NAN_STEP,
           'arms': arms, 'wrapper_launches': launches, 'plain_vs_checkpointed': compare,
           'seconds': dict(seconds, grads_vs_cpu=time.perf_counter() - t_cpu),
           'grads_batch4': {'rel_l2_bf16_card_vs_fp32_cpu': err, 'tol': GRAD_REL_L2_TOL,
                            'finite': finite, 'cpu_fp32_step_seconds': cpu_s}}
    emit(out)
    want_flash = {'plain': SO400M_FLASH_PER_FORWARD,
                  'checkpointed': 2 * SO400M_DEPTH + 1}   # the blocks' recompute runs them again
    for arm, row in arms.items():
        what = f'so400m_train {arm}'
        check(not row['buffers_that_differ'] and not row['steps_whose_metrics_differ'],
              f'{what}: replays vs eager: buffers {row["buffers_that_differ"]}, steps '
              f'{row["steps_whose_metrics_differ"]}')
        check(row['skipped_steps'] == [SO400M_NAN_STEP], f'{what}: skipped {row["skipped_steps"]}')
        check(row['captures'] == 1 and row['replays'] >= SO400M_TRAIN_STEPS - 1,
              f'{what}: {row["captures"]} captures, {row["replays"]} replays')
        check(row['replayed_kernels_per_step']['fused_adamw'] == 1
              and row['replayed_kernels_per_step']['flash_attention'] == want_flash[arm],
              f'{what}: a replayed step ran {row["replayed_kernels_per_step"]}')
        check(all(np.isfinite(row['losses'][i]) for i in range(len(row['losses']))
                  if i + 1 != SO400M_NAN_STEP), f'{what}: non-finite loss')
        # the eager body's steps, the graph's warm-up and capture, 3 profiled eager steps
        check(launches[arm]['fused_adamw'] == SO400M_TRAIN_STEPS + 2 + 3,
              f'{what}: wrapper launches {launches[arm]}')
    check(compare['max_loss_rel_diff'] <= SO400M_ARM_REL_TOL
          and compare['max_grad_rel_l2'] <= SO400M_ARM_REL_TOL,
          f'so400m_train: plain vs checkpointed {compare}')
    check(finite and err <= GRAD_REL_L2_TOL,
          f'so400m_train: gradients rel L2 {err} > {GRAD_REL_L2_TOL} (finite {finite})')
    return {k: sum(v[k] for v in launches.values()) for k in ('flash_attention', 'fused_adamw')}


def phase_so400m_drivers():
    """The train driver on vit_so400m_patch14_siglip_224 with
    --grad-checkpointing, cut to 4 blocks (--model-kwargs depth=4), one
    epoch of the shared 224 px PNG folder at batch 64 with EMA; then
    validate (with the same --model-kwargs) on its EMA weights, held to the
    run's final EMA evaluation."""
    import csv
    import shutil
    import tempfile
    from timm_tpu_torch import train, validate
    from timm_tpu_torch.kernels import augment_epilogue, flash_attention, fused_adamw
    kernels = (flash_attention, fused_adamw, augment_epilogue)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_so400m_drivers_')
    row = {'phase': 'so400m_drivers', 'model': SO400M, 'flags': ' '.join(SO400M_DRIVER_FLAGS)}
    try:
        data = _image_data()
        n_train, n_val = _IMAGE_DATA['train'], _IMAGE_DATA['validation']
        out = os.path.join(tmp, 'out')
        shapes = []
        rc, wall, launches = _run_driver(
            train.main, SO400M_DRIVER_FLAGS + ['--data-dir', data, '--output', out,
                                               '--experiment', 's'], kernels, updates=shapes)
        row.update(train_images=n_train, validation_images=n_val, wall_s=wall, launches=launches,
                   updates=len(shapes))
        check(rc == 0, f'so400m_drivers: the run exited {rc}')
        check(len(shapes) == n_train // 64, f'so400m_drivers: {len(shapes)} updates')
        # the train step's warm-up and capture (each forward's recompute runs
        # the blocks again), the eval step's with and without the EMA
        per_forward = SO400M_DRIVER_DEPTH + 1
        want = {'flash_attention': 2 * (per_forward + SO400M_DRIVER_DEPTH) + 2 * 2 * per_forward,
                'fused_adamw': 2, 'augment_epilogue': 0}
        check(launches == want, f'so400m_drivers: wrapper launches {launches}, want {want}')
        with open(os.path.join(out, 's', 'summary.csv')) as f:
            rows = list(csv.DictReader(f))
        ema_loss = float(rows[-1]['eval_loss_ema'])
        eval_argv = ['--model', SO400M, '--model-kwargs', f'depth={SO400M_DRIVER_DEPTH}',
                     '--checkpoint', os.path.join(out, 's', 'last.npz'), '--use-ema', '--amp',
                     '-b', '64', '--workers', '6', '--data-dir', data, '--mean', '0.5', '0.5',
                     '0.5', '--std', '0.5', '0.5', '0.5']
        val, wall_v, launches_v = _run_driver(
            lambda argv: validate.validate(validate.parser.parse_args(argv)), eval_argv, kernels)
        row.update(run_final_ema_eval_loss=ema_loss, validate={'loss': val['loss'],
                                                                'top1': val['top1']},
                   validate_wall_s=wall_v, validate_launches=launches_v)
        check(abs(val['loss'] - ema_loss) <= DRIVER_EVAL_REL_TOL * abs(ema_loss),
              f'so400m_drivers: validate loss {val["loss"]} vs the run\'s EMA eval {ema_loss}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        emit(row)
    return launches


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
    seconds = {}

    def run(fn, *args):
        """A phase, its wall seconds kept by name."""
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[fn.__name__[len('phase_'):]] = time.perf_counter() - t
    try:
        device = run(phase_device)
        previous = run(phase_build)
        verdicts = run(phase_kernels)
        flash_checks = run(phase_flash_checks, previous['flash_attention'])
        adamw_rows = run(phase_fused_adamw_checks)
        augment_rows = run(phase_augment_checks, previous['augment_epilogue'])
        run(phase_model)
        serve_launches, serve_replayed, engine = run(phase_serve)
        run(phase_breakdown, engine)
        del engine
        train_launches, task, batch, train_step_ms = run(phase_train)
        run(phase_train_vs_cpu)
        attn_bwd_ms, attn_bwd_library_ms = run(phase_train_breakdown, task, batch)
        del task, batch
        torch.cuda.empty_cache()
        run(phase_train_graph)
        muon_launches = run(phase_muon_train)
        run(phase_muon_vs_cpu)
        # ConvNeXt-B's profiled phases run before phase drivers' profiled
        # run C, after which the profiler misses kernels
        run(phase_convnext_depthwise)
        run(phase_convnext_model)
        run(phase_convnext_serve)
        convnext_train_launches = run(phase_convnext_train)
        run(phase_effnet_model)
        run(phase_effnet_serve)
        effnet_train_launches = run(phase_effnet_train)
        run(phase_resnet_model)
        run(phase_resnet_serve)
        resnet_train_launches = run(phase_resnet_train)
        run(phase_naflex_model)
        naflex_serve_launches = run(phase_naflex_serve)
        naflex_train_launches = run(phase_naflex_train)
        run(phase_dlittle_model)
        run(phase_dlittle_serve)
        dlittle_train_launches = run(phase_dlittle_train)
        run(phase_so400m_model)
        so400m_serve_launches = run(phase_so400m_serve)
        so400m_train_launches = run(phase_so400m_train)
        input_launches = run(phase_input_train, train_step_ms)
        recipe_launches = run(phase_recipe_train)
        driver_launches = run(phase_drivers)
        convnext_driver_launches = run(phase_convnext_drivers)
        effnet_driver_launches = run(phase_effnet_drivers)
        resnet_driver_launches = run(phase_resnet_drivers)
        naflex_driver_launches = run(phase_naflex_drivers)
        dlittle_driver_launches = run(phase_dlittle_drivers)
        so400m_driver_launches = run(phase_so400m_drivers)
    except Exception:
        traceback.print_exc()
        print(json.dumps({'phase_seconds': seconds}), file=sys.stderr)
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1
    finally:
        import shutil
        for data in (_IMAGE_DATA, _NAFLEX_DATA):
            if 'root' in data:
                shutil.rmtree(data['root'], ignore_errors=True)
    # recipe_train's 'pixel' erasing runs the augment program's torch
    # program: the augment-epilogue kernel is not on that path (0 launches)
    launches = {'flash_attention': {'serve': serve_launches,
                                    'train': train_launches['flash_attention'],
                                    'muon_train': muon_launches['flash_attention'],
                                    'input_train': input_launches['flash_attention'],
                                    'recipe_train': recipe_launches['flash_attention'],
                                    'drivers': driver_launches['flash_attention'],
                                    'resnet_train': resnet_train_launches['flash_attention'],
                                    'resnet_drivers': resnet_driver_launches['flash_attention'],
                                    'naflex_serve': naflex_serve_launches,
                                    'naflex_train': naflex_train_launches['flash_attention'],
                                    'naflex_drivers': naflex_driver_launches['flash_attention'],
                                    'so400m_serve': so400m_serve_launches['flash_attention'],
                                    'so400m_train': so400m_train_launches['flash_attention'],
                                    'so400m_drivers': so400m_driver_launches['flash_attention']},
                'fused_adamw': {'train': train_launches['fused_adamw'],
                                'input_train': input_launches['fused_adamw'],
                                'recipe_train': recipe_launches['fused_adamw'],
                                'drivers': driver_launches['fused_adamw'],
                                'convnext_train': convnext_train_launches['fused_adamw'],
                                'convnext_drivers': convnext_driver_launches['fused_adamw'],
                                'effnet_train': effnet_train_launches['fused_adamw'],
                                'effnet_drivers': effnet_driver_launches['fused_adamw'],
                                'resnet_train': resnet_train_launches['fused_adamw'],
                                'resnet_drivers': resnet_driver_launches['fused_adamw'],
                                'naflex_train': naflex_train_launches['fused_adamw'],
                                'naflex_drivers': naflex_driver_launches['fused_adamw'],
                                'dlittle_train': dlittle_train_launches['fused_adamw'],
                                'dlittle_drivers': dlittle_driver_launches['fused_adamw'],
                                'so400m_train': so400m_train_launches['fused_adamw'],
                                'so400m_drivers': so400m_driver_launches['fused_adamw']},
                'augment_epilogue': {'input_train': input_launches['augment_epilogue'],
                                     'recipe_train': recipe_launches['augment_epilogue'],
                                     'drivers': driver_launches['augment_epilogue'],
                                     'convnext_drivers':
                                         convnext_driver_launches['augment_epilogue'],
                                     'effnet_drivers': effnet_driver_launches['augment_epilogue'],
                                     'resnet_drivers': resnet_driver_launches['augment_epilogue'],
                                     'naflex_drivers': naflex_driver_launches['augment_epilogue'],
                                     'dlittle_drivers':
                                         dlittle_driver_launches['augment_epilogue']}}
    previous_rows = {'flash_attention': {r['case']: r for r in flash_checks['previous']},
                     'augment_epilogue': {r['case']: r for r in augment_rows}}
    lines = []
    for name, rec in verdicts.items():
        main = next(c for c in rec['cases'] if c['case'] == MAIN_CASE[name])
        line = {'name': name, 'route': 'cuda',
                'source': f'timm_tpu_torch/kernels/csrc/{name}.cu',
                'replaces': REPLACES[name].split(' ')[0],
                'launches': sum(launches[name].values()), 'launches_by_path': launches[name],
                # against the plain version, every registered case, dry and live arms
                'max_abs_err': rec['parity_max_err'], 'parity_tol': rec['parity_tol'],
                'verdict': rec['verdict'], 'vs_library': main['vs_library'],
                'ms': main['kernel_ms'], 'call_ms': main['call_ms'], 'plain_ms': main['plain_ms'],
                'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
                'bound_share': main['bound_share'], 'io_bytes': main['io_bytes'],
                'flops': main['flops'], 'library_ms': main['library_ms'], 'case': main['case']}
        if name in previous_rows:
            prev = previous_rows[name][MAIN_CASE[name]]
            line.update(previous_ms=prev['previous_ms'], previous_call_ms=prev['previous_call_ms'],
                        previous_source=f'timm_tpu_torch/kernels/csrc/previous/{name}.cu')
        else:
            # unchanged since it was ported: its previous design is itself
            line.update(previous_ms=main['kernel_ms'], previous_source=line['source'])
        lines.append(line)
    by_name = {line['name']: line for line in lines}
    by_name['flash_attention'].update(
        # every case and arm against the plain version, per element
        error_over_bound=verdicts['flash_attention']['error_over_bound'],
        # flash kernels that the profiled serving's replays ran on the card
        serve_replayed_kernels=serve_replayed,
        sharp_error_over_bound=flash_checks['sharp_error_over_bound'],
        backward_plain_ms_per_layer=attn_bwd_ms,
        backward_library_ms_per_layer=attn_bwd_library_ms,
        # the NaFlex train step's own shapes (B 288 at N 128, B 36 at N 1024)
        naflex_cases={c['case']: {k: c[k] for k in ('kernel_ms', 'call_ms', 'plain_ms', 'bound_ms',
                                                     'bound_by', 'bound_share', 'library_ms',
                                                     'vs_library', 'io_bytes', 'flops')}
                      for c in verdicts['flash_attention']['cases']
                      if c['case'] in ('naflex_n128', 'naflex_n1024')},
        # the ViT family's head dims and the latent pool's Nq 1 over Nk 256
        vit_family_cases={c['case']: {k: c[k] for k in ('kernel_ms', 'call_ms', 'plain_ms',
                                                         'bound_ms', 'bound_by', 'bound_share',
                                                         'library_ms', 'vs_library', 'io_bytes',
                                                         'flops')}
                          for c in verdicts['flash_attention']['cases']
                          if c['case'] in ('so400m_b64', 'so400m_map_pool', 'vit_h14_b64')})
    by_name['fused_adamw'].update(
        clipped_steps_max_abs_err=max(max(r['max_abs_err'][k] for k in ('p', 'v', 'ema'))
                                      for r in adamw_rows))
    by_name['augment_epilogue'].update(
        bf16_within_one_ulp=all(r['within_one_ulp'] for r in augment_rows
                                if r['out_dtype'] == 'bfloat16'),
        bit_identical_fp32=all(p['max_abs_err'] == 0.0
                               for p in verdicts['augment_epilogue']['parity']))
    emit({'kernels': lines, 'seconds': time.perf_counter() - t0, 'phase_seconds': seconds})
    print(device['nvidia_smi'], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': device['name'],
                                 'count': device['count']}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
