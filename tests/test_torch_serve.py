"""Serving engine of the PyTorch port on the CPU, mirroring
tests/test_serve.py: bucketing, the admission queue, padded slots, declared
buckets only, per-request failure, drain, LRU residency and prewarm. The
engine runs test_vit at 32 px with ``device='cpu'``; padded-slot results are
held against the direct forward and against the JAX model carrying the same
weights.
"""
import time

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.models import load_jax_state_dict
from timm_tpu_torch.serve import (
    InferenceEngine, RequestQueue, batch_bucket, module_bytes, pad_rows, select_bucket,
    strip_rows, validate_buckets,
)


def test_select_bucket_smallest_fitting():
    buckets = (1, 4, 16, 64, 256)
    assert [select_bucket(n, buckets) for n in (1, 2, 4, 5, 17, 256)] == [1, 4, 4, 16, 64, 256]
    with pytest.raises(ValueError, match='largest declared bucket'):
        select_bucket(257, buckets)
    with pytest.raises(ValueError):
        select_bucket(0, (1, 4))


def test_validate_buckets():
    assert validate_buckets((16, 4, 4, 1)) == (1, 4, 16)
    with pytest.raises(ValueError, match='at least one'):
        validate_buckets(())
    with pytest.raises(ValueError, match='positive'):
        validate_buckets((0, 4))
    assert batch_bucket(100, 8) == 104


def test_pad_rows_and_strip_rows():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    xp, valid = pad_rows(x, 8)
    assert xp.shape == (8, 4) and valid.tolist() == [True] * 3 + [False] * 5
    assert np.array_equal(xp[3:], np.repeat(x[:1], 5, axis=0))  # row 0 repeated
    np.testing.assert_array_equal(strip_rows(xp, 3), x)
    t = torch.from_numpy(xp)
    stripped = strip_rows({'logits': t, 'aux': (t, t)}, 3)
    assert stripped['logits'].shape == (3, 4) and stripped['aux'][1].shape == (3, 4)
    with pytest.raises(ValueError, match='does not fit'):
        pad_rows(x, 2)


def test_queue_full_bucket_admitted_immediately():
    q = RequestQueue(max_bucket=4, max_wait_s=10.0)
    for _ in range(4):
        q.submit('m', np.zeros(2))
    t0 = time.perf_counter()
    model, reqs = q.wait_admission(timeout=5.0)
    assert model == 'm' and len(reqs) == 4 and time.perf_counter() - t0 < 1.0


def test_queue_never_starves_past_deadline():
    q = RequestQueue(max_bucket=64, max_wait_s=0.03)
    for _ in range(3):
        q.submit('m', np.zeros(2))
    t0 = time.perf_counter()
    admission = q.wait_admission(timeout=2.0)
    assert admission is not None and len(admission[1]) == 3
    assert 0.02 <= time.perf_counter() - t0 < 1.0


def test_queue_close_without_drain_fails_pending():
    q = RequestQueue(max_bucket=4, max_wait_s=10.0)
    fut = q.submit('m', np.zeros(2))
    q.close(drain=False)
    with pytest.raises(RuntimeError, match='shut down'):
        fut.result(timeout=1.0)
    assert q.wait_admission(timeout=0.1) is None and q.finished()


@pytest.fixture(scope='module')
def engine():
    eng = InferenceEngine(buckets=(2, 4), max_wait_ms=10.0, device='cpu')
    eng.add_model('test_vit', img_size=32)
    eng.start()
    yield eng
    eng.shutdown(drain=True)


def test_engine_prewarm_runs_every_bucket(engine):
    stats = engine.snapshot_stats()['prewarm']['test_vit']
    assert stats['programs'] == 2 and set(stats['bucket_ms']) == {2, 4}
    res = engine.pool.acquire('test_vit')
    assert not any(p.requires_grad for p in res.model.parameters())
    assert not res.model.training


def test_engine_padded_slot_outputs_dropped(engine):
    """3 requests into the 4-bucket: every caller gets its own row back, equal
    to the direct forward and to the JAX model carrying the same weights."""
    import jax.numpy as jnp

    import timm_tpu
    from timm_tpu.models._helpers import model_state_dict

    imgs = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
    before = engine.stats['padded_slots']
    futs = [engine.submit(im) for im in imgs]
    rows = np.stack([f.result(timeout=120.0) for f in futs])
    assert rows.shape == (3, 1000) and rows.dtype == np.float32
    assert engine.stats['padded_slots'] > before
    model = engine.pool.acquire('test_vit').model
    with torch.no_grad():
        direct = model(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(rows, direct, atol=1e-5, rtol=1e-5)

    jm = timm_tpu.create_model('test_vit', img_size=32)
    jm.eval()
    check = timm_tpu_torch.create_model('test_vit', img_size=32, device='cpu').eval()
    load_jax_state_dict(check, model_state_dict(jm))
    model.load_state_dict(check.state_dict())  # the served model now carries the JAX weights
    futs = [engine.submit(im) for im in imgs]
    rows = np.stack([f.result(timeout=120.0) for f in futs])
    np.testing.assert_allclose(rows, np.asarray(jm(jnp.asarray(imgs))), atol=1e-5, rtol=0)


def test_engine_only_declared_buckets_dispatch(engine):
    futs = [engine.submit(np.zeros((32, 32, 3), np.float32)) for _ in range(7)]
    for f in futs:
        f.result(timeout=120.0)
    assert set(engine.stats['steps_by_bucket']) <= set(engine.buckets)
    assert sum(engine.stats['request_sizes'].values()) == engine.stats['steps']


def test_engine_bad_input_shape_fails_that_request(engine):
    fut = engine.submit(np.zeros((16, 16, 3), np.float32))
    with pytest.raises(ValueError, match='Input size'):
        fut.result(timeout=120.0)
    ok = engine.submit(np.zeros((32, 32, 3), np.float32))
    assert ok.result(timeout=120.0).shape == (1000,)


def test_engine_submit_requires_start():
    eng = InferenceEngine(buckets=(2,), device='cpu')
    with pytest.raises(RuntimeError, match='start'):
        eng.submit(np.zeros((32, 32, 3), np.float32))


def test_engine_needs_model_name_with_two_models():
    eng = InferenceEngine(buckets=(2,), device='cpu')
    eng.add_model('test_vit', img_size=32, prewarm=False)
    eng.add_model('test_vit2', img_size=32, prewarm=False)
    eng.start()
    try:
        with pytest.raises(ValueError, match='model= is required'):
            eng.submit(np.zeros((32, 32, 3), np.float32))
        out = eng.submit(np.zeros((32, 32, 3), np.float32), model='test_vit2')
        assert out.result(timeout=120.0).shape == (1000,)
    finally:
        eng.shutdown(drain=True)


def test_engine_clean_drain_on_shutdown():
    """Requests still queued at shutdown(drain=True) all complete."""
    eng = InferenceEngine(buckets=(2, 4), max_wait_ms=10_000.0, device='cpu')
    eng.add_model('test_vit', img_size=32)
    eng.start()
    futs = [eng.submit(np.zeros((32, 32, 3), np.float32)) for _ in range(5)]
    eng.shutdown(drain=True)
    for f in futs:
        assert f.result(timeout=1.0).ndim == 1
    stats = eng.snapshot_stats()
    assert stats['completed'] == 5 and stats['failed'] == 0 and eng.pending() == 0


def test_lru_eviction_respects_memory_budget():
    eng = InferenceEngine(buckets=(2,), device='cpu')
    eng.add_model('test_vit', img_size=32, prewarm=False)
    eng.add_model('test_vit2', img_size=32, prewarm=False)
    a = eng.pool.acquire('test_vit')
    assert a.param_bytes == module_bytes(a.model) > 0
    eng.pool.budget_bytes = int(1.25 * a.param_bytes)  # fits one of the pair
    eng.pool.acquire('test_vit2')
    assert eng.pool.resident_names == ('test_vit2',) and eng.pool.stats['evictions'] == 1
    assert eng.pool.resident_bytes() <= eng.pool.budget_bytes
    eng.pool.acquire('test_vit')
    assert eng.pool.resident_names == ('test_vit',) and eng.pool.stats['evictions'] == 2


def test_eviction_keeps_oversized_model():
    eng = InferenceEngine(buckets=(2,), memory_budget_bytes=1, device='cpu')
    eng.add_model('test_vit', img_size=32, prewarm=False)
    assert eng.pool.acquire('test_vit').param_bytes > 1
    assert eng.pool.resident_names == ('test_vit',)


@pytest.mark.gpu
def test_engine_on_card():
    """The engine on the card: padded slots equal the direct forward, and
    every step launches the flash kernel once per block."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from timm_tpu_torch.kernels import flash_attention
    eng = InferenceEngine(buckets=(2, 4), max_wait_ms=5.0)
    eng.add_model('test_vit', img_size=32, dtype=torch.bfloat16)
    imgs = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(np.float32)
    before = flash_attention.launches
    eng.start()
    try:
        rows = np.stack([f.result(timeout=120.0) for f in [eng.submit(im) for im in imgs]])
    finally:
        eng.shutdown(drain=True)
    model = eng.pool.acquire('test_vit').model
    assert flash_attention.launches - before == len(model.blocks) * eng.stats['steps']
    with torch.inference_mode():
        direct = model(torch.from_numpy(imgs).cuda()).float().cpu().numpy()
    assert np.linalg.norm(rows - direct) / np.linalg.norm(direct) <= 2e-2
