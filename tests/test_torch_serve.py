"""Serving engine of the PyTorch port on the CPU, mirroring
tests/test_serve.py: bucketing, the admission queue, padded slots, declared
buckets only, per-request failure, drain, LRU residency and prewarm. The
engine runs test_vit at 32 px with ``device='cpu'``; padded-slot results are
held against the direct forward and against the JAX model carrying the same
weights.
"""
import threading
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
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


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
    every step runs the flash kernel once per block (a graph replay: the
    profiler counts the kernels, the wrapper's count does not move)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from timm_tpu_torch.kernels import flash_attention
    eng = InferenceEngine(buckets=(2, 4), max_wait_ms=5.0)
    eng.add_model('test_vit', img_size=32, dtype=torch.bfloat16)
    imgs = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(np.float32)
    before = flash_attention.launches
    eng.start()
    out = []
    try:
        ran = _flash_kernels_run(lambda: out.extend(
            f.result(timeout=120.0) for f in [eng.submit(im) for im in imgs]))
    finally:
        eng.shutdown(drain=True)
    rows = np.stack(out)
    model = eng.pool.acquire('test_vit').model
    assert flash_attention.launches == before
    assert ran == len(model.blocks) * eng.stats['steps'] > 0
    with torch.inference_mode():
        direct = model(torch.from_numpy(imgs).cuda()).float().cpu().numpy()
    assert np.linalg.norm(rows - direct) / np.linalg.norm(direct) <= 2e-2


# ---- bucket graphs on the card ----------------------------------------------

def _card_engine(buckets=(1, 2, 4), **kw):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = InferenceEngine(buckets=buckets, max_wait_ms=5.0, **kw)
    eng.add_model('test_vit', img_size=32, dtype=torch.bfloat16)
    return eng


def _replay_and_eager(eng, name, bucket, seed):
    """A seeded batch through the bucket's graph and through an eager
    forward of the same model."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (bucket, 32, 32, 3)).astype(np.float32))
    res = eng.pool.acquire(name)
    with torch.inference_mode():
        replayed = res.compiled[bucket].run(x.pin_memory())
        eager = res.model(x.cuda()).float()
    torch.cuda.synchronize()
    return replayed, eager


@pytest.mark.gpu
def test_bucket_graphs_replay_bit_for_bit_on_card():
    """One graph per declared bucket, captured at prewarm; each replay
    equals an eager forward of the same batch bit for bit."""
    eng = _card_engine()
    stats = eng.snapshot_stats()['prewarm']['test_vit']
    assert stats['programs'] == 3 and stats['mode'] == 'graph'
    assert set(eng.aot_executables('test_vit')) == {1, 2, 4}
    for bucket in eng.buckets:
        replayed, eager = _replay_and_eager(eng, 'test_vit', bucket, bucket)
        assert replayed.shape == (bucket, 1000) and torch.equal(replayed, eager), bucket


@pytest.mark.gpu
def test_undeclared_shape_raises_on_card():
    eng = _card_engine()
    graph = eng.aot_executables('test_vit')[4]
    with pytest.raises(ValueError, match='only declared buckets'):
        graph.run(torch.zeros(3, 32, 32, 3).pin_memory())
    eng.start()
    try:
        bad = eng.submit(np.zeros((16, 16, 3), np.float32))
        with pytest.raises(ValueError, match='only declared buckets'):
            bad.result(timeout=120.0)
    finally:
        eng.shutdown(drain=True)


def _flash_kernels_run(fn):
    """Flash kernels the card ran during ``fn()``, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and 'flash_fwd_kernel' in e.name)


@pytest.mark.gpu
def test_launches_counted_through_replays_on_card():
    """A replay runs no Python: the wrapper counts the capture's launches
    only, the engine counts its replays per bucket, and the profiler sees
    each served replay run the captured flash kernels."""
    from timm_tpu_torch.kernels import flash_attention
    eng = _card_engine()
    depth = len(eng.pool.acquire('test_vit').model.blocks)
    for graph in eng.aot_executables('test_vit').values():
        assert graph.launches == {'flash_attention': depth}
    before = flash_attention.launches
    rng = np.random.default_rng(0)

    def serve():
        for burst in (1, 2, 4, 3):
            futures = [eng.submit(rng.standard_normal((32, 32, 3)).astype(np.float32))
                       for _ in range(burst)]
            for f in futures:
                f.result(timeout=120.0)

    eng.start()
    try:
        ran = _flash_kernels_run(serve)
    finally:
        eng.shutdown(drain=True)
    stats = eng.snapshot_stats()
    assert stats['failed'] == 0 and flash_attention.launches == before
    assert stats['replays_by_bucket'] == stats['steps_by_bucket']
    assert ran == depth * sum(stats['replays_by_bucket'].values()) > 0


@pytest.mark.gpu
def test_graph_memory_counted_in_budget_on_card():
    """The memory a model's graphs keep is measured at prewarm and counted
    against the pool's budget: a budget that holds two models' parameters
    but not their graphs keeps one model."""
    eng = _card_engine()
    res = eng.pool.acquire('test_vit')
    static_in = sum(g.static_in.numel() * 4 for g in res.compiled.values())
    assert res.graph_bytes > static_in
    assert eng.snapshot_stats()['prewarm']['test_vit']['graph_bytes'] == res.graph_bytes
    assert eng.pool.resident_bytes() == res.param_bytes + res.graph_bytes
    eng.add_model('test_vit2', img_size=32, dtype=torch.bfloat16, prewarm=False)
    eng.pool.budget_bytes = 2 * res.param_bytes + res.graph_bytes // 2
    eng.pool.acquire('test_vit2')
    assert eng.pool.resident_names == ('test_vit2',)
    assert eng.pool.acquire('test_vit2').graph_bytes > static_in


@pytest.mark.gpu
def test_model_added_while_serving_on_card():
    """A capture holds its own thread only: a model added from the caller's
    thread while the scheduler serves another is captured, no request
    fails, and the new model's replays equal its eager forwards."""
    eng = _card_engine()
    eng.start()
    stop, futures = threading.Event(), []

    def submit_loop():
        rng = np.random.default_rng(0)
        while not stop.is_set():
            futures.append(eng.submit(rng.standard_normal((32, 32, 3)).astype(np.float32),
                                      model='test_vit'))
            time.sleep(0.0005)

    feeder = threading.Thread(target=submit_loop)
    feeder.start()
    try:
        while len(futures) < 8:
            time.sleep(0.001)
        during = len(futures)
        eng.add_model('test_vit2', img_size=32, dtype=torch.bfloat16, seed=1)
        assert len(futures) > during  # requests kept coming during the capture
    finally:
        stop.set()
        feeder.join()
    for f in futures:
        f.result(timeout=120.0)
    eng.shutdown(drain=True)
    assert eng.stats['failed'] == 0 and eng.stats['completed'] == len(futures)
    assert eng.snapshot_stats()['prewarm']['test_vit2']['programs'] == 3
    for bucket in eng.buckets:
        replayed, eager = _replay_and_eager(eng, 'test_vit2', bucket, bucket)
        assert torch.equal(replayed, eager), bucket


@pytest.mark.gpu
def test_evicted_model_recaptures_and_in_place_load_on_card():
    """An evicted model's graphs go with it; loaded again, it is captured
    anew and serves the same logits. Weights loaded in place into a
    resident model reach its graphs."""
    eng = _card_engine()
    eng.add_model('test_vit2', img_size=32, dtype=torch.bfloat16, prewarm=False)
    first, _ = _replay_and_eager(eng, 'test_vit', 4, 7)
    graphs = eng.aot_executables('test_vit')
    eng.pool.budget_bytes = int(1.25 * eng.pool.acquire('test_vit').param_bytes)
    eng.pool.acquire('test_vit2')
    assert eng.pool.resident_names == ('test_vit2',)
    again, eager = _replay_and_eager(eng, 'test_vit', 4, 7)
    assert eng.pool.stats['evictions'] == 2 and eng.pool.stats['loads'] == 3
    assert eng.aot_executables('test_vit')[4] is not graphs[4]
    assert torch.equal(again, first) and torch.equal(again, eager)
    other = timm_tpu_torch.create_model('test_vit', img_size=32, dtype=torch.bfloat16, seed=1,
                                        device='cuda')
    eng.pool.acquire('test_vit').model.load_state_dict(other.state_dict())
    replayed, eager = _replay_and_eager(eng, 'test_vit', 4, 7)
    assert torch.equal(replayed, eager) and not torch.equal(replayed, first)


@pytest.mark.gpu
def test_failed_capture_raises_on_card():
    """On the card the engine never runs a bucket eagerly: a model that
    cannot be captured fails add_model."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')

    class Uncapturable(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = timm_tpu_torch.create_model('test_vit', img_size=32, device='cuda')

        def forward(self, x):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError('this forward cannot be captured')
            return self.net(x)

    eng = InferenceEngine(buckets=(2,))
    with pytest.raises(RuntimeError, match='cannot be captured'):
        eng.add_model('test_vit', factory=Uncapturable, input_size=(32, 32, 3))
    assert eng.pool.resident_names == ()
