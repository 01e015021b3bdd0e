"""Gradient checkpointing of the PyTorch port (``models/_manipulate.py``
``checkpoint_seq``, ``layers/recompute.py``): on the CPU, a checkpointed
step of every family that has it in JAX (ViT, DeiT, ConvNeXt, EfficientNet,
ResNet) gives the plain step's loss and gradients bit for bit, with drop
path 0.1 drawing from the model's own generator, and leaves that generator,
and BatchNorm's running statistics, where the plain step leaves them; the
train task and the driver flags take it; ``--block-scan`` runs the same
numbers. With the card, a checkpointed train step's CUDA-graph replays
against its eager body. No JAX here: the reference is the port's own plain
step (JAX's ``checkpoint_seq`` changes no number either).
"""
import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.layers.drop import get_drop_generator
from timm_tpu_torch.models import checkpoint_seq
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (entrypoint, its narrow arguments, image size)
_FAMILIES = [
    ('test_vit', dict(img_size=32), 32),
    ('deit_tiny_distilled_patch16_224', dict(img_size=32, depth=3, embed_dim=48), 32),
    ('test_convnext2', {}, 32),
    ('test_efficientnet', {}, 32),
    ('test_resnet', {}, 32),
]


def _model(name, kw, seed=0, drop_path_rate=0.1):
    return timm_tpu_torch.create_model(name, device='cpu', seed=seed, num_classes=7,
                                       drop_path_rate=drop_path_rate, **kw).train()


def _step(model, x, w):
    """Logits, and the gradients of sum(logits * w), of one training forward."""
    out = model(x)
    grads = torch.autograd.grad((out * w).sum(), [p for p in model.parameters()])
    return out.detach(), grads


def _buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


@pytest.mark.parametrize('name,kw,size', _FAMILIES, ids=[f[0] for f in _FAMILIES])
def test_checkpointed_step_is_the_plain_step(name, kw, size):
    """Two models from one seed, one checkpointed: three training steps from
    the same generator state give equal logits and gradients bit for bit,
    the generators end in equal states (the recompute drew nothing), and
    the running statistics are written once a step."""
    plain, ckpt = _model(name, kw), _model(name, kw)
    ckpt.set_grad_checkpointing(True)
    rng = np.random.default_rng(1)
    for step in range(3):
        x = torch.from_numpy(rng.random((4, size, size, 3), dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal((4, 7)).astype(np.float32))
        out_p, grads_p = _step(plain, x, w)
        out_c, grads_c = _step(ckpt, x, w)
        assert torch.equal(out_p, out_c), step
        assert all(torch.equal(a, b) for a, b in zip(grads_p, grads_c)), step
        assert torch.equal(get_drop_generator(plain).get_state(),
                           get_drop_generator(ckpt).get_state()), step
        bp, bc = _buffers(plain), _buffers(ckpt)
        assert all(torch.equal(bp[k], bc[k]) for k in bp), step


def test_checkpointing_runs_the_recompute():
    """The checkpointed ViT keeps no block's activations: its blocks run
    again in the backward pass (a forward pre-hook counts the calls: the
    recompute stops once it has what the backward needs, before the block
    returns)."""
    m = _model('test_vit', dict(img_size=32))
    m.set_grad_checkpointing(True)
    calls = []
    m.blocks[0].register_forward_pre_hook(lambda *a: calls.append(1))
    x = torch.rand(2, 32, 32, 3)
    m(x).sum().backward()
    assert len(calls) == 2


def test_batchnorm_statistics_are_written_once():
    """A checkpointed ResNet stage's recompute normalises with the batch
    statistics but leaves the running ones as the forward wrote them."""
    m = _model('test_resnet', {}, drop_path_rate=0.0)
    ref = _model('test_resnet', {}, drop_path_rate=0.0)
    m.set_grad_checkpointing(True)
    x = torch.rand(2, 32, 32, 3)
    before = _buffers(m)
    m(x).sum().backward()
    ref(x).sum().backward()
    after, want = _buffers(m), _buffers(ref)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(after[k], want[k]) for k in want)


def test_checkpoint_seq_every_and_skip_last():
    """Chunks of ``every`` modules and a plainly run last module give the
    plain sequence's output and gradients."""
    torch.manual_seed(0)
    mods = torch.nn.ModuleList([torch.nn.Linear(6, 6) for _ in range(5)])
    x = torch.randn(3, 6, requires_grad=True)
    want = x
    for m in mods:
        want = m(want)
    gw = torch.autograd.grad(want.square().sum(), [x] + list(mods.parameters()))
    for every, skip_last in ((1, False), (2, False), (2, True), (5, True)):
        got = checkpoint_seq(mods, x, every=every, skip_last=skip_last)
        gg = torch.autograd.grad(got.square().sum(), [x] + list(mods.parameters()))
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(gg, gw))


def test_masked_forward_runs_the_plain_loop(monkeypatch):
    """As in JAX, a forward with an attention mask (here the token pad's)
    runs the blocks plainly, not through checkpoint_seq."""
    import timm_tpu_torch.models.vision_transformer as vit

    def refuse(*a, **k):
        raise AssertionError('checkpoint_seq ran with a mask')
    m = timm_tpu_torch.create_model('test_vit', device='cpu', img_size=32, pad_tokens_to=8)
    m.set_grad_checkpointing(True)
    monkeypatch.setattr(vit, 'checkpoint_seq', refuse)
    m(torch.rand(2, 32, 32, 3)).sum().backward()
    m.pad_tokens_to = None
    with pytest.raises(AssertionError, match='with a mask'):
        m(torch.rand(2, 32, 32, 3))


def test_block_scan_runs_the_same_numbers():
    m = _model('test_vit', dict(img_size=32), drop_path_rate=0.0).eval()
    x = torch.rand(2, 32, 32, 3)
    with torch.no_grad():
        want = m(x)
        m.set_block_scan(True)
        assert m.block_scan and torch.equal(m(x), want)
    conv = timm_tpu_torch.create_model('test_convnext2', device='cpu').eval()
    with torch.no_grad():
        want = conv(x)
        conv.set_block_scan(True)
        assert torch.equal(conv(x), want)


def _task(grad_checkpointing, seed=0):
    from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
    from timm_tpu_torch.optim import create_optimizer_v2
    from timm_tpu_torch.task import ClassificationTask
    model = timm_tpu_torch.create_model('test_vit', img_size=32, num_classes=10, seed=seed,
                                        drop_path_rate=0.1, device='cpu')
    if grad_checkpointing:
        model.set_grad_checkpointing(True)
    opt = create_optimizer_v2(model, opt='adamw', lr=1e-3, weight_decay=0.05)
    task = ClassificationTask(model, optimizer=opt, train_loss_fn=LabelSmoothingCrossEntropy(0.1),
                              clip_grad=1.0, seed=seed)
    task.setup_ema(decay=0.99, warmup=True)
    return task


def test_train_task_steps_are_bit_for_bit_with_checkpointing():
    """ClassificationTask's train step (AdamW, clip, EMA, drop path 0.1):
    three steps with a checkpointed model give the plain task's metrics and
    parameters bit for bit."""
    rng = np.random.default_rng(3)
    batches = [{'input': torch.from_numpy(rng.random((4, 32, 32, 3), dtype=np.float32)),
                'target': torch.from_numpy(rng.integers(0, 10, 4))} for _ in range(3)]
    plain, ckpt = _task(False), _task(True)
    for i, b in enumerate(batches):
        mp = plain.train_step(b, lr=1e-3, step=i)
        mc = ckpt.train_step(b, lr=1e-3, step=i)
        assert all(torch.equal(torch.as_tensor(mp[k]), torch.as_tensor(mc[k])) for k in mp)
    sp, sc = plain.model.state_dict(), ckpt.model.state_dict()
    assert all(torch.equal(sp[k], sc[k]) for k in sp)


def test_train_driver_takes_grad_checkpointing_and_block_scan(tmp_path):
    """``--grad-checkpointing`` and ``--block-scan`` no longer raise: a
    one-epoch synthetic run of the train driver with both, then validate
    and inference with ``--block-scan``."""
    from timm_tpu_torch import train
    argv = ['--device', 'cpu', '--synthetic-data', '--model', 'test_vit', '--img-size', '32',
            '-b', '8', '--synthetic-len', '16', '--epochs', '1', '--opt', 'adamw', '--lr', '1e-3',
            '--drop-path', '0.1', '--output', str(tmp_path), '--experiment', 'x',
            '--grad-checkpointing', '--block-scan']
    assert train.main(argv) == 0


@pytest.mark.gpu
def test_checkpointed_train_step_replays_bit_for_bit_on_card():
    """On the card the checkpointed step is captured as a CUDA graph (the
    drop generator registered with it): 4 replayed steps against the
    eager body from one state, metrics, parameters and the generator's
    state bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
    from timm_tpu_torch.optim import create_optimizer_v2
    from timm_tpu_torch.task import ClassificationTask

    def task():
        model = timm_tpu_torch.create_model('test_vit', img_size=32, num_classes=10, seed=0,
                                            drop_path_rate=0.1, device='cuda',
                                            dtype=torch.bfloat16)
        model.set_grad_checkpointing(True)
        opt = create_optimizer_v2(model, opt='adamw', lr=1e-3, weight_decay=0.05)
        return ClassificationTask(model, optimizer=opt, seed=0,
                                  train_loss_fn=LabelSmoothingCrossEntropy(0.1))
    rng = np.random.default_rng(3)
    batches = [{'input': torch.from_numpy(rng.random((8, 32, 32, 3), dtype=np.float32)).cuda(),
                'target': torch.from_numpy(rng.integers(0, 10, 8)).cuda()} for _ in range(4)]
    graphed, eager = task(), task()
    for i, b in enumerate(batches):
        mg = graphed.train_step(b, lr=1e-3, step=i)
        eager.optimizer.set_hyperparams(lr=1e-3)
        eager.model.train()
        me = eager._train_body(b)
        torch.cuda.synchronize()
        assert torch.equal(mg['loss'], me['loss']), i
    assert graphed.train_graphs.replays >= 2
    sg, se = graphed.model.state_dict(), eager.model.state_dict()
    assert all(torch.equal(sg[k], se[k]) for k in sg)
    assert torch.equal(get_drop_generator(graphed.model).get_state(),
                       get_drop_generator(eager.model).get_state())
