"""The nn/ modules and a small ResNet on the card against the same modules
(the same weights) on the CPU. No JAX; on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_vision_card.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
has not). Without a card the tests skip.
"""

import copy

import pytest
import torch

from of_spmm_tpu_torch import nn as onn
from of_spmm_tpu_torch.models import ResNet

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

TOL = 1e-4  # float32 max-relative, the main path's bar
TOL64 = 1e-10  # float64 max-relative: the card and the CPU round apart only there

CASES = {
    "lstm": (lambda d: onn.LSTM(16, 32, device=d, generator=torch.Generator().manual_seed(1)),
             [(12, 4, 16)], {}),
    "gru": (lambda d: onn.GRU(16, 32, device=d, generator=torch.Generator().manual_seed(2)),
            [(12, 4, 16)], {}),
    "rnn_relu": (lambda d: onn.RNN(16, 32, "relu", device=d,
                                   generator=torch.Generator().manual_seed(3)), [(12, 4, 16)], {}),
    "conv3d": (lambda d: onn.Conv3d(4, 6, 3, stride=(1, 2, 2), padding=1, device=d,
                                    generator=torch.Generator().manual_seed(4)),
               [(2, 4, 6, 10, 9)], {}),
    "conv_transpose2d": (lambda d: onn.ConvTranspose2d(6, 4, 4, stride=2, padding=1, device=d,
                                                       generator=torch.Generator().manual_seed(5)),
                         [(2, 6, 7, 8)], {}),
    "conv1d_groups": (lambda d: onn.Conv1d(4, 6, 3, padding=2, dilation=2, groups=2, device=d,
                                           generator=torch.Generator().manual_seed(6)),
                      [(2, 4, 20)], {}),
    "upsample_bilinear": (lambda d: onn.Upsample(1.5, mode="bilinear"), [(2, 3, 10, 14)], {}),
    "groupnorm": (lambda d: onn.GroupNorm(4, 8, device=d), [(2, 8, 6, 7)], {}),
    "instancenorm2d": (lambda d: onn.InstanceNorm2d(8, affine=True, device=d), [(2, 8, 6, 7)],
                       {}),
    "batchnorm_train": (lambda d: onn.BatchNorm(8, device=d), [(4, 5, 8)], {"train": True}),
    "adaptive_maxpool2d": (lambda d: onn.AdaptiveMaxPool2d((3, 5)), [(2, 3, 7, 9)], {}),
    "avgpool3d": (lambda d: onn.AvgPool3d(2, padding=1), [(1, 2, 5, 6, 4)], {}),
}


@pytest.fixture
def card():
    """The card, with TF32 off for float32 convolutions, recurrences and
    GEMMs (cuDNN allows TF32 by default), as chip_smoke.py runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda", 0)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _leaves(out) -> list:
    return [t for o in out for t in _leaves(o)] if isinstance(out, (tuple, list)) else [out]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().cpu() - b.detach()).abs().max() / b.abs().max().clamp_min(1e-30))


def _run(mod, xs, kw, dev):
    """Outputs, then the grads of sum(out * cot) of every parameter and
    input, and the buffers, all on the CPU."""
    inputs = [x.detach().to(dev).requires_grad_() for x in xs]
    out = _leaves(mod(*inputs, **kw))
    gen = torch.Generator().manual_seed(0)
    sum((o * torch.randn(o.shape, generator=gen, dtype=o.dtype).to(dev)).sum()
        for o in out).backward()
    got = {f"out{i}": o for i, o in enumerate(out)}
    got.update({f"grad_{n}": p.grad for n, p in mod.named_parameters()})
    got.update({f"grad_input{i}": x.grad for i, x in enumerate(inputs)})
    got.update({f"buffer_{n}": b for n, b in mod.named_buffers()})
    return {k: v.detach().cpu() for k, v in got.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_module_on_the_card_matches_the_cpu(case, card):
    make, shapes, kw = CASES[case]
    host = make("cpu")
    model = copy.deepcopy(host).to(card)
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn(s, generator=gen) for s in shapes]
    want = _run(host, xs, kw, "cpu")
    got = _run(model, xs, kw, card)
    assert set(got) == set(want)
    for k in want:
        assert torch.isfinite(got[k]).all() and _rel(got[k], want[k]) <= TOL, k


@pytest.mark.cuda
def test_small_resnet_train_step_on_the_card_matches_the_cpu(card):
    """ResNet(layers=(1, 1), width=8) in float64 (no branch of a ReLU or a
    max pool can go the other way at this precision): eval logits, then a
    train forward's logits, grads and updated BatchNorm buffers."""
    host = ResNet(layers=(1, 1), n_classes=10, width=8, device="cpu",
                  generator=torch.Generator().manual_seed(8)).double()
    model = copy.deepcopy(host).to(card)
    x = torch.randn((4, 3, 32, 32), generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    with torch.no_grad():
        assert _rel(model(x.to(card)), host(x)) <= TOL64
    want = _run(host, [x], {"train": True}, "cpu")
    got = _run(model, [x], {"train": True}, card)
    assert set(got) == set(want) and len(list(host.buffers())) == 2 * 9
    for k in want:
        assert _rel(got[k], want[k]) <= TOL64, k
