"""fmvfi_tpu_torch's CUDA kernels (K1 and K2) on the card.  This file imports neither
jax nor flax, so it also runs on the card's machine, which has neither:

    python -m pytest --noconftest tests/test_torch_cuda.py

(tests/conftest.py imports jax).  Without a card every test here skips.
"""

import pytest
import torch

from fmvfi_tpu_torch.ops import adacof as pt_adacof
from fmvfi_tpu_torch.ops import adacof_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("f,d", [(5, 1), (5, 2), (11, 1), (11, 2)])
def test_k1_matches_plain_on_the_card(cuda_device, f, d):
    """K1 against its plain version on the card: offsets to +-60 (clamped at
    48), an unaligned 37x53 output, within 1e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(f * 10 + d)
    b, c, h, w = 2, 3, 37, 53
    x = torch.rand((b, c, h + (f - 1) * d, w + (f - 1) * d), generator=g, device=cuda_device)
    fields = [torch.rand((b, f * f, h, w), generator=g, device=cuda_device) for _ in range(3)]
    wgt = torch.softmax(4.0 * fields[0], dim=1)  # sums to 1 over the taps, as the model's
    a, be = ((t * 2 - 1) * 60 for t in fields[1:])
    before = adacof_cuda.launches
    got = adacof_cuda.adacof_warp(x, wgt, a, be, d, 48)
    torch.cuda.synchronize()
    assert adacof_cuda.launches == before + 1
    want = pt_adacof.adacof_warp(x, wgt, a, be, d, 48)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_k1_wrapper_checks_its_inputs(cuda_device):
    x = torch.rand((1, 3, 12, 14), device=cuda_device)
    w, a, b = (torch.rand((1, 25, 8, 10), device=cuda_device) for _ in range(3))
    with pytest.raises(TypeError):
        adacof_cuda.adacof_warp(x.double(), w, a, b, 1, 48)
    with pytest.raises(ValueError):
        adacof_cuda.adacof_warp(x, w.transpose(2, 3).contiguous().transpose(2, 3), a, b, 1, 48)
    with pytest.raises(ValueError):
        adacof_cuda.adacof_warp(x, w.cpu(), a, b, 1, 48)
    with pytest.raises(ValueError):
        adacof_cuda.warp_bwd_cuda(x, w, a, b, torch.rand((1, 3, 8, 9), device=cuda_device), 1, 48)
    # fields that need a gradient go through K1, then K2 on the way back
    before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
    adacof_cuda.adacof_warp(x, w.requires_grad_(), a, b, 1, 48).sum().backward()
    torch.cuda.synchronize()
    assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert w.grad is not None and w.grad.device == x.device


@pytest.mark.gpu
@pytest.mark.parametrize("f,d,r", [(5, 1, 48), (5, 2, 48), (11, 1, 48), (11, 2, 48), (5, 1, None)])
def test_k2_matches_plain_on_the_card(cuda_device, f, d, r):
    """K2 against its plain version (autograd of the plain warp, saturation
    mask) on the card: offsets to +-60 so that the 48 px clamp saturates, an
    unaligned 37x53 output, softmax-normalised weights, within 1e-4."""
    g = torch.Generator(device=cuda_device).manual_seed(f * 10 + d)
    b, c, h, w = 2, 3, 37, 53
    x = torch.rand((b, c, h + (f - 1) * d, w + (f - 1) * d), generator=g, device=cuda_device)
    fields = [torch.rand((b, f * f, h, w), generator=g, device=cuda_device) for _ in range(3)]
    wgt = torch.softmax(4.0 * fields[0], dim=1)
    a, be = ((t * 2 - 1) * 60 for t in fields[1:])
    cot = torch.randn((b, c, h, w), generator=g, device=cuda_device)
    before = adacof_cuda.bwd_launches
    got = adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, d, r)
    torch.cuda.synchronize()
    assert adacof_cuda.bwd_launches == before + 1
    want = pt_adacof.adacof_warp_field_grads(x, wgt, a, be, cot, d, r)
    for k, o in zip(got, want):
        torch.testing.assert_close(k, o, rtol=0, atol=1e-4)
    if r is not None:
        assert (got[1][a.abs() >= r] == 0).all() and (got[2][be.abs() >= r] == 0).all()


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One AdaCoF train step at 64x64, batch 2, random weights: the loss and
    the updated params on the card (K1 once, K2 once, fp32, TF32 off,
    deterministic cuDNN) against the same step on the CPU."""
    import numpy as np

    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.train.trainer import make_adacof_trainer

    items = [translation_triplet(64, 64, dx=3.0 + i, dy=1.0, seed=i) for i in range(2)]
    batch = tuple(np.stack([it[j] for it in items]) for j in range(3))
    cpu_state, cpu_step = make_adacof_trainer(device="cpu")
    card_state, card_step = make_adacof_trainer(device=cuda_device)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    try:
        before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
        card_state, card_m = card_step(card_state, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags
    assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    cpu_state, cpu_m = cpu_step(cpu_state, batch)
    for k in cpu_m:
        assert abs(float(card_m[k]) - float(cpu_m[k])) <= 1e-5 * abs(float(cpu_m[k])), k
    card_sd = card_state.model.state_dict()
    for k, v in cpu_state.model.state_dict().items():
        torch.testing.assert_close(card_sd[k].cpu(), v, rtol=0, atol=1e-4, msg=k)


@pytest.mark.gpu
def test_fusion_interpolate_on_the_card_matches_the_cpu(cuda_device):
    """The whole pipeline with random weights at 64x64: three K1 launches,
    and >= 60 dB against the same pipeline on the CPU (plain warp), both
    with TF32 off."""
    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, fusion_interpolate

    torch.manual_seed(0)
    cpu = FusionModels(
        PhaseNetCore().init_params(torch.Generator().manual_seed(1)).eval(),
        AdaCoFNet().eval(),
        FusionNet(variant=2).eval(),
    )
    card = FusionModels(*(m.to(cuda_device) for m in
                          (PhaseNetCore(), AdaCoFNet(), FusionNet(variant=2))))
    for dst, src in zip(card, cpu):
        dst.load_state_dict(src.state_dict())
        dst.eval()
    f1, _, f2 = translation_triplet(64, 64, dx=2.0, dy=1.0, seed=0)
    ref = fusion_interpolate(cpu, f1[None], f2[None], device="cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = adacof_cuda.launches
        got = fusion_interpolate(card, f1[None], f2[None], device=cuda_device).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert adacof_cuda.launches - before == 3
    mse = float(torch.mean((got.double() - ref.double()) ** 2))
    assert mse == 0 or -10 * torch.log10(torch.tensor(mse)) >= 60
