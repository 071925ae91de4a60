"""fmvfi_tpu_torch's CUDA kernels (K1 and K2) on the card.  This file imports neither
jax nor flax, so it also runs on the card's machine, which has neither:

    python -m pytest --noconftest tests/test_torch_cuda.py

(tests/conftest.py imports jax).  Without a card every `gpu` test here skips;
the wrappers' Python-side helpers are tested on the CPU.

Each kernel has 6 instantiations (ops/adacof_cuda.py::PATH_NAMES): F 5 and 11
with C 3 (RGBX gathers), F and C at run time for any other F or C; each
through the asynchronous-copy ring (W % 4 == 0, aligned fields) or without
it.  The cases below name the one each takes, and the dispatch counters must
agree.
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


# (F, d, C, W, the instantiation): W = 53 leaves the field rows unaligned
INSTANTIATIONS = [
    (5, 1, 3, 53, "f5c3/regs"), (5, 2, 3, 53, "f5c3/regs"),
    (11, 1, 3, 53, "f11c3/regs"), (11, 2, 3, 53, "f11c3/regs"),
    (5, 1, 3, 52, "f5c3/ring"), (5, 2, 3, 52, "f5c3/ring"),
    (11, 1, 3, 52, "f11c3/ring"), (11, 2, 3, 52, "f11c3/ring"),
    (7, 1, 3, 53, "any/regs"), (7, 2, 3, 52, "any/ring"),
    (3, 1, 5, 53, "any/regs"), (3, 2, 5, 52, "any/ring"),
]


def _case(device, f, d, c, w, seed):
    """x and fields for a 2-image 37-row warp: offsets to +-60 (beyond the
    48 px clamp), softmax-normalised weights, and a cotangent."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, h = 2, 37
    x = torch.rand((b, c, h + (f - 1) * d, w + (f - 1) * d), generator=g, device=device)
    fields = [torch.rand((b, f * f, h, w), generator=g, device=device) for _ in range(3)]
    wgt = torch.softmax(4.0 * fields[0], dim=1)  # sums to 1 over the taps, as the model's
    a, be = ((t * 2 - 1) * 60 for t in fields[1:])
    cot = torch.randn((b, c, h, w), generator=g, device=device)
    return x, wgt, a, be, cot


@pytest.mark.gpu
@pytest.mark.parametrize("f,d,c,w,path", INSTANTIATIONS)
def test_k1_matches_plain_on_the_card(cuda_device, f, d, c, w, path):
    """K1 against its plain version on the card, within 1e-5, in each
    instantiation."""
    x, wgt, a, be, _ = _case(cuda_device, f, d, c, w, f * 10 + d)
    before, taken = adacof_cuda.launches, adacof_cuda.paths[path]
    got = adacof_cuda.adacof_warp(x, wgt, a, be, d, 48)
    torch.cuda.synchronize()
    assert (adacof_cuda.launches, adacof_cuda.paths[path]) == (before + 1, taken + 1)
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
    x4 = adacof_cuda.warp_fwd_cuda(x, w, a, b, 1, 48)[1]
    with pytest.raises(ValueError):
        adacof_cuda.warp_bwd_cuda(x, w, a, b, torch.rand((1, 3, 8, 9), device=cuda_device), 1, 48,
                                  x4)
    with pytest.raises(ValueError, match="RGBX"):  # K2 gathers from K1's copy of x
        adacof_cuda.warp_bwd_cuda(x, w, a, b, torch.rand((1, 3, 8, 10), device=cuda_device), 1,
                                  48, None)
    # fields that need a gradient go through K1, then K2 on the way back
    before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
    adacof_cuda.adacof_warp(x, w.requires_grad_(), a, b, 1, 48).sum().backward()
    torch.cuda.synchronize()
    assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert w.grad is not None and w.grad.device == x.device


@pytest.mark.gpu
@pytest.mark.parametrize("r", [48, None])
@pytest.mark.parametrize("f,d,c,w,path", INSTANTIATIONS)
def test_k2_matches_plain_on_the_card(cuda_device, f, d, c, w, path, r):
    """K2 against its plain version (autograd of the plain warp, saturation
    mask) on the card, within 1e-4, in each instantiation: offsets to +-60
    so that the 48 px clamp saturates, and unclamped."""
    x, wgt, a, be, cot = _case(cuda_device, f, d, c, w, f * 10 + d)
    x4 = adacof_cuda.warp_fwd_cuda(x, wgt, a, be, d, r)[1]  # K1's RGBX copy, as K3 keeps it
    assert (x4 is not None) == (c == 3 and f in adacof_cuda.RGBX_F)
    before, taken = adacof_cuda.bwd_launches, adacof_cuda.bwd_paths[path]
    got = adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, d, r, x4)
    torch.cuda.synchronize()
    assert (adacof_cuda.bwd_launches, adacof_cuda.bwd_paths[path]) == (before + 1, taken + 1)
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


@pytest.mark.gpu
def test_dispatch_counts_the_ring_and_unaligned_fields(cuda_device):
    """The main paths' launch (F 5, C 3, W % 4 == 0) takes the ring; the
    same fields one float off a 16-byte boundary take the register loads,
    with the same result."""
    x, wgt, a, be, cot = _case(cuda_device, 5, 1, 3, 64, 7)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    adacof_cuda.paths.clear()
    adacof_cuda.bwd_paths.clear()
    ring, x4 = adacof_cuda.warp_fwd_cuda(x, wgt, a, be, 1, 48)
    ring_g = adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, 1, 48, x4)
    moved = [unaligned(t) for t in (wgt, a, be)]
    regs, x4 = adacof_cuda.warp_fwd_cuda(x, *moved, 1, 48)
    regs_g = adacof_cuda.warp_bwd_cuda(x, *moved, cot, 1, 48, x4)
    torch.cuda.synchronize()
    assert dict(adacof_cuda.paths) == {"f5c3/ring": 1, "f5c3/regs": 1}
    assert dict(adacof_cuda.bwd_paths) == {"f5c3/ring": 1, "f5c3/regs": 1}
    torch.testing.assert_close(regs, ring, rtol=0, atol=1e-6)
    for u, v in zip(regs_g, ring_g):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-6)


def test_path_names_follow_the_c_codes():
    """PATH_NAMES[2 * instantiation + ring], as csrc/adacof_ring.cuh::path_code
    numbers them."""
    names = adacof_cuda.PATH_NAMES
    assert len(names) == len(set(names)) == 6
    for inst, name in enumerate(("any", "f5c3", "f11c3")):
        assert names[2 * inst] == f"{name}/regs" and names[2 * inst + 1] == f"{name}/ring"


@pytest.mark.parametrize("x_shape,field_shape,fits", [
    ((8, 3, 260, 260), (8, 25, 256, 256), True),  # the training launch
    ((4, 3, 1092, 1924), (4, 25, 1088, 1920), True),  # the 4-image 1080p launch
    ((1, 3, 9300, 9300), (1, 25, 9296, 9296), False),  # fields 2.2e9 per image
    ((1, 1, 2**30 + 4, 1), (1, 1, 2**30 + 4, 1), False),  # H_in >= 2^30
    ((1, 3, 30000, 30000), (1, 1, 29996, 29996), False),  # x 2.7e9 per image
])
def test_int32_check(x_shape, field_shape, fits):
    """The kernels' 32-bit offsets: per-image tensors of fewer than 2^31
    elements, H_in and W_in below 2^30."""
    if fits:
        adacof_cuda.check_int32(x_shape, field_shape)
    else:
        with pytest.raises(ValueError, match="32-bit"):
            adacof_cuda.check_int32(x_shape, field_shape)


@pytest.mark.parametrize("f", [5, 7, 11])
@pytest.mark.parametrize("c", [1, 3, 5])
def test_rgbx_scratch_only_for_three_channels(c, f):
    """An RGBX scratch where the instantiation gathers from one: 3
    channels and F 5 or 11."""
    x = torch.zeros((2, c, 9, 11))
    x4 = adacof_cuda.rgbx_scratch(x, f)
    if c == 3 and f in (5, 11):
        assert x4.shape == (2, 9, 11, 4) and x4.dtype == torch.float32
    else:
        assert x4 is None


@pytest.mark.gpu
def test_k3_hands_k1s_rgbx_copy_to_k2(cuda_device, monkeypatch):
    """On the training path K2 gathers from the RGBX copy of x that K1 wrote
    in the forward, with no second copy, and the gradients are those of K2
    called directly."""
    x, wgt, a, be, cot = _case(cuda_device, 5, 1, 3, 64, 3)
    seen = {}
    fwd, bwd = adacof_cuda.warp_fwd_cuda, adacof_cuda.warp_bwd_cuda

    def spy_fwd(*args):
        out, seen["fwd"] = fwd(*args)
        return out, seen["fwd"]

    def spy_bwd(*args):
        seen["bwd"] = args[-1]
        return bwd(*args)

    monkeypatch.setattr(adacof_cuda, "warp_fwd_cuda", spy_fwd)
    monkeypatch.setattr(adacof_cuda, "warp_bwd_cuda", spy_bwd)
    fields = [t.clone().requires_grad_() for t in (wgt, a, be)]
    adacof_cuda.adacof_warp(x, *fields, 1, 48).backward(cot)
    assert seen["fwd"] is not None and seen["bwd"] is seen["fwd"]
    x4 = fwd(x, wgt, a, be, 1, 48)[1]
    for got, want in zip((t.grad for t in fields), bwd(x, wgt, a, be, cot, 1, 48, x4)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_repeated_launches_at_1080p_are_bit_equal(cuda_device):
    """200 back-to-back launches each of K1 and K2 (with K1's RGBX copy) at
    the 2-image 1088x1920 launch: every result bit-equal to the first, the
    first within 1e-5 / 1e-4 of the plain versions.  A race in the ring
    would show as a difference."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, h, w = 2, 1088, 1920
    x = torch.rand((b, 3, h + 4, w + 4), generator=g, device=cuda_device)
    wgt = torch.softmax(2.0 * torch.randn((b, 25, h, w), generator=g, device=cuda_device), 1)
    a, be = ((torch.rand((b, 25, h, w), generator=g, device=cuda_device) * 2 - 1) * 3.0
             for _ in range(2))
    cot = torch.randn((b, 3, h, w), generator=g, device=cuda_device)
    first, x4 = adacof_cuda.warp_fwd_cuda(x, wgt, a, be, 1, 48)
    first_g = adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, 1, 48, x4=x4)
    torch.testing.assert_close(first, pt_adacof.adacof_warp(x, wgt, a, be, 1, 48),
                               rtol=0, atol=1e-5)
    for k, o in zip(first_g, pt_adacof.adacof_warp_field_grads(x, wgt, a, be, cot, 1, 48)):
        torch.testing.assert_close(k, o, rtol=0, atol=1e-4)
    differing = torch.zeros((), dtype=torch.int64, device=cuda_device)
    for _ in range(200):
        differing += (adacof_cuda.warp_fwd_cuda(x, wgt, a, be, 1, 48)[0] != first).any()
        got = adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, 1, 48, x4=x4)
        differing += torch.stack([(k != f).any() for k, f in zip(got, first_g)]).any()
    assert int(differing) == 0


def _triplets(size, n):
    import numpy as np

    from fmvfi_tpu_torch.eval.synth import translation_triplet

    items = [translation_triplet(size, size, dx=3.0 + i, dy=1.0 - i, seed=i) for i in range(n)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


@pytest.mark.gpu
def test_phase_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One PhaseNet step at 64x64, batch 2, mode fusion (K1 once on 4
    images, never K2), fp32, TF32 off, lr 1e-5: the metrics within 1e-4
    relative, the params and BN running statistics within 1e-4 of the
    CPU's step, and the step's gradient (Adam's first moment, 0.1 x it)
    within 2e-2 of each tensor's largest entry: twice float32's reach for
    this gradient, which tests/test_torch_train_phase_grads.py bounds at
    1e-2 of the float64 one on the CPU, for card and CPU each; a conv1
    bias, zero in exact arithmetic, against the net's largest."""
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.train.trainer import make_phase_trainer

    batch = _triplets(64, 2)
    torch.manual_seed(0)
    cpu_ada = AdaCoFNet()
    card_ada = AdaCoFNet().to(cuda_device)
    card_ada.load_state_dict(cpu_ada.state_dict())
    cpu_state, cpu_step, _, _ = make_phase_trainer(64, 64, lr=1e-5, mode="fusion",
                                                   adacof=cpu_ada, device="cpu")
    card_state, card_step, _, _ = make_phase_trainer(64, 64, lr=1e-5, mode="fusion",
                                                     adacof=card_ada, device=cuda_device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
        card_state, card_m = card_step(card_state, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (before[0] + 1, before[1])
    cpu_state, cpu_m = cpu_step(cpu_state, batch)
    for k in cpu_m:
        assert abs(float(card_m[k]) - float(cpu_m[k])) <= 1e-4 * abs(float(cpu_m[k])), k
    card_sd = card_state.model.state_dict()
    for k, v in cpu_state.model.state_dict().items():
        torch.testing.assert_close(card_sd[k].cpu(), v, rtol=0, atol=1e-4, msg=k)
    card_g, cpu_g = ({k: st.optimizer.state[p]["exp_avg"].cpu()
                      for k, p in st.model.named_parameters()} for st in (card_state, cpu_state))
    net_top = max(float(g.abs().max()) for g in cpu_g.values())
    for k, g in cpu_g.items():
        top = net_top if k.endswith("conv1.bias") else float(g.abs().max())
        assert float((card_g[k] - g).abs().max()) <= 2e-2 * top, k


@pytest.mark.gpu
def test_fusion_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One FusionNet step at 64x64, batch 2, random weights (variant 1, whose
    head starts nonzero): K1 three times, K2 never, the loss within 1e-4
    relative and FusionNet's params within 1e-4 of the CPU's step; the
    frozen nets hold no gradients.  FusionNet's gradient on the card's
    inputs (`fusion_inputs`) within 1e-4 of each tensor's largest entry of
    the CPU's on the same inputs: each side's own uncertainty maps can
    differ at a histogram-median bin edge (ROADMAP Q3-3)."""
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, fusion_inputs
    from fmvfi_tpu_torch.train.trainer import fusion_loss, make_fusion_trainer

    batch = _triplets(64, 2)
    torch.manual_seed(0)
    cpu_nets = (PhaseNetCore().init_params(torch.Generator().manual_seed(1)), AdaCoFNet())
    card_nets = (PhaseNetCore().to(cuda_device), AdaCoFNet().to(cuda_device))
    for dst, src in zip(card_nets, cpu_nets):
        dst.load_state_dict(src.state_dict())
    cpu_state, cpu_step = make_fusion_trainer(*cpu_nets, variant=1, device="cpu")
    card_state, card_step = make_fusion_trainer(*card_nets, variant=1, device=cuda_device)
    card_state.model.load_state_dict(cpu_state.model.state_dict())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
        card_state, card_m = card_step(card_state, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (before[0] + 3, before[1])
    cpu_state, cpu_m = cpu_step(cpu_state, batch)
    assert abs(float(card_m["loss"]) - float(cpu_m["loss"])) <= 1e-4 * abs(float(cpu_m["loss"]))
    card_sd = card_state.model.state_dict()
    for k, v in cpu_state.model.state_dict().items():
        torch.testing.assert_close(card_sd[k].cpu(), v, rtol=0, atol=1e-4, msg=k)
    assert all(p.grad is None for m in card_nets for p in m.parameters())

    models = FusionModels(*card_nets, card_state.model)
    target = torch.from_numpy(batch[1]).permute(0, 3, 1, 2).contiguous()
    grads = []
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            inputs, _ = fusion_inputs(models, batch[0], batch[2], cuda_device)
        for state, dev in ((card_state, cuda_device), (cpu_state, torch.device("cpu"))):
            state.model.load_state_dict(card_sd)
            loss, _ = fusion_loss(state.model(*(x.to(dev) for x in inputs)), target.to(dev))
            grads.append(torch.autograd.grad(loss, list(state.model.parameters())))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for k, (a, b) in enumerate(zip(*grads)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()), k
