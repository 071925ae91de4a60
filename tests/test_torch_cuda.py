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
@pytest.mark.parametrize("f,w,path", [(5, 512, "f5c3/ring"), (11, 768, "f11c3/ring"),
                                      (7, 512, "any/ring")])
def test_ring_with_far_offsets_over_many_blocks(cuda_device, f, w, path):
    """K1 and K2 through the ring where its consumers lag the producer:
    offsets to +-60 (gathers far from the tile) and more blocks than the
    card holds at once (2 images of 256 rows).  Without the ring's proxy
    fence (csrc/adacof_ring.cuh) both read later taps' fields, differently
    from run to run; each of three launches within 1e-5 / 1e-4 of the
    plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(f)
    b, h = 2, 256
    x = torch.rand((b, 3, h + f - 1, w + f - 1), generator=g, device=cuda_device)
    wgt = torch.softmax(4.0 * torch.rand((b, f * f, h, w), generator=g, device=cuda_device), 1)
    a, be = ((torch.rand((b, f * f, h, w), generator=g, device=cuda_device) * 2 - 1) * 60
             for _ in range(2))
    cot = torch.randn((b, 3, h, w), generator=g, device=cuda_device)
    want = pt_adacof.adacof_warp(x, wgt, a, be, 1, 48)
    want_grads = pt_adacof.adacof_warp_field_grads(x, wgt, a, be, cot, 1, 48)
    taken = adacof_cuda.paths[path]
    for _ in range(3):
        got, x4 = adacof_cuda.warp_fwd_cuda(x, wgt, a, be, 1, 48)
        grads = adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, 1, 48, x4)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        for gg, ww in zip(grads, want_grads):
            torch.testing.assert_close(gg, ww, rtol=0, atol=1e-4)
    assert adacof_cuda.paths[path] == taken + 3


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


@pytest.mark.parametrize("c,f", [(3, 5), (5, 3)])
def test_the_operator_holds_a_scratch_only_for_cuda_tensors(c, f):
    """fmvfi::adacof_warp_fwd on CPU tensors is the plain warp with an
    empty x4; its fake gives K1's RGBX scratch shape for a CUDA x (where
    the instantiation gathers from one) and (0,) for a CPU x, as the real
    kernels do."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from fmvfi_tpu_torch.ops.adacof import adacof_warp as warp_plain

    g = torch.Generator().manual_seed(f)
    h, w = 8, 9
    x = torch.rand((2, c, h + f - 1, w + f - 1), generator=g)
    wgt, a, be = (torch.randn((2, f * f, h, w), generator=g) for _ in range(3))
    out, x4 = torch.ops.fmvfi.adacof_warp_fwd(x, wgt, a, be, 1, 48)
    assert torch.equal(out, warp_plain(x, wgt, a, be, 1, 48)) and x4.shape == (0,)
    with FakeTensorMode():
        rgbx = (2, h + f - 1, w + f - 1, 4) if c == 3 else (0,)
        for dev, want in (("cpu", (0,)), ("cuda", rgbx)):
            fx = torch.empty(x.shape, device=dev)
            fw = torch.empty(wgt.shape, device=dev)
            out, x4 = torch.ops.fmvfi.adacof_warp_fwd(fx, fw, fw, fw, 1, 48)
            assert out.shape == (2, c, h, w) and x4.shape == want and x4.device == fx.device


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


# the main paths' instantiation (RGBX gathers, the ring) and one that
# gathers planar x (F and C at run time): x4 empty
OP_CASES = [(5, 1, 3, 52, "f5c3/ring"), (3, 2, 5, 52, "any/ring")]


@pytest.mark.gpu
@pytest.mark.parametrize("f,d,c,w,path", OP_CASES)
def test_kernels_through_the_registered_operators_equal_the_direct_launches(
        cuda_device, f, d, c, w, path):
    """fmvfi::adacof_warp_fwd and fmvfi::adacof_warp_bwd on CUDA tensors are
    K1 and K2: bit-equal to warp_fwd_cuda / warp_bwd_cuda, each call counted
    once with its instantiation."""
    x, wgt, a, be, cot = _case(cuda_device, f, d, c, w, 40 + f)
    direct, x4 = adacof_cuda.warp_fwd_cuda(x, wgt, a, be, d, 48)
    before = (adacof_cuda.launches, adacof_cuda.paths[path])
    out, x4_op = torch.ops.fmvfi.adacof_warp_fwd(x, wgt, a, be, d, 48)
    torch.cuda.synchronize()
    assert (adacof_cuda.launches, adacof_cuda.paths[path]) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, direct)
    if x4 is None:
        assert x4_op.shape == (0,)
    else:
        assert torch.equal(x4_op, x4)
    before = (adacof_cuda.bwd_launches, adacof_cuda.bwd_paths[path])
    got = torch.ops.fmvfi.adacof_warp_bwd(x, x4_op, wgt, a, be, cot, d, 48)
    torch.cuda.synchronize()
    assert (adacof_cuda.bwd_launches, adacof_cuda.bwd_paths[path]) == (before[0] + 1,
                                                                        before[1] + 1)
    for g_op, g_direct in zip(got, adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, d, 48, x4)):
        assert torch.equal(g_op, g_direct)


@pytest.mark.gpu
@pytest.mark.parametrize("f,d,c,w,path", OP_CASES)
def test_k3_gradients_are_unchanged_through_the_operators(cuda_device, f, d, c, w, path):
    """K3 (adacof_warp with autograd) reaches K1 once and K2 once, and its
    field gradients are K2's called directly on K1's scratch, bit for bit;
    dx is zero."""
    x, wgt, a, be, cot = _case(cuda_device, f, d, c, w, 50 + f)
    xg = x.clone().requires_grad_()
    fields = [t.clone().requires_grad_() for t in (wgt, a, be)]
    before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
    adacof_cuda.adacof_warp(xg, *fields, d, 48).backward(cot)
    torch.cuda.synchronize()
    assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    x4 = adacof_cuda.warp_fwd_cuda(x, wgt, a, be, d, 48)[1]
    for got, want in zip((t.grad for t in fields),
                         adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, d, 48, x4)):
        assert torch.equal(got, want)
    assert torch.count_nonzero(xg.grad) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("built_on", ["cpu", "cuda"])
def test_cuda_artifact_launches_k1_and_matches_the_live_pipeline(cuda_device, built_on,
                                                                 monkeypatch):
    """A ("cuda",) fusion artifact at 64x64, exported from models on the
    CPU (no card needed to build it) or on the card, loaded onto the card:
    K1 three times a request on 2, 4 and 2 images, counted through the
    operator, and >= 60 dB against the live pipeline on the card."""
    import numpy as np

    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, fusion_interpolate
    from fmvfi_tpu_torch.utils.export import export_pipeline, load_exported

    torch.manual_seed(0)
    cpu = FusionModels(PhaseNetCore().init_params(torch.Generator().manual_seed(1)).eval(),
                       AdaCoFNet().eval(), FusionNet(variant=2).eval())
    card = FusionModels(*(m.to(cuda_device) for m in
                          (PhaseNetCore(), AdaCoFNet(), FusionNet(variant=2))))
    for dst, src in zip(card, cpu):
        dst.load_state_dict(src.state_dict())
        dst.eval()
    blob = export_pipeline(cpu if built_on == "cpu" else card, 64, 64, "fusion", variant=2,
                           platforms=("cuda",))
    fn = load_exported(blob, device=cuda_device)
    f1, _, f2 = translation_triplet(64, 64, dx=2.0, dy=1.0, seed=0)
    images, real = [], adacof_cuda.warp_fwd_cuda

    def recording(x, *args):
        images.append(x.shape[0])
        return real(x, *args)

    monkeypatch.setattr(adacof_cuda, "warp_fwd_cuda", recording)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = dict(adacof_cuda.paths)
        got = fn(f1[None], f2[None])
        torch.cuda.synchronize()
        assert images == [2, 4, 2]
        assert adacof_cuda.paths["f5c3/ring"] == before.get("f5c3/ring", 0) + 3
        want = fusion_interpolate(card, f1[None], f2[None], device=cuda_device)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.device.type == "cuda" and got.shape == (1, 64, 64, 3)
    mse = float(torch.mean((got.double() - want.double()) ** 2))
    assert mse == 0 or -10 * np.log10(mse) >= 60


@pytest.mark.gpu
def test_bf16_request_launches_k1_on_float32_fields(cuda_device, monkeypatch):
    """A bfloat16 fusion request at 256x256 with random weights: K1 three
    times on 2, 4 and 2 images via f5c3/ring, every frame and field it gets
    float32, the output float32 and >= 35 dB against the float32 request."""
    import numpy as np

    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, fusion_interpolate

    torch.manual_seed(0)
    models = FusionModels(
        PhaseNetCore().init_params(torch.Generator().manual_seed(1)).to(cuda_device).eval(),
        AdaCoFNet().to(cuda_device).eval(), FusionNet(variant=2).to(cuda_device).eval())
    f1, _, f2 = translation_triplet(256, 256, dx=2.0, dy=1.0, seed=0)
    seen, real = [], adacof_cuda.warp_fwd_cuda

    def recording(x, w, a, b, *args):
        seen.append((x.shape[0], {t.dtype for t in (x, w, a, b)}))
        return real(x, w, a, b, *args)

    monkeypatch.setattr(adacof_cuda, "warp_fwd_cuda", recording)
    before = adacof_cuda.paths["f5c3/ring"]
    got = fusion_interpolate(models, f1[None], f2[None], device=cuda_device,
                             compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert [n for n, _ in seen] == [2, 4, 2] and all(d == {torch.float32} for _, d in seen)
    assert adacof_cuda.paths["f5c3/ring"] == before + 3
    fp32 = fusion_interpolate(models, f1[None], f2[None], device=cuda_device)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    mse = float(torch.mean((got.double() - fp32.double()) ** 2))
    assert mse > 0 and -10 * np.log10(mse) >= 35


@pytest.mark.gpu
def test_data_parallel_step_on_one_card_matches_the_plain_step(cuda_device):
    """One AdaCoF step under data_parallel on a 1-process NCCL group: K1 and
    K2 once, and the parameters within 1e-5 of the plain step's, a
    hundredth of its Adamax update (lr 1e-3): the backward of
    F.interpolate's bilinear mode adds with atomics on CUDA, so no two runs
    of the step are bit-equal (the plain step against itself is printed)."""
    import numpy as np
    import torch.distributed as dist

    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.parallel import distributed
    from fmvfi_tpu_torch.parallel.dp import data_parallel
    from fmvfi_tpu_torch.parallel.mesh import make_mesh, replicate
    from fmvfi_tpu_torch.train.trainer import make_adacof_trainer

    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    items = [translation_triplet(64, 64, dx=3.0 + i, dy=1.0, seed=i) for i in range(2)]
    batch = tuple(np.stack([it[j] for it in items]) for j in range(3))

    def params(state):
        return {k: v.double() for k, v in state.model.state_dict().items()}

    def gap(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in b)

    distributed.initialize(backend="nccl")
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh()
        assert mesh.device_type == "cuda" and mesh.size() == 1
        plain = []
        for _ in range(2):
            state, step = make_adacof_trainer(device=cuda_device)
            plain.append(params(step(state, batch)[0]))
        state, step = make_adacof_trainer(device=cuda_device)
        state = replicate(mesh, state)
        before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
        state, _ = data_parallel(step, mesh)(state, batch)
        torch.cuda.synchronize()
        assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
        print(f"data_parallel {gap(params(state), plain[0]):.3g} from the plain step, "
              f"the plain step {gap(plain[1], plain[0]):.3g} from itself")
        assert gap(params(state), plain[0]) <= 1e-5
    finally:
        torch.backends.cudnn.deterministic = flags
        dist.destroy_process_group()


@pytest.fixture
def nccl_group(cuda_device):
    """A 1-process NCCL group, destroyed after the test."""
    import torch.distributed as dist

    from fmvfi_tpu_torch.parallel import distributed

    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    distributed.initialize(backend="nccl")
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_halo_warp_on_one_nccl_process_matches_the_plain_halo_warp(nccl_group):
    """adacof_warp_tm_sharded on CUDA tensors (K1 forward, K2 backward, on
    the halo-padded block with zero field rows) against the same function
    on the CPU (the plain pair), one band of a (1, 1) mesh: forward within
    1e-5, field gradients within 1e-4."""
    from fmvfi_tpu_torch.parallel import spatial
    from fmvfi_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, ("data", "spatial"), (1, 1))
    bands = spatial.bands_of(mesh, "spatial", 96)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 3, 96, 64), generator=g)
    wgt = torch.softmax(4.0 * torch.rand((2, 25, 96, 64), generator=g), dim=1)
    a, b = ((torch.rand((2, 25, 96, 64), generator=g) * 2 - 1) * 60 for _ in range(2))
    cot = torch.randn((2, 3, 96, 64), generator=g)

    def run(device):
        fields = [t.to(device).requires_grad_() for t in (wgt, a, b)]
        with spatial.running(bands):
            out = spatial.adacof_warp_tm_sharded(x.to(device), *fields, 1, max_offset=24)
        out.backward(cot.to(device))
        return [t.detach().cpu() for t in [out] + [f.grad for f in fields]]

    before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
    card = run(nccl_group)
    torch.cuda.synchronize()
    assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    plain = run("cpu")
    torch.testing.assert_close(card[0], plain[0], rtol=0, atol=1e-5)
    for got, want in zip(card[1:], plain[1:]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_fusion_spatial_apply_on_a_one_process_mesh_is_fusion_interpolate(nccl_group):
    """fusion_spatial_apply on a (1, 1) NCCL mesh: bit-equal to
    fusion_interpolate on the card, with K1's 3 launches."""
    import numpy as np

    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.parallel import spatial
    from fmvfi_tpu_torch.parallel.mesh import make_mesh
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, fusion_interpolate

    torch.manual_seed(0)
    models = FusionModels(PhaseNetCore().init_params(torch.Generator().manual_seed(0)).eval(),
                          AdaCoFNet().eval(), FusionNet(variant=2).eval())
    models = FusionModels(*(m.to(nccl_group) for m in models))
    f1, _, f2 = translation_triplet(128, 160, dx=3.0, dy=1.0, seed=0)
    mesh = make_mesh(1, ("data", "spatial"), (1, 1))
    before = adacof_cuda.launches
    got = spatial.fusion_spatial_apply(models, mesh, device=nccl_group)(f1[None], f2[None])
    assert adacof_cuda.launches - before == 3
    want = fusion_interpolate(models, f1[None], f2[None], device=nccl_group)
    np.testing.assert_array_equal(got.gather().cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
def test_spatial_adacof_step_on_one_nccl_process_matches_the_cpu(nccl_group):
    """adacof_spatial_trainer on a (1, 1) NCCL mesh, one SGD step at 64x64,
    batch 2 (K1 and K2 once, fp32, TF32 off, deterministic cuDNN) against
    the single-device step on the CPU (the plain warp): metrics within 1e-5
    relative, parameters within 1e-6 (an SGD step of lr 1e-3 moves them by
    at most 1e-3)."""
    import numpy as np

    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.parallel import spatial
    from fmvfi_tpu_torch.parallel.mesh import make_mesh
    from fmvfi_tpu_torch.train.trainer import make_adacof_trainer

    items = [translation_triplet(64, 64, dx=3.0 + i, dy=1.0, seed=i) for i in range(2)]
    batch = tuple(np.stack([it[j] for it in items]) for j in range(3))
    mesh = make_mesh(1, ("data", "spatial"), (1, 1))
    card_state, card_step = spatial.adacof_spatial_trainer(mesh, optimizer="sgd",
                                                           device=nccl_group)
    cpu_state, cpu_step = make_adacof_trainer(optimizer="sgd", device="cpu")
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
        torch.testing.assert_close(card_sd[k].cpu(), v, rtol=0, atol=1e-6, msg=k)


@pytest.mark.gpu
def test_halo_exchange_backward_through_k2_matches_the_whole_frame(nccl_group):
    """Fields from a convolution on one band of a (1, 1) NCCL mesh (its zero
    edge rows through the halo exchange's autograd Function), warped by
    adacof_warp_tm_sharded (K1 forward, K2 backward on the band's block):
    the gradients of the convolution's input and weight against the same
    net on the whole frame through K1/K2, within 1e-4 of each one's
    largest entry."""
    from fmvfi_tpu_torch.models.conv import Conv2d
    from fmvfi_tpu_torch.ops.adacof import pad_replicate
    from fmvfi_tpu_torch.parallel import spatial
    from fmvfi_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, ("data", "spatial"), (1, 1))
    bands = spatial.bands_of(mesh, "spatial", 96)
    g = torch.Generator(device=nccl_group).manual_seed(0)
    torch.manual_seed(0)
    conv = Conv2d(8, 75, 3, padding=1).to(nccl_group)
    feat = torch.randn((2, 8, 96, 64), generator=g, device=nccl_group).requires_grad_()
    x = torch.rand((2, 3, 96, 64), generator=g, device=nccl_group)
    cot = torch.randn((2, 3, 96, 64), generator=g, device=nccl_group)

    def fields(y):
        return torch.softmax(y[:, :25], 1), 6 * y[:, 25:50], 6 * y[:, 50:]

    with spatial.running(bands):
        before = adacof_cuda.bwd_launches
        out = spatial.adacof_warp_tm_sharded(x, *fields(conv(feat)), 1, max_offset=24)
        band = torch.autograd.grad(out, [feat, conv.weight], cot)
        assert adacof_cuda.bwd_launches == before + 1
    whole = torch.autograd.grad(
        adacof_cuda.adacof_warp(pad_replicate(x, 2), *fields(conv(feat)), 1, 24),
        [feat, conv.weight], cot)
    for got, want in zip(band, whole):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
