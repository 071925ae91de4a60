"""The adversarial loss family with its own critic optimizer (port of
fmvfi_tpu/train/adversarial.py).

Each `Adversarial.step` makes one critic update on the detached generator
output and returns the generator loss against the updated critic, as the
JAX package's pure step does; the state (`AdvState`) holds the critic, its
Adam and the generator of its random draws, and PyTorch updates them in
place.  gan_type is one of GAN, WGAN, WGAN_GP, FI_GAN and T_WGAN_GP: the
WGAN weight clamp, and the WGAN-GP gradient penalty (lambda 10) by a
double backward through the critic.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.discriminator import Patch, make_critic
from ..parallel import dp
from ..pipeline.interpolate import _device

GP_WEIGHT = 10.0  # lambda of the gradient penalty
WGAN_CLIP = 1.0  # WGAN clamps every critic parameter to [-WGAN_CLIP, WGAN_CLIP]


class AdvState(NamedTuple):
    """The critic (its BN running statistics are buffers), its optimizer,
    and the generator of the gradient penalty's draws."""

    critic: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

    def state_dict(self) -> dict:
        return {"critic": self.critic.state_dict(), "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.critic.load_state_dict(sd["critic"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"].cpu())


def draw_eps(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """The gradient penalty's mixing weights: U(0, 1) of `like`'s shape.  In
    a data-parallel step every process draws the global batch's from the
    same generator state and takes its own rows."""
    n, lo = dp.global_batch(like.shape[0])
    eps = torch.rand((n,) + tuple(like.shape[1:]), generator=generator, device=like.device,
                     dtype=like.dtype)
    return eps[lo : lo + like.shape[0]]


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


@contextmanager
def _frozen(module: nn.Module):
    """The module's parameters without gradient inside the block."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class Adversarial:
    """adv = Adversarial('WGAN_GP', patch_size=96); state = adv.init_state();
    then per step: g_loss, state, aux = adv.step(state, fake, real, frames).

    The critic is built for crops of `patch_size` (an int or (h, w)): its
    fc1 flattens the trunk's features.  Adam(lr 1e-5, betas (0, 0.9)) for
    the GP family, Adam(lr 1e-4) otherwise; `lr` overrides either.  The
    critic is initialised as flax does (lecun_normal kernels, zero biases)
    from `seed`, and its draws come from a generator on `device` seeded
    with `seed`."""

    def __init__(self, gan_type: str, patch_size: Patch = 96, lr: Optional[float] = None,
                 seed: int = 0, device="cuda"):
        self.gan_type = gan_type
        self.device = _device(device)
        self.patch_size = patch_size
        self.gp = gan_type in ("WGAN_GP", "T_WGAN_GP")
        self.lr = lr or (1e-5 if self.gp else 1e-4)
        self.seed = seed

    def init_state(self) -> AdvState:
        critic = make_critic(self.gan_type, self.patch_size, torch.Generator().manual_seed(self.seed))
        critic = critic.to(self.device).train()
        if self.gp:
            opt = torch.optim.Adam(critic.parameters(), lr=self.lr, betas=(0.0, 0.9), eps=1e-8)
        else:
            opt = torch.optim.Adam(critic.parameters(), lr=self.lr)
        return AdvState(critic, opt, torch.Generator(self.device).manual_seed(self.seed))

    def step(self, state: AdvState, fake: torch.Tensor, real: torch.Tensor,
             input_frames: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """One critic update on the detached `fake`, then the generator loss
        against the updated critic, whose parameters are held without
        gradient (the loss's gradient flows to `fake` only).  NCHW batches.
        The critic runs in train mode: BN normalizes by the batch moments,
        and its running statistics are refreshed once, after the update,
        on one reference batch ((real,), or (frame0, fake) for FI_GAN).
        Returns (g_loss, state, {"d_loss": ...})."""
        gan, critic = self.gan_type, state.critic

        def d(*frames):
            return critic(*frames, train=True)

        fake_d = fake.detach()
        if gan == "FI_GAN":
            d_loss = _bce(d(input_frames[0], fake_d), 0.0) + _bce(d(fake_d, input_frames[1]), 1.0)
        else:
            if gan == "T_WGAN_GP":
                def d_of(x):
                    return d(input_frames[0], x, input_frames[1])
            else:
                d_of = d
            d_fake, d_real = d_of(fake_d), d_of(real)
            if gan == "GAN":
                d_loss = _bce(d_fake, 0.0) + _bce(d_real, 1.0)
            else:
                d_loss = torch.mean(d_fake - d_real)
            if self.gp:
                eps = draw_eps(state.generator, fake_d)
                hat = (fake_d * (1 - eps) + real * eps).requires_grad_(True)
                g, = torch.autograd.grad(d_of(hat).sum(), hat, create_graph=True)
                gnorm = torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1) + 1e-12)
                d_loss = d_loss + GP_WEIGHT * torch.mean((gnorm - 1.0) ** 2)

        params = list(critic.parameters())
        # averaged over the processes in a data-parallel step
        for p, g in zip(params, dp.global_mean_(list(torch.autograd.grad(d_loss, params)))):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if gan == "WGAN":
            with torch.no_grad():
                for p in params:
                    p.clamp_(-WGAN_CLIP, WGAN_CLIP)

        with _frozen(critic):
            if gan == "GAN":
                g_loss = _bce(d(fake), 1.0)
            elif gan == "FI_GAN":
                d01 = torch.sigmoid(d(input_frames[0], fake))
                d12 = torch.sigmoid(d(fake, input_frames[1]))
                g_loss = torch.mean(d01 * torch.log(d01 + 1e-12) + d12 * torch.log(d12 + 1e-12))
            elif gan == "T_WGAN_GP":
                g_loss = -torch.mean(d(input_frames[0], fake, input_frames[1]))
            else:
                g_loss = -torch.mean(d(fake))

        if gan in ("GAN", "WGAN", "FI_GAN"):  # the critics with BN
            ref = (input_frames[0], fake_d) if gan == "FI_GAN" else (real,)
            with torch.no_grad():
                critic(*ref, train=True, move_stats=True)
        return g_loss, state, {"d_loss": d_loss.detach()}
