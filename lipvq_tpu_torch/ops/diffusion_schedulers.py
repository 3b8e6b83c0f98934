"""DDPM / DDIM noise schedulers (counterpart of
``lipvq_tpu/ops/diffusion_schedulers.py``).

diffusers semantics as the JAX package implements them: ``squaredcos_cap_v2``
/ ``linear`` beta schedules built in float64 and stored in float32, epsilon
or sample prediction, clip_sample, DDIM with set_alpha_to_one and eta = 0.

The timestep tables are static, so the reverse processes are plain Python
loops over them; each step's scalar coefficients are computed once in
float32 on the host (the arithmetic the JAX step does on its fp32 tables),
so the loop never waits on the device. Noise comes from an explicit
``torch.Generator``; ``noise=`` hands a sampler its draws instead (the tests
replay the JAX package's).

As in the JAX package, ``ddpm_step`` takes ``alphas_cumprod[t - 1]`` as the
previous cumulative product whatever the inference spacing is (ROADMAP
queue 3, reference fault (c)): with fewer inference than train steps this
differs from diffusers; the template's 100 / 100 is not affected.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch


def make_beta_schedule(num_train_timesteps: int,
                       beta_schedule: str = "squaredcos_cap_v2",
                       beta_start: float = 1e-4,
                       beta_end: float = 2e-2) -> np.ndarray:
    """float64 betas (diffusers ``betas_for_alpha_bar`` with the cos^2
    schedule and max beta 0.999, or a linear ramp)."""
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        betas = []
        for i in range(num_train_timesteps):
            t1 = i / num_train_timesteps
            t2 = (i + 1) / num_train_timesteps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.asarray(betas, np.float64)
    raise ValueError(beta_schedule)


class SchedulerParams(NamedTuple):
    """float32 tables on the host (numpy: the samplers' scalar
    coefficients), the cumulative products on the device as well
    (``add_noise`` gathers from them), and the scheduler's settings."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_device: torch.Tensor
    num_train_timesteps: int
    clip_sample: bool
    prediction_type: str


def make_scheduler(num_train_timesteps: int = 100,
                   beta_schedule: str = "squaredcos_cap_v2",
                   clip_sample: bool = True,
                   prediction_type: str = "epsilon", device="cpu") -> SchedulerParams:
    if prediction_type not in ("epsilon", "sample"):
        raise ValueError(prediction_type)
    betas = make_beta_schedule(num_train_timesteps, beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    return SchedulerParams(
        betas=betas.astype(np.float32),
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_device=torch.from_numpy(alphas_cumprod).to(device),
        num_train_timesteps=num_train_timesteps,
        clip_sample=clip_sample,
        prediction_type=prediction_type,
    )


_F32_ONE = np.float32(1.0)


def add_noise(sched: SchedulerParams, sample: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps (diffusers add_noise);
    ``timesteps`` [B] int on the scheduler's device, as the sample."""
    abar = sched.alphas_cumprod_device[timesteps.long()]
    abar = abar.reshape(abar.shape + (1,) * (sample.ndim - abar.ndim))
    return torch.sqrt(abar) * sample + torch.sqrt(1.0 - abar) * noise


def _f32(x) -> float:
    """A float32 value as the Python float that holds it exactly."""
    return float(np.float32(x))


def _predict_x0(sched: SchedulerParams, model_output, sample, abar_t: np.float32):
    if sched.prediction_type == "epsilon":
        x0 = (sample - _f32(np.sqrt(_F32_ONE - abar_t)) * model_output) / _f32(np.sqrt(abar_t))
    else:
        x0 = model_output
    if sched.clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    return x0


def ddpm_step(sched: SchedulerParams, model_output: torch.Tensor, timestep: int,
              sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One reverse-DDPM step t -> t - 1 (diffusers DDPMScheduler.step) with
    the given standard-normal ``noise`` (unused at t = 0)."""
    t = int(timestep)
    abar_t = sched.alphas_cumprod[t]
    abar_prev = sched.alphas_cumprod[t - 1] if t > 0 else _F32_ONE
    beta_t = sched.betas[t]
    alpha_t = _F32_ONE - beta_t
    x0 = _predict_x0(sched, model_output, sample, abar_t)
    # posterior mean coefficients (DDPM eq. 7), float32 as the JAX step
    coef_x0 = np.sqrt(abar_prev) * beta_t / (_F32_ONE - abar_t)
    coef_xt = np.sqrt(alpha_t) * (_F32_ONE - abar_prev) / (_F32_ONE - abar_t)
    mean = _f32(coef_x0) * x0 + _f32(coef_xt) * sample
    if t == 0:
        return mean
    var = max(beta_t * (_F32_ONE - abar_prev) / (_F32_ONE - abar_t), np.float32(1e-20))
    return mean + _f32(np.sqrt(np.float32(var))) * noise


def ddim_step(sched: SchedulerParams, model_output: torch.Tensor, timestep: int,
              prev_timestep: int, sample: torch.Tensor) -> torch.Tensor:
    """One DDIM step (eta = 0, deterministic; diffusers DDIMScheduler.step
    with set_alpha_to_one)."""
    abar_t = sched.alphas_cumprod[int(timestep)]
    abar_prev = sched.alphas_cumprod[int(prev_timestep)] if prev_timestep >= 0 else _F32_ONE
    x0 = _predict_x0(sched, model_output, sample, abar_t)
    eps = (sample - _f32(np.sqrt(abar_t)) * x0) / _f32(np.sqrt(_F32_ONE - abar_t))
    return _f32(np.sqrt(abar_prev)) * x0 + _f32(np.sqrt(_F32_ONE - abar_prev)) * eps


def ddpm_timesteps(num_train_timesteps: int, steps: int) -> list[int]:
    """diffusers set_timesteps: evenly spaced, descending."""
    return np.linspace(0, num_train_timesteps - 1, steps).round().astype(np.int64)[::-1].tolist()


def ddim_timesteps(num_train_timesteps: int, steps: int) -> tuple[list[int], int]:
    """(descending timesteps, step ratio)."""
    ratio = num_train_timesteps // steps
    return (np.arange(0, steps) * ratio).round().astype(np.int64)[::-1].tolist(), ratio


ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _draw(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def ddpm_sample(sched: SchedulerParams, model_fn: ModelFn, shape: tuple,
                generator: torch.Generator | None = None,
                num_inference_timesteps: int | None = None, device=None,
                noise: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """The full reverse process. ``model_fn(x, t [B] int64) -> eps``. The
    initial sample and each step's noise are drawn from ``generator`` on
    ``device``, or taken from ``noise = (initial [*shape], per step
    [steps, *shape])``."""
    steps = num_inference_timesteps or sched.num_train_timesteps
    if noise is None:
        x = _draw(shape, generator, device)
    else:
        x, step_noise = noise
    for i, t in enumerate(ddpm_timesteps(sched.num_train_timesteps, steps)):
        eps = model_fn(x, torch.full((shape[0],), t, dtype=torch.int64, device=x.device))
        z = _draw(shape, generator, x.device) if noise is None else step_noise[i]
        x = ddpm_step(sched, eps, t, x, z)
    return x


def ddim_sample(sched: SchedulerParams, model_fn: ModelFn, shape: tuple,
                generator: torch.Generator | None = None,
                num_inference_timesteps: int = 10, device=None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """DDIM's reverse process from an initial sample drawn from
    ``generator`` (or given as ``noise``)."""
    x = _draw(shape, generator, device) if noise is None else noise
    ts, ratio = ddim_timesteps(sched.num_train_timesteps, num_inference_timesteps)
    for t in ts:
        eps = model_fn(x, torch.full((shape[0],), t, dtype=torch.int64, device=x.device))
        x = ddim_step(sched, eps, t, t - ratio, x)
    return x
