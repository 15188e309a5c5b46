"""DDIM scheduler (deterministic, eta = 0) for Marigold's denoising.

Restated from ``depthmap_tpu/models/marigold/ddim.py`` (numpy; held equal by
tests/test_torch_port_marigold.py): the SD2 schedule, scaled_linear betas
0.00085 -> 0.012 over 1000 steps; v-prediction (Marigold is SD2.1-v based)
with an epsilon option; ``steps_offset`` 1 (every timestep the UNet sees is
shifted by one) and ``set_alpha_to_one=False`` (the last step's alpha_prev
is ``alphas_cumprod[0]``).
"""
from __future__ import annotations

import numpy as np


class DDIMScheduler:
    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 prediction_type: str = "v_prediction",
                 steps_offset: int = 1):
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.steps_offset = steps_offset
        self.final_alpha_cumprod = self.alphas_cumprod[0]

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        step = self.num_train_timesteps // num_inference_steps
        return ((np.arange(0, num_inference_steps) * step)[::-1]
                .round().astype(np.int64) + self.steps_offset)

    def coefficients(self, num_inference_steps: int):
        """(timesteps int32, (steps, 4) f32 rows [sqrt(a_t), sqrt(1 - a_t),
        sqrt(a_prev), sqrt(1 - a_prev)]): each step's update, computed on
        the host as the JAX pipeline precomputes it."""
        timesteps = self.set_timesteps(num_inference_steps)
        step = self.num_train_timesteps // num_inference_steps
        rows = []
        for t in timesteps:
            prev_t = int(t) - step
            a_t = self.alphas_cumprod[int(t)]
            a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 \
                else self.final_alpha_cumprod
            rows.append([float(np.sqrt(a_t)), float(np.sqrt(1 - a_t)),
                         float(np.sqrt(a_prev)), float(np.sqrt(1 - a_prev))])
        return (np.asarray(timesteps, np.int32),
                np.asarray(rows, np.float32))
