"""SD-v1.5 noise schedule in float64 numpy (counterpart of
``diffusion/schedules.py``; that module's package imports jax, so the
builders are restated here).

scaled_linear betas 0.00085..0.012 over 1000 train steps, epsilon
prediction (diffusers' DDPM/UniPC settings for SD-v1.5).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: np.ndarray  # (T,) float64

    @classmethod
    def create(cls, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085,
               beta_end: float = 0.012) -> "NoiseSchedule":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
        return cls(betas=betas)

    @property
    def num_train_timesteps(self) -> int:
        return len(self.betas)

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas)

    @property
    def alpha_t(self) -> np.ndarray:
        """sqrt(alphas_cumprod): signal scale."""
        return np.sqrt(self.alphas_cumprod)

    @property
    def sigma_t(self) -> np.ndarray:
        """sqrt(1 - alphas_cumprod): noise scale."""
        return np.sqrt(1.0 - self.alphas_cumprod)

    @property
    def lambda_t(self) -> np.ndarray:
        """log-SNR / 2, the UniPC time variable."""
        return np.log(self.alpha_t) - np.log(self.sigma_t)

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending int timestep grid (diffusers UniPC spacing)."""
        t = np.linspace(0, self.num_train_timesteps - 1,
                        num_inference_steps + 1).round()[::-1][:-1]
        t = t.astype(np.int64)
        _, idx = np.unique(t, return_index=True)
        return t[np.sort(idx)]
