"""The samplers as precomputed per-step coefficient tables and a branchless
step on torch tensors (counterpart of ``diffusion/samplers.py``): UniPC-2
(B(h)=bh2), the shipped default, and eta=0 DDIM.

Every scalar of the multistep update is a function of the static timestep
grid only, so the predictor/corrector algebra (order warm-up,
lower-order-final, bh2 B(h), the 2x2 rho solve) folds into (K,) float64
arrays built once in numpy; the step is a handful of multiply-adds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .schedules import NoiseSchedule


@dataclasses.dataclass(frozen=True)
class DDIMCoeffs:
    """x_{i+1} = a[i] * x + b[i] * eps (eta=0 DDIM)."""

    timesteps: np.ndarray  # (K,) int
    a: np.ndarray
    b: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def init_state(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def step(self, i: int, x: torch.Tensor, eps: torch.Tensor,
             state: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return float(self.a[i]) * x + float(self.b[i]) * eps.to(x.dtype), \
            state


@dataclasses.dataclass(frozen=True)
class UniPCCoeffs:
    """Per step i with epsilon model output ``eps`` on sample ``x``:
      m     = cv_a[i]*x - cv_b[i]*eps                       (x0 prediction)
      x_c   = c_a[i]*x_last - c_b[i]*m1
              - c_d[i]*(m2 - m1) - c_e[i]*(m - m1)          (UniC corrector)
      x     = use_c[i]*x_c + (1-use_c[i])*x
      x'    = p_a[i]*x - p_b[i]*m - p_c[i]*(m1 - m)         (UniP predictor)
      state = (x_last=x, m1=m, m2=m1)
    """

    timesteps: np.ndarray
    cv_a: np.ndarray
    cv_b: np.ndarray
    use_c: np.ndarray
    c_a: np.ndarray
    c_b: np.ndarray
    c_d: np.ndarray
    c_e: np.ndarray
    p_a: np.ndarray
    p_b: np.ndarray
    p_c: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def init_state(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        z = torch.zeros_like(x)
        return {"x_last": z, "m1": z, "m2": z}

    def step(self, i: int, x: torch.Tensor, eps: torch.Tensor,
             state: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        # python scalars: torch applies them in x's dtype, as the JAX step
        # casts its coefficients to x's dtype
        g = {k: float(getattr(self, k)[i])
             for k in ("cv_a", "cv_b", "use_c", "c_a", "c_b", "c_d", "c_e",
                       "p_a", "p_b", "p_c")}
        m = g["cv_a"] * x - g["cv_b"] * eps.to(x.dtype)
        m1, m2 = state["m1"], state["m2"]
        x_c = (g["c_a"] * state["x_last"] - g["c_b"] * m1
               - g["c_d"] * (m2 - m1) - g["c_e"] * (m - m1))
        x = g["use_c"] * x_c + (1.0 - g["use_c"]) * x
        x_next = g["p_a"] * x - g["p_b"] * m - g["p_c"] * (m1 - m)
        return x_next, {"x_last": x, "m1": m, "m2": m1}


def _bh2_b_coeffs(hh: float) -> Tuple[float, float, float, float]:
    """phi coefficients for bh2: returns (phi1, B_h, b1, b2)."""
    phi1 = np.expm1(hh)
    B_h = np.expm1(hh)
    h_phi_k = phi1 / hh - 1.0
    b1 = h_phi_k * 1.0 / B_h
    h_phi_k = h_phi_k / hh - 1.0 / 2.0
    b2 = h_phi_k * 2.0 / B_h
    return phi1, B_h, b1, b2


def make_unipc_coeffs(schedule: NoiseSchedule, num_inference_steps: int,
                      solver_order: int = 2) -> UniPCCoeffs:
    """UniPC with predict_x0, bh2 and lower_order_final, as diffusers'
    UniPCMultistepScheduler runs it for SD-v1.5."""
    if solver_order not in (1, 2):
        raise ValueError(f"solver_order {solver_order}: 1 or 2 supported")
    ts = schedule.inference_timesteps(num_inference_steps)
    K = len(ts)
    lam, alpha, sigma = schedule.lambda_t, schedule.alpha_t, schedule.sigma_t
    out = {k: np.zeros(K) for k in
           ("cv_a", "cv_b", "use_c", "c_a", "c_b", "c_d", "c_e",
            "p_a", "p_b", "p_c")}

    for i in range(K):
        t = int(ts[i])
        prev_t = int(ts[i + 1]) if i < K - 1 else 0
        out["cv_a"][i] = 1.0 / alpha[t]
        out["cv_b"][i] = sigma[t] / alpha[t]

        # predictor (UniP) at step i: t -> prev_t
        order_p = min(solver_order, K - i, i + 1)
        h = lam[prev_t] - lam[t]
        phi1, B_h, _, _ = _bh2_b_coeffs(-h)
        out["p_a"][i] = sigma[prev_t] / sigma[t]
        out["p_b"][i] = alpha[prev_t] * phi1
        if order_p >= 2:
            rk0 = (lam[int(ts[i - 1])] - lam[t]) / h
            out["p_c"][i] = alpha[prev_t] * B_h * 0.5 / rk0

        # corrector (UniC) at step i: corrects x at t using history
        if i > 0:
            s0 = int(ts[i - 1])
            order_c = min(solver_order, K - (i - 1), i)
            hc = lam[t] - lam[s0]
            phi1c, B_hc, b1, b2 = _bh2_b_coeffs(-hc)
            out["use_c"][i] = 1.0
            out["c_a"][i] = sigma[t] / sigma[s0]
            out["c_b"][i] = alpha[t] * phi1c
            if order_c == 1:
                out["c_e"][i] = alpha[t] * B_hc * 0.5
            else:
                rk0 = (lam[int(ts[i - 2])] - lam[s0]) / hc
                rhos = np.linalg.solve(np.array([[1.0, 1.0], [rk0, 1.0]]),
                                       np.array([b1, b2]))
                out["c_d"][i] = alpha[t] * B_hc * rhos[0] / rk0
                out["c_e"][i] = alpha[t] * B_hc * rhos[1]

    return UniPCCoeffs(timesteps=ts, **out)


def make_ddim_coeffs(schedule: NoiseSchedule, num_inference_steps: int,
                     timesteps: Optional[np.ndarray] = None) -> DDIMCoeffs:
    """``timesteps`` (descending ints) overrides the grid, e.g. diffusers'
    "leading" spacing instead of the default linspace spacing."""
    ts = np.asarray(timesteps) if timesteps is not None else \
        schedule.inference_timesteps(num_inference_steps)
    alpha, sigma = schedule.alpha_t, schedule.sigma_t
    a, b = np.zeros(len(ts)), np.zeros(len(ts))
    for i in range(len(ts)):
        t = int(ts[i])
        # the last step goes to the clean sample: alpha 1, sigma 0
        a_prev, s_prev = (alpha[int(ts[i + 1])], sigma[int(ts[i + 1])]) \
            if i < len(ts) - 1 else (1.0, 0.0)
        a[i] = a_prev / alpha[t]
        b[i] = s_prev - a_prev * sigma[t] / alpha[t]
    return DDIMCoeffs(timesteps=ts, a=a, b=b)


def make_sampler_coeffs(schedule: NoiseSchedule, num_inference_steps: int,
                        sampler: str = "unipc"
                        ) -> Union[UniPCCoeffs, DDIMCoeffs]:
    """The coefficient table of ``sampler``: "unipc" or "ddim"."""
    if sampler == "unipc":
        return make_unipc_coeffs(schedule, num_inference_steps)
    if sampler == "ddim":
        return make_ddim_coeffs(schedule, num_inference_steps)
    raise ValueError(f"sampler {sampler!r}: unipc or ddim")
