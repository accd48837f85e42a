"""Monte-Carlo device-mismatch model (paper Fig 6; port of
``repro/core/montecarlo.py``).

The paper's MC run (200 samples, MAC count 8) reports mean 437 fJ and sigma
48.72 fJ: random device mismatch during sensing.  Per-discharge-path charge
mismatch: the energy of a count-k evaluation is

    E = E(0) + sum_{i=1..k} g_i * dE_i,     dE_i = E(i) - E(i-1) (Table III),
    g_i ~ N(MU_G, SIGMA_G)  iid per path,

with (MU_G, SIGMA_G) calibrated in closed form to the paper's (mean, sigma)
(see :mod:`repro_torch.core.constants`).  The same mismatch perturbs the
effective count seen by the decoder, which is how decode errors enter the
analog-sim matmul path.

Where the reference takes a ``jax.random`` key, the port takes a
``torch.Generator``; the two give different numbers from one seed, so a
parity test hands both the same normals (``mc_count_noise`` takes ``z``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import constants as C


def randn(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """float32 N(0, 1) draws from ``generator``, on ``device`` (default: the
    generator's)."""
    z = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return z if device is None else z.to(device)


def sample_path_gains(generator: torch.Generator, shape, *,
                      sigma_g: float | None = None,
                      mu_g: float | None = None) -> torch.Tensor:
    """Per-discharge-path gain factors g ~ N(mu, sigma), clipped at 0."""
    sigma = C.MC_SIGMA_G if sigma_g is None else sigma_g
    mu = C.MC_MU_G if mu_g is None else mu_g
    return torch.clamp_min(mu + sigma * randn(generator, shape), 0.0)


def mc_energy_fj(generator: torch.Generator, k: int,
                 n_samples: int = C.MC_SAMPLES, **kw) -> torch.Tensor:
    """MC energy samples (fJ) for an evaluation with true count ``k``."""
    table = torch.as_tensor(C.E_MAC_TABLE_FJ, dtype=torch.float32)
    de = (table[1:] - table[:-1]).to(generator.device)
    g = sample_path_gains(generator, (n_samples, k), **kw)
    return float(C.E_MAC_TABLE_FJ[0]) + g @ de[:k]


def mc_count_noise(generator: Optional[torch.Generator], shape, k, *,
                   sigma_vk: float | None = None,
                   z: torch.Tensor | None = None) -> torch.Tensor:
    """Voltage-referred mismatch as additive noise on the effective count:
    ``(sigma * sqrt(max(k, 0))) * z`` with ``z`` drawn from ``generator`` in
    ``shape`` (or passed in).  ``k`` is the true count (broadcast against
    ``shape``); ``sigma_vk`` defaults to ``MC_SIGMA_VK``, the small,
    margin-preserving voltage projection of mismatch, not the
    energy-referred ``MC_SIGMA_G``."""
    k = torch.as_tensor(k, dtype=torch.float32)
    sigma = C.MC_SIGMA_VK if sigma_vk is None else sigma_vk
    if z is None:
        if generator is None:
            raise ValueError("mismatch noise requires a generator or z")
        z = randn(generator, shape, k.device)
    return sigma * torch.sqrt(torch.clamp_min(k, 0.0)) * z


def mc_stats(generator: torch.Generator, k: int = C.ROWS,
             n_samples: int = C.MC_SAMPLES, **kw
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) of the MC energy distribution — Fig 6 reproduction."""
    e = mc_energy_fj(generator, k, n_samples, **kw)
    return torch.mean(e), torch.std(e, correction=0)
