"""The noise of the noise-quantised training forward, as an explicit source.

JAX draws U(-0.5, 0.5) from `jax.random` keys that the forward splits up
front and uses in a fixed order.  The port passes one source down the
forward instead, and each noisy quantiser asks it for its next draw, in
JAX's order and with JAX's shapes and layouts: the bottleneck's
(C, 1, B*H*W), then the Gaussian slices channel-last.  Any object with a
`uniform(shape, device)` method serves (the tests replay JAX's own draws
through one); no module-level random state is used.
"""

from __future__ import annotations

import torch


class NoiseSource:
    """U(-0.5, 0.5) float32 draws from an explicit `torch.Generator`.  The
    draws are made on the generator's device and moved to the device asked
    for, so a CPU generator gives the same noise to a model on any device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device="cpu") -> "NoiseSource":
        return cls(torch.Generator(device=device).manual_seed(seed))

    def uniform(self, shape, device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.generator.device,
                       dtype=torch.float32) - 0.5
        return u.to(device)
