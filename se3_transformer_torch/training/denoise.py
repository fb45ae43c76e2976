"""The flagship denoise training step: the port of
se3_transformer_tpu/training/denoise.py's masked-MSE objective and of the
step bench.py times (parallel/sharding.py::make_sharded_train_step with
optax.adam, and its grad-accumulation variant make_accumulating_train_step).

The model sees the coordinates plus Gaussian noise and predicts, per node,
the vector that maps the noised coordinates back to the clean ones
(return_type=1 of a model with output_degrees=2 and reduce_dim_out=True).
Meshes, FSDP, telemetry, input pipelines and checkpoints are not ported
yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..utils.helpers import resolve_device

Batch = Dict[str, torch.Tensor]


def flagship_batch(rng: np.random.RandomState, b: int, n: int,
                   dim: int) -> Dict[str, np.ndarray]:
    """bench.py's flagship batch, draw for draw: continuous degree-0
    features normal [b, n, dim], chain coordinates (a cumulative sum of
    normal steps, centred) [b, n, 3], an all-true mask [b, n]."""
    feats = rng.normal(size=(b, n, dim)).astype(np.float32)
    coords = np.cumsum(rng.normal(size=(b, n, 3)), axis=1).astype(np.float32)
    coords = coords - coords.mean(axis=1, keepdims=True)
    return dict(feats=feats, coords=coords, masks=np.ones((b, n), bool))


def denoise_loss(model: torch.nn.Module, batch: Batch,
                 noise: Union[torch.Tensor, torch.Generator]) -> torch.Tensor:
    """The masked MSE of denoise_loss_fn: sum over xyz of the squared error
    of (noised + model(feats, noised)) against the clean coordinates,
    averaged over the real nodes. `noise` is the coordinate noise itself,
    or a torch.Generator on the batch's device to draw it from."""
    coords, masks = batch['coords'], batch['masks']
    if isinstance(noise, torch.Generator):
        noise = torch.randn(coords.shape, generator=noise,
                            dtype=coords.dtype, device=coords.device)
    noised = coords + noise
    out = model(batch['feats'], noised, mask=masks, return_type=1)
    sq = (((noised + out) - coords) ** 2).sum(-1)
    total = torch.where(masks, sq, torch.zeros_like(sq)).sum()
    return total / masks.sum().clamp(min=1).to(sq.dtype)


class DenoiseTrainer:
    """Adam on the denoise loss, with optional gradient accumulation.

        trainer = DenoiseTrainer(flagship_fast(output_degrees=2,
                                               reduce_dim_out=True))
        loss = trainer.train_step(flagship_batch(rng, 1, 1024, 64))

    Adam is torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8), the update
    of optax.adam's defaults. With accum_steps > 1 every batch leaf carries
    a leading [accum_steps] axis, and the step averages the micro-batches'
    gradients before one update."""

    def __init__(self, model: torch.nn.Module, *, lr: float = 1e-4,
                 accum_steps: int = 1, device='cuda',
                 generator: Optional[torch.Generator] = None):
        if accum_steps < 1:
            raise ValueError(f'accum_steps must be >= 1, got {accum_steps}')
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.accum_steps = int(accum_steps)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator

    def to_device(self, batch) -> Batch:
        """numpy or torch leaves -> tensors on the trainer's device."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def train_step(self, batch, noise: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """One optimizer step. `noise` (shaped like batch['coords']) is
        drawn from the trainer's generator when None. Returns the loss (the
        mean over micro-batches) as a device tensor, without a host
        sync."""
        batch = self.to_device(batch)
        if noise is not None:
            noise = torch.as_tensor(noise, device=self.device)
        self.optimizer.zero_grad(set_to_none=True)
        single = self.accum_steps == 1
        losses = []
        for j in range(self.accum_steps):
            micro = batch if single else {k: v[j] for k, v in batch.items()}
            eps = self.generator if noise is None else \
                (noise if single else noise[j])
            loss = denoise_loss(self.model, micro, eps)
            (loss / self.accum_steps).backward()
            losses.append(loss.detach())
        loss = torch.stack(losses).mean()
        self.optimizer.step()
        return loss
