from .denoise import (
    DenoiseTrainer, denoise_loss, flagship_batch, molecular_batch,
    property_loss,
)
from .recipes import (
    af2_refinement, flagship, flagship_fast, molecular_edges, toy_denoise,
)
