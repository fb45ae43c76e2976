from .denoise import (
    DenoiseTrainer, denoise_loss, flagship_batch, molecular_batch,
    property_loss,
)
from .recipes import (
    RECIPES, af2_refinement, egnn_stress, flagship, flagship_fast,
    molecular_edges, toy_denoise,
)
