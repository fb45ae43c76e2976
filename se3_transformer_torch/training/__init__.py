from .denoise import DenoiseTrainer, denoise_loss, flagship_batch
from .recipes import af2_refinement, flagship, flagship_fast
