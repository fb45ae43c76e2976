from .denoise import DenoiseTrainer, denoise_loss, flagship_batch
from .recipes import flagship_fast
