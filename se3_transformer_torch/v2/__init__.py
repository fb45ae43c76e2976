"""SE3TransformerV2: the eSCN-direct model family (per-m radial blocks and
separable S2 activations), the port of se3_transformer_tpu/v2. See
v2/model.py for the family contract."""
from .conv import DEFAULT_V2_MID_DIM, V2ConvSE3, v2_band_rows
from .model import SE3TransformerV2, SE3TransformerV2Module
from .s2act import SeparableS2Activation, s2_grid_matrices

__all__ = [
    'DEFAULT_V2_MID_DIM', 'V2ConvSE3', 'v2_band_rows',
    'SE3TransformerV2', 'SE3TransformerV2Module',
    'SeparableS2Activation', 's2_grid_matrices',
]
