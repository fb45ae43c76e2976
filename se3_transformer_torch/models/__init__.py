from .se3_transformer import (
    SE3Transformer, SE3TransformerModule, init_parameters,
)
