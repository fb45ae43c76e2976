from .se3_transformer import SE3TransformerModule, init_parameters
