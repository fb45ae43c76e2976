from .spherical_harmonics import (
    real_spherical_harmonics,
    real_spherical_harmonics_all,
)
from .wigner import (
    rot, rot_z, rot_y, rot_to_euler, compose, irr_repr,
    wigner_d_from_rotation, x_to_alpha_beta,
)
