"""SDE priors and their discretizations."""

from chirpgp_tpu_torch.models.bijections import g, g_inv
from chirpgp_tpu_torch.models.transitions import Transition, as_transition
from chirpgp_tpu_torch.models.matern import (
    stationary_cov_m32, m32_solution, m32_transition_mean)
from chirpgp_tpu_torch.models.chirp import (
    StateSpaceModel, model_chirp, disc_chirp_lcd, ChirpModelPack,
    build_chirp_model)

__all__ = [
    "g", "g_inv", "Transition", "as_transition",
    "stationary_cov_m32", "m32_solution", "m32_transition_mean",
    "StateSpaceModel", "model_chirp", "disc_chirp_lcd", "ChirpModelPack",
    "build_chirp_model",
]
