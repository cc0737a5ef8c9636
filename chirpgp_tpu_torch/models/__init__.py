"""SDE priors and their discretizations."""

from chirpgp_tpu_torch.models.bijections import g, g_inv
from chirpgp_tpu_torch.models.transitions import Transition, as_transition
from chirpgp_tpu_torch.models.matern import (
    stationary_cov_m32, m32_solution, m32_transition_mean, disc_m32)
from chirpgp_tpu_torch.models.chirp import (
    StateSpaceModel, model_chirp, model_harmonic_chirp, model_lascala,
    disc_chirp_lcd, disc_chirp_lcd_cond_v, disc_harmonic_chirp_lcd,
    disc_model_lascala_lcd, disc_chirp_euler_maruyama,
    ChirpModelPack, build_chirp_model, build_harmonic_chirp_model,
    build_lascala_model)
from chirpgp_tpu_torch.models.kpt import KPTModel, build_kpt_chirp_model
from chirpgp_tpu_torch.models.tme import (
    generator, tme_mean_and_cov, disc_tme, disc_chirp_tme)
from chirpgp_tpu_torch.models.crlb import posterior_cramer_rao

__all__ = [
    "g", "g_inv", "Transition", "as_transition",
    "stationary_cov_m32", "m32_solution", "m32_transition_mean", "disc_m32",
    "StateSpaceModel", "model_chirp", "model_harmonic_chirp",
    "model_lascala", "disc_chirp_lcd", "disc_chirp_lcd_cond_v",
    "disc_harmonic_chirp_lcd", "disc_model_lascala_lcd",
    "disc_chirp_euler_maruyama", "ChirpModelPack", "build_chirp_model",
    "build_harmonic_chirp_model", "build_lascala_model",
    "KPTModel", "build_kpt_chirp_model",
    "generator", "tme_mean_and_cov", "disc_tme", "disc_chirp_tme",
    "posterior_cramer_rao",
]
