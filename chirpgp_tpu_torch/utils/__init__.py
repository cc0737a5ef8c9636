"""Shared numerical utilities, metrics, simulators, the LTI
discretization and timing."""

from chirpgp_tpu_torch.utils.metrics import (
    rmse, fwd_transformed_pdf, chol_partial_const_diag)
from chirpgp_tpu_torch.utils.numerics import (
    as_real_tensor, phi1, ou_variance, psd_cholesky, cholesky_or_nan,
    psd_solve)
from chirpgp_tpu_torch.utils.lti import lti_sde_to_disc
from chirpgp_tpu_torch.utils.sim import (
    simulate_lgssm, simulate_sde, simulate_sde_init,
    simulate_function_parametrised_sde)
from chirpgp_tpu_torch.utils.timing import (
    TimingResult, time_jitted, wall_timer, profile_trace)

__all__ = ["rmse", "fwd_transformed_pdf", "chol_partial_const_diag",
           "as_real_tensor", "phi1", "ou_variance", "psd_cholesky",
           "cholesky_or_nan", "psd_solve", "lti_sde_to_disc",
           "simulate_lgssm", "simulate_sde", "simulate_sde_init",
           "simulate_function_parametrised_sde",
           "TimingResult", "time_jitted", "wall_timer", "profile_trace"]
