"""What the drivers share: the ``--device`` and ``--x64`` flags, the
records (JAX's keys or the committed ``--data-dir`` files) and the
Table-I method configurations."""

import argparse
import os

import numpy as np
import torch

from chirpgp_tpu_torch.utils.jax_keys import (
    jax_rnd_keys, jax_toymodel_measurements)

# One entry per state-space column of Table I, as the JAX package's
# ``experiments/run_rmse_table.py`` configures it: the square-root form
# wherever the method has one, the continuous-discrete methods in
# covariance form, La Scala's GHFS in covariance form.
METHOD_CONFIGS = {
    "ghfs": dict(method="ghfs", form="sqrt"),
    "ekfs": dict(method="ekfs", form="sqrt"),
    # CKFS: the sigma-point filter with the spherical-cubature rule.
    "ckfs": dict(method="ghfs", quadrature="cubature", form="sqrt"),
    "cd_ghfs": dict(method="cd_ghfs"),
    "cd_ekfs": dict(method="cd_ekfs"),
    "lascala_ghfs": dict(method="ghfs", model="lascala", form="cov"),
    "lascala_ekfs": dict(method="ekfs", model="lascala", form="sqrt"),
    "harmonic_ekfs": dict(method="ekfs", model="harmonic",
                          num_harmonics=3, form="sqrt"),
    "harmonic_ckfs": dict(method="ghfs", model="harmonic",
                          num_harmonics=3, quadrature="cubature",
                          form="sqrt"),
}


def add_device_args(ap: argparse.ArgumentParser, x64: bool = True,
                    default: str = "cuda"):
    """``--device`` (default ``default``) and, with ``x64``, ``--x64``."""
    ap.add_argument("--device", default=default,
                    help=f"torch device to run on (default: {default}; "
                         f"'cpu' is the host CPU)")
    if x64:
        ap.add_argument("--x64", action="store_true",
                        help="float64 throughout (default: float32)")


def setup(args) -> torch.device:
    """The device of ``--device``, checked; ``--x64`` makes float64
    torch's default dtype, as ``jax_enable_x64`` makes it JAX's.  Raises
    when CUDA is asked for and there is no card: nothing falls back to
    the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch.cuda.is_available() is False; "
            f"pass --device cpu to run on the host CPU")
    if getattr(args, "x64", False):
        torch.set_default_dtype(torch.float64)
    return device


def torchrun_mesh(device: torch.device):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): the process group joined,
    NCCL on the card and gloo on the CPU, and the mesh of every rank;
    ``None`` in a single process."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    from chirpgp_tpu_torch.parallel import global_mesh, initialize_distributed
    initialize_distributed(backend="nccl" if device.type == "cuda"
                           else "gloo")
    return global_mesh(device=None if device.type == "cuda" else device)


def require_matplotlib(ap: argparse.ArgumentParser, what: str = "--plot"):
    """Stop at once, with a clear message, when ``what`` (``--plot``, or
    drawing a figure) asks for matplotlib and it is not installed (it is
    imported only for plots)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        ap.error(f"{what} needs matplotlib, which is not installed ({exc})")


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def toydata_prefix(num_harmonics: int) -> str:
    return "toydata" if num_harmonics == 1 else f"toydata_h{num_harmonics}"


def load_toydata(data_dir: str, mag: str, num_harmonics: int, seeds: int):
    """The first ``seeds`` records of ``{data_dir}/toydata[_hK]_{mag}.npz``
    (float32, as written): ``(true_freqs (B, T), ys (B, T))`` tensors."""
    data = np.load(os.path.join(data_dir,
                                f"{toydata_prefix(num_harmonics)}_{mag}.npz"))
    ys = torch.as_tensor(data["ys"][:seeds])
    return torch.as_tensor(data["true_freqs"]).expand(ys.shape), ys


def jax_records(seeds: int, mag: str, T: int, dt: float = 1e-3,
                Xi: float = 0.1, num_harmonics: int = 1, dtype=None):
    """The JAX package's records of its first ``seeds`` pregenerated keys
    (``generate_rnd_keys``), made on the host in ``dtype`` (torch's
    default): ``(true_freqs (B, T), ys (B, T))``."""
    keys = jax_rnd_keys(max(seeds, 1))[:seeds]
    _, tf, ys = jax_toymodel_measurements(
        keys, mag, dt=dt, T=T, Xi=Xi, num_harmonics=num_harmonics,
        dtype=dtype or torch.get_default_dtype(), device="cpu")
    return tf, ys
