"""The repository's demos on the PyTorch port (counterparts of
``demos/*.py``), run as ``python -m chirpgp_tpu_torch.demos.<name>``; they
keep the JAX demos' arguments and make their records from the same JAX
keys (``utils/jax_keys.py``)."""
