"""The repository's runnable experiment drivers, on the PyTorch port
(counterparts of ``experiments/*.py``).  Each is run as

    python -m chirpgp_tpu_torch.experiments.<name> [--device cpu] ...

and keeps the JAX script's arguments, defaults, output files and printed
table; every driver runs on the card unless ``--device cpu`` is given.
The records are JAX's own (``utils/jax_keys.py`` remakes them from JAX's
keys without JAX) or the committed ``results/data`` files, so a column
the port writes pairs seed by seed with the JAX package's."""
