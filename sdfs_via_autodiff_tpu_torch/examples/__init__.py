"""Runnable demos of the PyTorch port (``python -m
sdfs_via_autodiff_tpu_torch.examples.<name>``), one per JAX example
script.  Each ``main()`` takes its sizes as keyword arguments (the JAX
script's values by default) and ``device``; ``sharding_demo`` also runs
under ``torchrun``."""
