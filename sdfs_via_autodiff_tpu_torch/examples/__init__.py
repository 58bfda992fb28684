"""Runnable demos of the PyTorch port (``python -m
sdfs_via_autodiff_tpu_torch.examples.<name>``), one per JAX example
script but ``sharding_demo.py``.  Each ``main()`` takes its sizes as
keyword arguments (the JAX script's values by default) and ``device``."""
