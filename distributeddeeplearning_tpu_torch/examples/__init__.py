"""The example scripts of the port, twins of the repo's
``examples/*_tpu.py``: run each as ``python -m
distributeddeeplearning_tpu_torch.examples.<name>``."""
