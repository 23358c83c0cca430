"""Device ops of the PyTorch/CUDA port.  Modules import torch lazily and
build no kernel at import time."""
