"""File-format readers and writers (host side, numpy only).

The port carries the SIGPROC filterbank format
(:mod:`bifrost_tpu_torch.io.sigproc`) and the GUPPI RAW block headers
(:mod:`bifrost_tpu_torch.io.guppi`); the JAX package's packet formats,
sockets, capture and bridge are not ported yet.
"""

from . import guppi, sigproc

__all__ = ['guppi', 'sigproc']
