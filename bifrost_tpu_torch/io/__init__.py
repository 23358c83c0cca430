"""File-format readers and writers (host side, numpy only).

The port carries the SIGPROC filterbank format
(:mod:`bifrost_tpu_torch.io.sigproc`); the JAX package's Guppi reader,
packet formats, sockets, capture and bridge are not ported yet.
"""

from . import sigproc

__all__ = ['sigproc']
