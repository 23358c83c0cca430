"""Debug sink that prints sequence headers (reference:
python/bifrost/blocks/print_header.py; the port of
``bifrost_tpu/blocks/print_header.py``)."""

from __future__ import annotations

from ..pipeline import SinkBlock

__all__ = ['PrintHeaderBlock', 'print_header']


class PrintHeaderBlock(SinkBlock):
    def on_sequence(self, iseq):
        print(iseq.header)

    def on_data(self, ispan):
        pass


def print_header(iring, *args, **kwargs):
    """Block: print the header of each new sequence."""
    return PrintHeaderBlock(iring, *args, **kwargs)
