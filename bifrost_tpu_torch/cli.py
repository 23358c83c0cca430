"""Console entry points of the port's monitors (``bf-torch-like-top``,
``bf-torch-like-ps``, ``bf-torch-pipeline2dot`` in ``pyproject.toml``):
each runs a module of :mod:`bifrost_tpu_torch.tools`, so an installed
package has them without the repository checkout (the counterpart of
``bifrost_tpu/cli.py``)."""

from __future__ import annotations

import sys

__all__ = ['like_top_main', 'like_ps_main', 'pipeline2dot_main']


def like_top_main(argv=None):
    from .tools import like_top
    return like_top.main(sys.argv[1:] if argv is None else argv)


def like_ps_main(argv=None):
    from .tools import like_ps
    return like_ps.main(sys.argv[1:] if argv is None else argv)


def pipeline2dot_main(argv=None):
    from .tools import pipeline2dot
    return pipeline2dot.main(sys.argv[1:] if argv is None else argv)
