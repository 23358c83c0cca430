"""Linear-chain construction sugar (reference:
python/bifrost/block_chainer.py:41-73; the port of
``bifrost_tpu/block_chainer.py``).

    bc = bt.BlockChainer()
    bc.blocks.read_sigproc(['a.fil'], gulp_nframe=128)
    bc.blocks.copy('cuda')
    bc.views.split_axis('freq', 2)
    bc.blocks.write_sigproc()
    print(bc.last_block)
"""

from __future__ import annotations

__all__ = ['BlockChainer']


class _ChainProxy(object):
    def __init__(self, chainer, module):
        self._chainer = chainer
        self._module = module

    def __getattr__(self, name):
        func = getattr(self._module, name)

        def wrapper(*args, **kwargs):
            if self._chainer.last_block is not None:
                args = (self._chainer.last_block,) + args
            block = func(*args, **kwargs)
            self._chainer.last_block = block
            return block

        return wrapper


class BlockChainer(object):
    def __init__(self, last_block=None):
        self.last_block = last_block

    @property
    def blocks(self):
        from . import blocks as blocks_mod
        return _ChainProxy(self, blocks_mod)

    @property
    def views(self):
        from . import views as views_mod
        return _ChainProxy(self, views_mod)

    def custom(self, func):
        """Chain a user-supplied block factory."""
        def wrapper(*args, **kwargs):
            if self.last_block is not None:
                args = (self.last_block,) + args
            block = func(*args, **kwargs)
            self.last_block = block
            return block
        return wrapper
