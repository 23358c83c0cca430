"""Header-only stream views (reference: python/bifrost/views/; the port
of ``bifrost_tpu/views``)."""

from .basic_views import (custom, rename_axis, reinterpret_axis,
                          reverse_scale, add_axis, delete_axis, astype,
                          split_axis, merge_axes, expose_view)

__all__ = ['custom', 'rename_axis', 'reinterpret_axis', 'reverse_scale',
           'add_axis', 'delete_axis', 'astype', 'split_axis', 'merge_axes',
           'expose_view']
