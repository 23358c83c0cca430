"""Distributed FFT over a sharded transform axis (the port of
``bifrost_tpu/parallel/fft.py``): the four-step decomposition of
:func:`bifrost_tpu_torch.ops.fft.dft_matmul_fft` with its transposes done
by all_to_all between the ranks of a mesh axis.

One FFT of length N = N1 * N2 runs across the D ranks of a mesh axis:

    x[n], n = N2*p + q, contiguous n chunks per rank (p sharded)
    1. all_to_all: redistribute so q is sharded, p local
    2. local DFT over p (a product with the N1-point factor matrix)
    3. twiddle exp(-2pi i r q / N), q offset from the rank's index
    4. all_to_all back: r sharded, q local
    5. local DFT over q
    6. (output_order='natural') a third all_to_all and a local transpose
       so rank d holds the contiguous k chunk; 'transposed' skips it and
       returns X[N1*s + r] with r sharded.

:func:`freq_sharded_dft` is the cross-rank channelizer: from a replicated
frame, rank d computes only its contiguous channel chunk, with no
collective at all.  The local products run without TF32, as
``dft_matmul_fft``'s do.
"""

from __future__ import annotations

import math

from .ops import P, axis_index, axis_size, all_to_all, shard_map

__all__ = ['sharded_fft', 'distributed_fft_local',
           'freq_sharded_dft', 'freq_chunk_dft_local']


def _factors(n, name):
    h = int(math.log2(n))
    if 1 << h != n:
        raise ValueError("%s requires power-of-two N" % name)
    return 1 << (h // 2)


def distributed_fft_local(xs, n1, n2, mesh, axis_name, inverse=False,
                          output_order='natural'):
    """Per-shard body over the mesh's per-rank list ``xs``: block r is
    rank r's contiguous (..., N/D) chunk of the transform axis.  Returns
    the per-rank output blocks."""
    import torch
    from ..ops.fft import _dft_tensors
    from ..ops.linalg import full_f32
    d = axis_size(mesh, axis_name)
    if n1 % d or n2 % d:
        raise ValueError("distributed fft needs D | N1 and D | N2 "
                         "(N1=%d, N2=%d, D=%d)" % (n1, n2, d))
    lead = tuple(xs[0].shape[:-1])
    nb = len(lead)
    dtn = 'c128' if xs[0].dtype == torch.complex128 else 'c64'
    acc = torch.complex128 if dtn == 'c128' else torch.complex64
    q_index = axis_index(mesh, axis_name)
    with full_f32():
        # (..., N1/D, N2): local rows p, all q
        x = [b.to(acc).reshape(lead + (n1 // d, n2)) for b in xs]
        # 1. q sharded, all p local: (..., N1, N2/D)
        x = all_to_all(mesh, x, axis_name, split_axis=nb + 1,
                       concat_axis=nb)
        y = []
        for r, b in enumerate(x):
            f1t, f2, tw = _dft_tensors(n1, n2, inverse, dtn, b.device)
            # 2. DFT over p, 3. this rank's global q columns of the
            # twiddle
            q0 = q_index[r] * (n2 // d)
            t = torch.matmul(b.transpose(-1, -2), f1t).transpose(-1, -2)
            y.append(t * tw[:, q0:q0 + n2 // d])
        # 4. r sharded, all q local: (..., N1/D, N2)
        y = all_to_all(mesh, y, axis_name, split_axis=nb,
                       concat_axis=nb + 1)
        # 5. DFT over q
        z = [torch.matmul(b, _dft_tensors(n1, n2, inverse, dtn,
                                          b.device)[1]) for b in y]
        if output_order == 'transposed':
            # X[N1*s + r], r sharded
            return [b.reshape(lead + (n1 // d * n2,)) for b in z]
        # 6. s sharded, then k = N1*s + r in contiguous chunks
        z = all_to_all(mesh, z, axis_name, split_axis=nb + 1,
                       concat_axis=nb)
    return [b.transpose(-1, -2).reshape(lead + (n1 * n2 // d,))
            for b in z]


def sharded_fft(mesh, n, axis_name='sp', inverse=False,
                output_order='natural', n1=None, nbatch=0):
    """Distributed c2c FFT: input (..., N) complex with ``nbatch``
    unsharded leading axes and the last axis sharded over ``axis_name``;
    unnormalized inverse as ``ops.fft``.  Returns a function over global
    tensors."""
    if n1 is None:
        n1 = _factors(n, 'sharded_fft')
    n2 = n // n1

    def body(xs):
        return distributed_fft_local(xs, n1, n2, mesh, axis_name,
                                     inverse=inverse,
                                     output_order=output_order)

    spec = P(*([None] * nbatch + [axis_name]))
    return shard_map(body, mesh, spec, spec)


def freq_chunk_dft_local(xs, n1, n2, mesh, axis_name, inverse=False):
    """Per-shard body of the channelizer over the per-rank list ``xs`` of
    replicated (..., N) frames: rank r computes only its contiguous
    channel chunk [d*N/D, (d+1)*N/D) (d its index along ``axis_name``),
    a column slice of the N2-point factor matrix, with no collective.
    Needs D | N2."""
    import torch
    from ..ops.fft import _dft_tensors
    from ..ops.linalg import full_f32
    ndev = axis_size(mesh, axis_name)
    if n2 % ndev:
        raise ValueError("freq-sharded dft needs D | N2 "
                         "(N2=%d, D=%d)" % (n2, ndev))
    sc = n2 // ndev
    index = axis_index(mesh, axis_name)
    out = []
    with full_f32():
        for r, x in enumerate(xs):
            dtn = 'c128' if x.dtype == torch.complex128 else 'c64'
            acc = torch.complex128 if dtn == 'c128' else torch.complex64
            f1t, f2, tw = _dft_tensors(n1, n2, inverse, dtn, x.device)
            lead = tuple(x.shape[:-1])
            xt = x.to(acc).reshape(lead + (n1, n2))   # x[n2*p + q]
            inner = torch.matmul(xt.transpose(-1, -2),
                                 f1t).transpose(-1, -2) * tw
            s0 = index[r] * sc
            chunk = torch.matmul(inner, f2[:, s0:s0 + sc])
            # k = n1*s + r: s-major flatten gives the contiguous chunk
            out.append(chunk.transpose(-1, -2).reshape(lead + (n1 * sc,)))
    return out


def freq_sharded_dft(mesh, n, axis_name='sp', inverse=False, n1=None,
                     nbatch=0):
    """Frequency-sharded channelizer: input (..., N) complex replicated
    over ``axis_name`` (``nbatch`` leading axes), output (..., N) with
    the channel axis sharded (rank d holds channels [d*N/D, (d+1)*N/D))
    and no collective.  Returns a function over global tensors."""
    if n1 is None:
        n1 = _factors(n, 'freq_sharded_dft')
    n2 = n // n1

    def body(xs):
        return freq_chunk_dft_local(xs, n1, n2, mesh, axis_name,
                                    inverse=inverse)

    return shard_map(body, mesh, P(),
                     P(*([None] * nbatch + [axis_name])))
