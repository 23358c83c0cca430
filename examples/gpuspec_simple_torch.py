"""High-resolution spectroscopy of GUPPI RAW data through the PyTorch/CUDA
port, bifrost_tpu_torch: the north-star pipeline (reference:
testbench/gpuspec_simple.py:44-58), line for line as
examples/gpuspec_simple.py builds it with the JAX package.

  read_guppi_raw -> copy('cuda') -> FUSED[ FFT(fine_time) ->
  detect('stokes') -> reduce(freq x4) ] -> copy('system')
  -> write_sigproc

It runs on the first CUDA device (cuda:0); a caller that wants the CPU
calls bifrost_tpu_torch.device.set_device('cpu') before build().

Usage: python gpuspec_simple_torch.py <file.raw> [outdir]
       python gpuspec_simple_torch.py --demo    # synthesize a small .raw
                                                # with a tone and process it
"""

import os
import sys

try:
    import bifrost_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import bifrost_tpu_torch as bt
from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage


def build(filenames, outdir='.', gulp_nframe=1, rfactor=4):
    bc = bt.BlockChainer()
    bc.blocks.read_guppi_raw(filenames, gulp_nframe=gulp_nframe)
    return build_after(bc, outdir, rfactor)


def build_after(bc, outdir='.', rfactor=4):
    """The chain after the reader, appended to ``bc`` (a BlockChainer,
    or the block whose output ring carries the GUPPI stream, such as a
    ``bridge_source`` on the host that receives it)."""
    if not isinstance(bc, bt.BlockChainer):
        bc = bt.BlockChainer(bc)
    bc.blocks.copy(space='cuda')
    bc.blocks.fused([
        FftStage('fine_time', axis_labels='fine_freq'),
        DetectStage('stokes', axis='pol'),
        ReduceStage('fine_freq', rfactor),
    ])
    bc.blocks.copy(space='system')
    # merge (freq, fine_freq) into one spectral axis and relabel for
    # filterbank output: ['time', 'pol', 'freq']
    bc.views.merge_axes('freq', 'fine_freq', label='freq')
    bc.blocks.transpose(['time', 'pol', 'freq'])
    bc.blocks.write_sigproc(path=outdir)
    return bc


def make_demo_raw(path, nchan=4, ntime=256, npol=2, nblock=4, k=19):
    """Synthesize a GUPPI RAW file with an x-pol tone at fine bin
    ``k`` in every coarse channel (the reference testbench ships a
    generator too, testbench/generate_test_data.py)."""
    import numpy as np
    from bifrost_tpu_torch.io import guppi as guppi_io
    blocsize = nchan * ntime * npol * 2
    t = np.arange(ntime)
    tone = np.exp(2j * np.pi * k * t / ntime)
    with open(path, 'wb') as f:
        for b in range(nblock):
            raw = np.zeros((nchan, ntime, npol, 2), np.int8)
            raw[:, :, 0, 0] = np.round(60 * tone.real)
            raw[:, :, 0, 1] = np.round(60 * tone.imag)
            guppi_io.write_header(f, {
                'OBSNCHAN': nchan, 'NPOL': npol, 'NBITS': 8,
                'BLOCSIZE': blocsize, 'OBSFREQ': 1500.0, 'OBSBW': 4.0,
                'STT_IMJD': 58000, 'STT_SMJD': 0, 'PKTIDX': b,
                'PKTSIZE': 8192, 'TELESCOP': 'DEMO', 'BACKEND': 'GUPPI',
                'SRC_NAME': 'TONE'})
            f.write(raw.tobytes())


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    if argv[1] == '--demo':
        import tempfile
        outdir = argv[2] if len(argv) > 2 else tempfile.mkdtemp()
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, 'demo.raw')
        make_demo_raw(path)
        argv = [argv[0], path, outdir]
        print("demo: synthesized %s" % path)
    outdir = argv[2] if len(argv) > 2 else '.'
    build([argv[1]], outdir)
    pipeline = bt.get_default_pipeline()
    pipeline.shutdown_on_signals()
    pipeline.run()
    # write_sigproc names outputs <source basename>.fil
    out = os.path.join(outdir, os.path.basename(argv[1]) + '.fil')
    print("wrote %s" % out)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
