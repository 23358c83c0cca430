"""Readings for the limits of the output check, on the card: for each
seed, one run of the cell (a short window) and, on the same sampled
outputs, the controls (the reference computed one precision below what
the configuration states).  The benchmark's own runs never run this.

  python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
      --seconds 4 [--controls tf32] [--trace 0|1]

One JSON line a seed on standard output: the result, what the check
found, and each control's numbers.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import run as _run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=4.0)
    ap.add_argument('--controls', default='tf32')
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--keep-trace', default=None,
                    help='keep each Chrome trace in this directory')
    args = ap.parse_args(argv)
    _run.set_environment()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('calibrate: no CUDA device\n')
        return 2
    from benchmark.portbench import harness
    controls = tuple(c for c in args.controls.split(',') if c)
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        result, info, ctl = harness.run_cell(
            args.workload, seed, args.seconds, bool(args.trace),
            t_process=t0, controls=controls, keep_trace=args.keep_trace)
        print(json.dumps({'seed': seed, 'result': result, 'info': info,
                          'controls': ctl,
                          'wall_s': time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
